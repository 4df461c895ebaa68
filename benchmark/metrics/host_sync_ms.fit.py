"""Host ms a step in the program's spans named `*.sync` (its reads of the
card's values on the host: the cell grid's build reads four a step) over
the traced sub-window."""


def read(record):
    w = record.get("spans")
    syncs = [s["total_ms"] for name, s in (w or {}).get("spans", {}).items()
             if name.endswith(".sync")]
    return sum(syncs) / w["units"] if syncs else None
