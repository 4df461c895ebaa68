"""Host ms a step in the program's spans `instanced_train.forward` (the
grid's build and K5r's launch) and `instanced_train.backward` (K6's
launch) over the traced sub-window."""

NAMES = ("instanced_train.forward", "instanced_train.backward")


def read(record):
    w = record.get("spans")
    found = [w["spans"][n]["total_ms"] for n in NAMES if w and n in w["spans"]]
    return sum(found) / w["units"] if found else None
