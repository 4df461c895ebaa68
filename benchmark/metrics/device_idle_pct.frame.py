"""The share of the traced sub-window in which the device ran no kernel
and no copy, in %."""


def read(record):
    t = record.get("trace")
    return t["idle_pct"] if t and record["unit"] == "frame" else None
