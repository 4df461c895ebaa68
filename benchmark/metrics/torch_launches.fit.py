"""Launches a step of every kernel, copy and fill that is not the
program's own, over the traced sub-window."""


def read(record):
    t = record.get("trace")
    return t["torch_launches"] if t and record["unit"] == "step" else None
