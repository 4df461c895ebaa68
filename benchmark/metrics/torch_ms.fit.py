"""Device ms a step of every other kernel, copy and fill (torch's: the
packing, autograd and optimiser glue, the cell grid) over the traced
sub-window."""


def read(record):
    t = record.get("trace")
    return t["torch_ms"] if t and record["unit"] == "step" else None
