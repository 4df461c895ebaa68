"""Device ms a step of the program's own kernels (those inside the lol::
namespace) over the traced sub-window."""


def read(record):
    t = record.get("trace")
    return t["port_ms"] if t and record["unit"] == "step" else None
