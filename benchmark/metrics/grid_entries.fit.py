"""List entries of a cell grid as the fit builds it (the program's
counters `cell_grid.entries` over `cell_grid.builds`, their changes over
the traced sub-window)."""


def read(record):
    c = (record.get("spans") or {}).get("counters", {})
    if not c.get("cell_grid.builds"):
        return None
    return c["cell_grid.entries"] / c["cell_grid.builds"]
