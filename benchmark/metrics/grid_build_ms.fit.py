"""Host ms a step in the program's span `cell_grid.build` (the step's cell
grid, with its host reads) over the traced sub-window."""


def read(record):
    w = record.get("spans")
    if not w or "cell_grid.build" not in w["spans"]:
        return None
    return w["spans"]["cell_grid.build"]["total_ms"] / w["units"]
