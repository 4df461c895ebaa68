"""The cell grid of candidate spheres: the spatial index of the instanced
distance search on the card (csrc/grid_scene.cuh), built in plain torch on
the tables' device at each call.

The grid covers the real spheres' AABB grown by `reach`, in cubic cells of
`cell` units, x fastest. Cell c lists, in ascending order, the Morton-sorted
rows j of `tables.spheres` whose sphere may come within `reach` of the
cell's box: the distance from its centre to the box, minus its radius, is
<= reach + BOUND_MARGIN, computed in float32. The margin makes the test
one-sided under float32 rounding, as the run balls' (instanced_pack.py):
every sphere whose surface lies within reach + BOUND_MARGIN - e of the box
is listed, e being the test's few ulps of the scene's coordinates. So at a
point p inside the cell, an unlisted sphere's distance, as the kernel
computes it, is > reach (the kernel's own rounding and its choice of p's
cell are a few ulps more; csrc/grid_scene.cuh says why that suffices).
Sentinel spheres (radius -1e30, the padding of parallel/objects.py) are
never listed, and do not widen the box.

The build is a sort-based count / fill: per sphere the range of cells its
reach can touch (widened by one more margin, so that no cell is missed to
the floor's rounding), the exact box test on every (sphere, cell) pair,
then one sort of the unique keys cell * Ns + row and a search for each
cell's first entry. No atomics: two builds are bitwise equal. It syncs with
the host a few times (the box, the pairs' count), so it is set-up work, not
a kernel: this table has no TPU kernel to port. `builds` counts the calls
of `build_cell_grid` (one a training step, one a regrouped frame).
"""

from __future__ import annotations

import bisect
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from loltracer_tpu_torch.render.instanced_pack import BOUND_MARGIN, real_sphere_bbox

# The cell size in scene units (the card's sweep of 0.5, 1 and 2 units at
# instanced:10000, PERF.md, kept the fastest).
CELL = 1.0

# The clamp that sets the reach when there is none (exact mode) or when the
# clamp is larger: the grid lists spheres out to GRID_CLAMP + the largest
# radius, and a search that ends farther falls back to the run walk.
GRID_CLAMP = 2.0

# At most this many cells: a wider scene takes larger cells (the cell size
# doubles until it fits).
MAX_CELLS = 1 << 24

# Candidate (sphere, cell) pairs per step of the build: bounds its
# temporaries (~50 bytes a pair).
CHUNK = 1 << 24

builds = 0


class CellGrid(NamedTuple):
    """The grid of one sphere table.

    origin     (x, y, z) float32 values: the low corner of cell (0, 0, 0)
    dims       (nx, ny, nz): cells per axis; (0, 0, 0) when the table holds
               no real sphere (every point is then outside the grid)
    cell       the cell's edge
    reach      a search in its point's own cell that ends at a distance
               <= reach is certified exact
    r_max      the largest real radius
    tilt       (sqrt(3) - 1) r_max, rounded up (a search outside the grid
               takes the list of the AABB's nearest point: csrc/grid_scene.cuh)
    coord      the largest magnitude of the tables' AABB coordinates
    cell_start [nx * ny * nz + 1] int32, on the tables' device: cell c's
               rows are cell_rows[cell_start[c]:cell_start[c + 1]], with
               c = (iz * ny + iy) * nx + ix
    cell_rows  [entries] int32, on the tables' device, ascending in each cell
    cell_spheres [entries, 4] f32: each entry's row of tables.spheres (the
               kernel reads a sphere from its list in one load)
    """

    origin: Tuple[float, float, float]
    dims: Tuple[int, int, int]
    cell: float
    reach: float
    r_max: float
    tilt: float
    coord: float
    cell_start: torch.Tensor
    cell_rows: torch.Tensor
    cell_spheres: torch.Tensor


def reach_for(tables, clamp) -> float:
    """The grid's reach for a search under the primary step clamp `clamp`
    (None: exact): min(clamp, GRID_CLAMP) + the largest real radius +
    BOUND_MARGIN, a float32 value. Inside the AABB a clamped search ends at
    or below the clamp, so it is always certified when clamp <= GRID_CLAMP."""
    rad = tables.spheres[:, 3].detach()
    r_max = float(torch.where(rad > -1e29, rad, 0.0).amax()) if rad.numel() else 0.0
    base = GRID_CLAMP if clamp is None else min(float(clamp), GRID_CLAMP)
    return float(np.float32(np.float32(base) + np.float32(r_max) + np.float32(BOUND_MARGIN)))


def grid_for(tables, clamp) -> CellGrid:
    """The grid of a search under the primary step clamp `clamp` (None:
    exact), at the default cell size: what K5, K5r and K7 search."""
    return build_cell_grid(tables, reach_for(tables, clamp))


def build_cell_grid(tables, reach: float, cell: float = CELL) -> CellGrid:
    """The CellGrid of `tables.spheres` ([Ns, 4] f32 x y z r, Morton-sorted;
    InstancedTables or march_kernels.EvalTables) for `reach`, on its device
    (module docstring)."""
    global builds
    builds += 1
    sph = tables.spheres.detach()
    dev, ns = sph.device, sph.shape[0]
    pos, rad = sph[:, :3], sph[:, 3]
    real = rad > -1e29
    lo, hi = real_sphere_bbox(pos, rad)
    reach32 = float(np.float32(reach))
    box = tables.bbox.detach().to(torch.float32)
    r_max = torch.where(real, rad, 0.0).amax() if ns else rad.new_zeros(())
    coord = torch.where(torch.isfinite(box), box.abs(), 0.0).amax()
    bounds = torch.cat([lo - reach32, hi + reach32, r_max[None], coord[None]]).tolist()
    r_max, coord = bounds[6], bounds[7]
    tilt = float(np.nextafter(np.float32((math.sqrt(3.0) - 1.0) * r_max), np.float32(np.inf)))
    if not all(map(math.isfinite, bounds[:6])):  # no real sphere
        return CellGrid((0.0, 0.0, 0.0), (0, 0, 0), float(cell), reach32, r_max, tilt, coord,
                        torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.zeros(0, dtype=torch.int32, device=dev), sph[:0].contiguous())
    origin, top = bounds[:3], bounds[3:6]
    cell = float(cell)
    while True:
        dims = [max(1, math.ceil((t - o) / cell)) for o, t in zip(origin, top)]
        if math.prod(dims) <= MAX_CELLS:
            break
        cell *= 2.0
    n_cells = math.prod(dims)

    o = torch.tensor(origin, dtype=torch.float32, device=dev)
    d = torch.tensor(dims, dtype=torch.int64, device=dev)
    ext = torch.where(real, rad, 0.0) + float(np.float32(reach32 + 2 * BOUND_MARGIN))
    lo_c = torch.maximum(torch.floor((pos - ext[:, None] - o) / cell).long(), d.new_zeros(3))
    hi_c = torch.minimum(torch.floor((pos + ext[:, None] - o) / cell).long(), d - 1)
    span = torch.clamp_min(hi_c - lo_c + 1, 0)
    count = torch.where(real, span.prod(dim=1), 0)
    cum = torch.cumsum(count, 0)
    thr = float(np.float32(reach32 + BOUND_MARGIN))
    keys, s0 = [], 0
    cum_host = cum.tolist()
    while s0 < ns:
        base = cum_host[s0 - 1] if s0 else 0
        s1 = max(s0 + 1, bisect.bisect_right(cum_host, base + CHUNK, lo=s0))
        total = cum_host[s1 - 1] - base
        if total:
            keys.append(_cell_keys(pos, rad, lo_c, span, count, cum, o, cell, dims, thr,
                                   s0, s1, total))
        s0 = s1
    flat = (keys[0] if len(keys) == 1 else torch.cat(keys) if keys
            else torch.zeros(0, dtype=torch.int64, device=dev))
    flat = torch.sort(flat).values  # unique keys: the order is the keys' own
    cells = torch.div(flat, ns, rounding_mode="floor")
    starts = torch.searchsorted(cells, torch.arange(n_cells + 1, device=dev))
    rows = flat - cells * ns
    # sph[rows], gathered as one 16-byte element a row: on the card the 2-D
    # row gather of 2.4 M rows took 1.4 ms (chip_smoke.py phase 12's profile)
    entries = sph.contiguous().view(torch.complex128).view(-1)[rows]
    return CellGrid(tuple(origin), tuple(dims), cell, reach32, r_max, tilt, coord,
                    starts.to(torch.int32), rows.to(torch.int32),
                    entries.view(torch.float32).view(-1, 4))


def _cell_keys(pos, rad, lo_c, span, count, cum, o, cell, dims, thr, s0, s1, total):
    """cell * Ns + row of every (sphere, cell) pair of rows [s0, s1) that
    passes the box test, pairs enumerated from each sphere's cell range."""
    dev, ns = pos.device, pos.shape[0]
    row = torch.repeat_interleave(torch.arange(s0, s1, device=dev), count[s0:s1],
                                  output_size=total)
    local = torch.arange(total, device=dev) - (cum[row] - count[row] - (cum[s0] - count[s0]))
    nx, ny = span[row, 0], span[row, 1]
    ix = lo_c[row, 0] + local % nx
    rest = torch.div(local, nx, rounding_mode="floor")
    iy = lo_c[row, 1] + rest % ny
    iz = lo_c[row, 2] + torch.div(rest, ny, rounding_mode="floor")
    blo = o + torch.stack([ix, iy, iz], dim=1).to(torch.float32) * cell
    c = pos[row]
    q = torch.clamp_min(torch.maximum(blo - c, c - (blo + cell)), 0.0)
    dist = torch.sqrt((q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]) - rad[row]
    keep = dist <= thr
    cell_id = (iz * dims[1] + iy) * dims[0] + ix
    return (cell_id * ns + row)[keep]



def grid_args(grid: CellGrid, stats: Optional[torch.Tensor] = None) -> tuple:
    """The grid's arguments of a grid entry (cuda_scene.GRID_ARGTYPES):
    origin, dims, 1 / cell, reach, r_max, tilt, coord, the two tables'
    pointers and the counts' (`stats`, int64 [3] on the grid's device, for
    the `_stats` entries; NULL for the others)."""
    return (*grid.origin, *grid.dims, 1.0 / grid.cell, grid.reach, grid.r_max, grid.tilt,
            grid.coord, grid.cell_start.data_ptr(), grid.cell_rows.data_ptr(),
            grid.cell_spheres.data_ptr(), None if stats is None else stats.data_ptr())


def check_grid(grid: CellGrid, device, stats: Optional[torch.Tensor] = None) -> None:
    """Raises unless the grid's tables (and `stats`) are what a launch on
    `device` reads."""
    n_cells, entries = math.prod(grid.dims), grid.cell_rows.numel()
    for name, t, shape, dtype in (
        ("cell_start", grid.cell_start, (n_cells + 1,), torch.int32),
        ("cell_rows", grid.cell_rows, (entries,), torch.int32),
        ("cell_spheres", grid.cell_spheres, (entries, 4), torch.float32),
        ("stats", stats, (3,), torch.int64),
    ):
        if t is None:
            continue
        if t.device != device or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"grid {name}: want contiguous {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
