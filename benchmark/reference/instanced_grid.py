"""The instanced scene's distance through a uniform grid of its own: the
reference's `render._instanced_sdf` at the cost of a cell's candidates in
place of every sphere, so that a fitting job's first steps at 1920x1080
over 10 000 spheres can be followed. Plain PyTorch in the parameters'
dtype; it imports nothing of the program.

The grid covers the spheres' box grown by the step clamp and a margin, in
cubic cells of CELL units, and is built from the detached parameters at
each step (the fit moves the spheres). Cell c lists, in ascending sphere
index, every sphere whose signed distance to the cell's box (its centre's
distance to the box, less its radius, in float64) is at most the clamp
plus MARGIN ulps of the distances it is compared with, in the parameters'
dtype; the lists are padded with a sentinel whose distance is +inf (radius
-inf). A point outside the grid has the sentinel's list alone: every
sphere is then farther than the clamp.

`sdf_id` takes, at each point, the minimum over its cell's candidates
through the same per-sphere arithmetic as `_instanced_sdf` (the first
minimum winning, as the candidates ascend), then that function's
`max(d_box, clamp)` term over every sphere and the plane. Any sphere whose
distance, as computed, is below the clamp is a candidate, and where none
is, both read the clamp term; so the distance is the brute force's,
bitwise, and so is the object id wherever the distance is below the clamp
(where no sphere is that near, the brute force names the farther nearest
sphere and this returns the candidates' nearest, or 0 for none). The
renderer reads an id only at a ray's hit or at a closest approach within
the coverage width (both far below the clamp), so images and losses are
the brute force's bitwise, and gradients differ from its only in the order
in which each sphere's row sums its rays' terms (and at a point on a
sphere's very centre, where the brute force's gradient is a NaN and this
one's zero). Only the winning sphere is differentiated: autograd through
every candidate would index the sentinel millions of times a call, and
its backward adds such repeats one after another.

`frame_loss_and_grads` is `reference/fit.py`'s with this distance, a grid
built at each call: the `step_fn` of `fit.follow` for an instanced scene.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from benchmark.reference.render import Settings, camera_basis, maximum, pixel_rays, render_rays

CELL = 1.0  # the cell's edge, in scene units
# the listing test's slack, in ulps (of the parameters' dtype) of the
# largest distance it compares: covers the rounding of a sphere's distance
# as `sdf_id` computes it and of the point's cell
MARGIN = 16


class Grid(NamedTuple):
    """origin [3] float64, dims (nx, ny, nz), table [nx * ny * nz + 1, K]
    int64 (x fastest; the last row the outside's, all sentinel), counts
    [nx * ny * nz + 1] int64 (each list's real entries)."""

    origin: torch.Tensor
    dims: tuple
    table: torch.Tensor
    counts: torch.Tensor


def build(pos: torch.Tensor, rad: torch.Tensor, clamp: float) -> Grid:
    """The grid of spheres pos [Ns, 3], rad [Ns] under the step clamp."""
    ns, dev = pos.shape[0], pos.device
    eps = torch.finfo(pos.dtype).eps
    c = pos.detach().double()
    r = rad.detach().double()
    r_max = float(r.max())
    reach = clamp + MARGIN * eps * (clamp + r_max + math.sqrt(3.0) * CELL)
    lo = (c - r[:, None]).amin(dim=0) - reach
    hi = (c + r[:, None]).amax(dim=0) + reach
    dims = [max(1, math.ceil(v)) for v in ((hi - lo) / CELL).tolist()]
    d = torch.tensor(dims, device=dev)
    # each sphere's range of cells, then every (sphere, cell) pair in it
    ext = (r + reach)[:, None]
    c_lo = torch.clamp(torch.floor((c - ext - lo) / CELL).long(), min=0)
    c_hi = torch.minimum(torch.floor((c + ext - lo) / CELL).long(), d - 1)
    n = (c_hi - c_lo + 1).clamp(min=0)
    count = n.prod(dim=1)
    sph = torch.repeat_interleave(torch.arange(ns, device=dev), count)
    local = torch.arange(sph.numel(), device=dev) - (torch.cumsum(count, 0) - count)[sph]
    nx, ny = n[sph, 0], n[sph, 1]
    ix = c_lo[sph, 0] + local % nx
    iy = c_lo[sph, 1] + (local // nx) % ny
    iz = c_lo[sph, 2] + local // (nx * ny)
    box_lo = lo + torch.stack([ix, iy, iz], dim=1).double() * CELL
    q = torch.clamp(torch.maximum(box_lo - c[sph], c[sph] - (box_lo + CELL)), min=0.0)
    keep = q.norm(dim=1) - r[sph] <= reach
    n_cells = dims[0] * dims[1] * dims[2]
    key = ((iz * dims[1] + iy) * dims[0] + ix)[keep] * ns + sph[keep]
    key = torch.sort(key).values  # by cell, then ascending sphere
    cells, rows = key // ns, key % ns
    counts = torch.bincount(cells, minlength=n_cells + 1)
    k = max(1, int(counts.max()))
    start = torch.cumsum(counts, 0) - counts
    table = torch.full((n_cells + 1, k), ns, dtype=torch.long, device=dev)
    table[cells, torch.arange(key.numel(), device=dev) - start[cells]] = rows
    return Grid(lo, tuple(dims), table, counts)


def cell_of(grid: Grid, p: torch.Tensor) -> torch.Tensor:
    """The table row of each point p [M, 3]: its cell, or the outside's."""
    q = torch.floor((p.detach().double() - grid.origin) / CELL)
    d = torch.tensor(grid.dims, device=p.device)
    inside = ((q >= 0) & (q < d)).all(dim=1)
    q = torch.where(inside[:, None], q, 0.0).long()
    idx = (q[:, 2] * grid.dims[1] + q[:, 1]) * grid.dims[0] + q[:, 0]
    return torch.where(inside, idx, grid.table.shape[0] - 1)


def _distance(p, c, r):
    """`_instanced_sdf`'s per-sphere distance, its square root's gradient
    zero at the centre itself (the brute force's is a NaN there)."""
    dx, dy, dz = p[..., 0] - c[..., 0], p[..., 1] - c[..., 1], p[..., 2] - c[..., 2]
    s2 = (dx * dx + dy * dy) + dz * dz
    return torch.where(s2 > 0, torch.sqrt(torch.where(s2 > 0, s2, 1.0)), 0.0) - r


def make_sdf(structure: dict, grid: Grid, clamp: float) -> Callable:
    """`sdf_id(P, p [..., 3]) -> (distance [...], object id [...])` through
    the grid (module docstring)."""
    ns = structure["num_spheres"]

    def sdf_id(P: Dict, p):
        pos, rad = P["sphere_point"], P["sphere_radius"]
        batch = p.shape[:-1]
        flat = p.reshape(-1, 3)
        with torch.no_grad():
            rows = cell_of(grid, flat)
            k = max(1, int(grid.counts[rows].max())) if rows.numel() else 1
            idx = grid.table[rows, :k]
            # the sentinel row: +inf at any point
            pad_pos = torch.cat([pos, pos.new_zeros((1, 3))])
            pad_rad = torch.cat([rad, rad.new_full((1,), float("-inf"))])
            bd, bi = torch.min(_distance(flat[:, None], pad_pos[idx], pad_rad[idx]), dim=-1)
            win = idx.gather(1, bi[:, None])[:, 0]
            closer = bd < float("inf")
            imin = torch.where(closer, (win + 1).to(torch.int32), 0).reshape(batch)
        dmin = torch.where(closer, bd, float("inf"))
        if torch.is_grad_enabled() and (p.requires_grad or pos.requires_grad or rad.requires_grad):
            # the winner's distance again, differentiable: bitwise bd, and
            # the gradient of the brute force's min, which reaches the
            # first argmin alone (index_select's backward adds each
            # sphere's rows by atomics, in no fixed order)
            sel = closer.nonzero()[:, 0]
            w = win[sel]
            d = _distance(flat.index_select(0, sel), pos.index_select(0, w),
                          rad.index_select(0, w))
            dmin = dmin.index_put((sel,), d)
        dmin = dmin.reshape(batch)
        lo = (pos - rad[:, None]).amin(dim=0)
        hi = (pos + rad[:, None]).amax(dim=0)
        q = maximum(torch.maximum(lo - p, p - hi), 0.0)
        s2 = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
        d_box = torch.where(s2 > 0, torch.sqrt(torch.where(s2 > 0, s2, 1.0)), 0.0)
        dmin = torch.minimum(dmin, maximum(d_box, clamp))
        if structure["num_planes"]:
            bd, bi = torch.min(p[..., 1, None] - P["plane_y"], dim=-1)
            closer = bd < dmin
            dmin = torch.where(closer, bd, dmin)
            imin = torch.where(closer, (bi + (ns + 1)).to(torch.int32), imin)
        return dmin, imin

    return sdf_id


def scene_sdf(structure: dict, P: Dict, clamp: float) -> Callable:
    """The gridded `sdf_id` of the spheres as P holds them now."""
    return make_sdf(structure, build(P["sphere_point"], P["sphere_radius"], clamp), clamp)


def frame_loss_and_grads(structure: dict, P: Dict, leaves: Sequence[str], target, s: Settings,
                         band_rows: int, rows: Optional[Sequence[int]] = None):
    """`reference/fit.py`'s frame_loss_and_grads through the gridded
    distance, a grid built now from P."""
    height, width = target.shape[0], target.shape[1]
    for f in leaves:
        P[f].grad = None
    sdf_id = scene_sdf(structure, P, s.step_clamp)
    all_rows = torch.arange(height, device=target.device) if rows is None else \
        torch.as_tensor(list(rows), device=target.device)
    total = 0.0
    n = all_rows.numel() * width * 3
    xs_row = torch.arange(width, device=target.device)
    pr = camera_basis(P, height, width, s)[6].detach() if s.antialias else None
    for b in range(0, all_rows.numel(), band_rows):
        ys = all_rows[b:b + band_rows]
        yy = ys[:, None].expand(-1, width).reshape(-1)
        xx = xs_row[None, :].expand(ys.numel(), -1).reshape(-1)
        rd = pixel_rays({k: v.detach() for k, v in P.items()}, yy, xx, height, width, s)
        img = render_rays(structure, P, P["cam_point"].detach(), rd, s, pr, sdf_id)
        err = ((img - target[ys].reshape(-1, 3).to(img.dtype)) ** 2).sum()
        (err / n).backward()
        total += float(err.detach().double())
    grads = {f: (P[f].grad if P[f].grad is not None else torch.zeros_like(P[f])).detach()
             for f in leaves}
    return total / n, grads
