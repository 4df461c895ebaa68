"""The cell grid of candidate spheres (render/cell_grid.py), built on the
CPU, against a brute force in float64: every sphere whose surface lies
within the reach of a cell's box is listed in that cell, no listed sphere
lies beyond the reach and its margin, rows ascend in each cell, sentinel
spheres are never listed, two builds are bitwise equal, and a shard's grid
covers the shard's own spheres while its tables keep the combined AABB.
The grid has no counterpart in the JAX package: the search over it is held
to the run walk in tests/test_torch_grid_host.py and on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.parallel.objects import pad_spheres_for_sharding
from loltracer_tpu_torch.render import cell_grid
from loltracer_tpu_torch.render.cell_grid import GRID_CLAMP, build_cell_grid, reach_for
from loltracer_tpu_torch.render.instanced_pack import BOUND_MARGIN, pack_instanced
from loltracer_tpu_torch.render.march_kernels import pack_eval_tables
from loltracer_tpu_torch.scenes import instanced_spheres

torch.set_num_threads(1)  # one intra-op thread per pytest worker


def _tables(n, seed=0):
    sc = instanced_spheres(n=n, seed=seed, device="cpu")
    return sc, pack_instanced(sc.structure, sc.params)


def _check_against_brute_force(grid, spheres, cells, chunk=2048):
    """For each cell index of `cells`: its list holds every real sphere
    within reach of its box and none beyond reach + margin (+ 1e-4 for the
    float32 test), by a brute force in float64, rows ascending. Returns the
    entries seen."""
    sph = spheres.numpy().astype(np.float64)
    real = sph[:, 3] > -1e29
    nx, ny, _ = grid.dims
    start, rows = grid.cell_start.numpy().astype(np.int64), grid.cell_rows.numpy()
    o = np.asarray(grid.origin, np.float64)
    cells = np.asarray(cells, np.int64)
    seen = 0
    for k in range(0, len(cells), chunk):
        c = cells[k:k + chunk]
        ijk = np.stack([c % nx, (c // nx) % ny, c // (nx * ny)], axis=1)
        lo = o + ijk * grid.cell
        hi = lo + grid.cell
        q = np.maximum(np.maximum(lo[:, None] - sph[:, :3], sph[:, :3] - hi[:, None]), 0.0)
        d = np.sqrt((q * q).sum(axis=-1)) - sph[:, 3]
        n = start[c + 1] - start[c]
        pos = np.repeat(np.arange(len(c)), n)
        entries = rows[np.repeat(start[c] - np.cumsum(n) + n, n) + np.arange(n.sum())]
        same = pos[1:] == pos[:-1]
        assert (entries[1:][same] > entries[:-1][same]).all()
        listed = np.zeros(d.shape, bool)
        listed[pos, entries] = True
        assert real[entries].all()
        assert not (real & (d <= grid.reach) & ~listed).any()
        assert (d[listed] <= grid.reach + BOUND_MARGIN + 1e-4).all()
        seen += len(entries)
    return seen


@pytest.mark.parametrize("n,seed,sample", [(64, 1, None), (300, 9, None), (10_000, 0, 3000)],
                         ids=["n64", "n300", "n10000_sampled"])
def test_grid_lists_every_sphere_within_reach(n, seed, sample):
    _, tab = _tables(n, seed)
    reach = reach_for(tab, 2.0)
    grid = build_cell_grid(tab, reach)
    n_cells = int(np.prod(grid.dims))
    assert grid.cell_start.shape == (n_cells + 1,) and grid.cell_start.dtype == torch.int32
    assert grid.cell_rows.dtype == torch.int32
    assert int(grid.cell_start[0]) == 0 and int(grid.cell_start[-1]) == grid.cell_rows.numel()
    assert torch.equal(grid.cell_spheres, tab.spheres[grid.cell_rows.long()])
    lo = tab.bbox[:3].numpy()
    np.testing.assert_array_equal(np.asarray(grid.origin, np.float32),
                                  (tab.bbox[:3] - np.float32(reach)).numpy())
    top = np.asarray(grid.origin) + np.asarray(grid.dims) * grid.cell
    assert (top >= tab.bbox[3:].numpy() + reach).all() and (np.asarray(grid.origin) < lo).all()
    cells = (np.arange(n_cells) if sample is None else
             np.random.default_rng(0).choice(n_cells, sample, replace=False))
    seen = _check_against_brute_force(grid, tab.spheres, cells)
    assert seen > 2 * n
    if sample is None:
        assert seen == grid.cell_rows.numel()


def test_reach_follows_the_primary_clamp_up_to_the_grid_clamp():
    _, tab = _tables(300, 9)
    r_max = float(tab.spheres[:, 3].max())
    assert reach_for(tab, 2.0) == pytest.approx(2.0 + r_max + BOUND_MARGIN, abs=1e-6)
    assert reach_for(tab, 1.0) == pytest.approx(1.0 + r_max + BOUND_MARGIN, abs=1e-6)
    assert reach_for(tab, None) == reach_for(tab, 8.0) == reach_for(tab, GRID_CLAMP)
    assert reach_for(tab, 2.0) == float(np.float32(reach_for(tab, 2.0)))


def test_two_builds_are_bitwise_equal_and_chunking_changes_nothing(monkeypatch):
    _, tab = _tables(300, 9)
    reach = reach_for(tab, 2.0)
    a, b = build_cell_grid(tab, reach), build_cell_grid(tab, reach)
    monkeypatch.setattr(cell_grid, "CHUNK", 997)  # many chunks, some of one sphere
    c = build_cell_grid(tab, reach)
    for g in (b, c):
        assert g.origin == a.origin and g.dims == a.dims and g.cell == a.cell
        assert torch.equal(g.cell_start, a.cell_start) and torch.equal(g.cell_rows, a.cell_rows)
        assert torch.equal(g.cell_spheres, a.cell_spheres)


def test_a_scene_too_wide_for_the_cell_takes_larger_cells(monkeypatch):
    _, tab = _tables(300, 9)
    reach = reach_for(tab, 2.0)
    monkeypatch.setattr(cell_grid, "MAX_CELLS", 4000)
    grid = build_cell_grid(tab, reach, 1.0)
    assert grid.cell in (2.0, 4.0, 8.0, 16.0) and np.prod(grid.dims) <= 4000
    assert np.prod(build_cell_grid(tab, reach, grid.cell / 2).dims) <= 4000
    _check_against_brute_force(grid, tab.spheres, range(int(np.prod(grid.dims))))


def test_sentinels_are_never_listed_and_a_shard_grid_covers_its_own_spheres():
    """The last shard of instanced:300 padded over 11 (eight sentinels of
    radius -1e30 at the origin): its tables carry the combined AABB, its
    grid the shard's own; a shard of sentinels only has no cell."""
    sc = instanced_spheres(n=300, seed=9, device="cpu")
    padded = pad_spheres_for_sharding(sc.params, 11)
    per = padded.sphere_radius.shape[0] // 11
    local = dataclasses.replace(padded, sphere_point=padded.sphere_point[10 * per:],
                                sphere_radius=padded.sphere_radius[10 * per:])
    whole = pack_eval_tables(sc.params).bbox
    tables = pack_eval_tables(local)._replace(bbox=whole)
    own = pack_eval_tables(local).bbox
    assert (own[:3] > whole[:3]).any()
    grid = build_cell_grid(tables, reach_for(tables, 2.0))
    np.testing.assert_array_equal(np.asarray(grid.origin, np.float32),
                                  (own[:3] - np.float32(reach_for(tables, 2.0))).numpy())
    sentinel_rows = np.flatnonzero(tables.spheres[:, 3].numpy() < -1e29)
    assert len(sentinel_rows) == 8
    assert not np.isin(grid.cell_rows.numpy(), sentinel_rows).any()
    _check_against_brute_force(grid, tables.spheres, range(int(np.prod(grid.dims))))

    empty = tables._replace(spheres=torch.tensor([[0.0, 0.0, 0.0, -1e30]] * 3))
    g = build_cell_grid(empty, reach_for(empty, 2.0))
    assert g.dims == (0, 0, 0) and g.cell_start.tolist() == [0] and g.cell_rows.numel() == 0
