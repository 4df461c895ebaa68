"""Host side of the cell-grid search (csrc/grid_scene.cuh `GridScene`, the
search of lol_instanced_render, lol_instanced_fwd and lol_instanced_eval),
on a machine without CUDA: the generated sources compiled for the host
with g++ through the shim of tests/test_torch_instanced_host.py, GridScene
held bitwise to InstancedScene (the run walk) and to the brute-force min
and first-wins argmin at seeded points inside the grid, on cell faces,
outside the AABB and far away (the fallback), on the tied structure, under
clamp 2, exact, and a shadow clamp of 8 above the grid's reach; its
`dist_bwd` bitwise InstancedScene's and, as that test holds it, torch
autograd's; and K7's source over a shard with sentinel spheres under the
combined AABB. The kernels themselves run only on the card
(chip_smoke.py)."""

import ctypes
import dataclasses
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.parallel.objects import pad_spheres_for_sharding
from loltracer_tpu_torch.render import instanced_train
from loltracer_tpu_torch.render.cell_grid import build_cell_grid, reach_for
from loltracer_tpu_torch.render.cuda_scene import (
    generate_eval_source,
    generate_instanced_source,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.instanced_pack import pack_instanced, soa_spheres
from loltracer_tpu_torch.render.march_kernels import pack_eval_tables
from loltracer_tpu_torch.scenes import instanced_spheres
from test_torch_instanced_host import _SHIM, _brute_force, _points, _ptr, _scatter

torch.set_num_threads(1)  # one intra-op thread per pytest worker

CLAMPED = RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0)
CLAMP2 = RenderConfig(step_clamp=2.0)
EXACT = RenderConfig()
ENV = RenderConfig(step_clamp=2.0, shadow_grad="envelope")

_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;
using Grid = lol_gen::SceneOnGridStats;  // counts its searches on the host too

static lol::InstancedTables tables(const float* s, const int* ids, const float* g,
                                   const float* bbox, int ns, int ng) {
  return {reinterpret_cast<const float4*>(s), reinterpret_cast<const int2*>(ids),
          reinterpret_cast<const float4*>(g), bbox, ns, ng};
}

// gf: origin, 1 / cell, reach, r_max, tilt, coord
static lol::GridTables grid_of(const float* gf, const int* dims, const int* start,
                               const int* rows, const float* cells) {
  return {gf[0], gf[1], gf[2], dims[0], dims[1], dims[2], gf[3], gf[4], gf[5], gf[6], gf[7],
          start, rows, reinterpret_cast<const float4*>(cells), nullptr};
}

// per point, for the grid search then the run walk: dist, shadow_dist,
// sdf_mat's material and distance (rows of 8), and whether the grid's
// dist fell back
extern "C" void host_grid_eval(const float* P, const float* s, const int* ids, const float* g,
                               const float* bbox, int ns, int ng, const float* gf,
                               const int* dims, const int* start, const int* rows,
                               const float* cells, const float* pts, int n, float* out,
                               int* fell) {
  const lol::InstancedTables tab = tables(s, ids, g, bbox, ns, ng);
  const Scene walk(P, tab, reinterpret_cast<const float4*>(g));
  for (int i = 0; i < n; ++i) {
    const Grid grid(P, tab, reinterpret_cast<const float4*>(g),
                    grid_of(gf, dims, start, rows, cells));
    const float* p = pts + 3 * i;
    float* r = out + 8 * i;
    float dm;
    r[0] = grid.dist(p[0], p[1], p[2]);
    fell[i] = (int)grid.n_fallback;
    r[1] = grid.shadow_dist(p[0], p[1], p[2]);
    r[2] = (float)grid.sdf_mat(p[0], p[1], p[2], dm);
    r[3] = dm;
    r[4] = walk.dist(p[0], p[1], p[2]);
    r[5] = walk.shadow_dist(p[0], p[1], p[2]);
    r[6] = (float)walk.sdf_mat(p[0], p[1], p[2], dm);
    r[7] = dm;
  }
}
"""

_TRAIN_ENTRIES = r"""
// per point, dist_bwd<true> through the grid (grid = 1) or the walk
// (grid = 0): its value and point gradient (rows of 4), its plane gradient
// into gP, its record in slot (0, i) of a sink of stride n
extern "C" void host_dist_bwd(const float* P, const float* s, const int* ids, const float* g,
                              const float* bbox, int ns, int ng, const float* gf,
                              const int* dims, const int* start, const int* rows,
                              const float* cells, int use_grid, const float* pts,
                              const float* gd, int n, float* out, float* gP, int* rec_rows,
                              float* vals) {
  const lol::InstancedTables tab = tables(s, ids, g, bbox, ns, ng);
  for (int i = 0; i < n; ++i) {
    lol::RecordSink sink{rec_rows, reinterpret_cast<float4*>(vals), (size_t)n, (size_t)i, 0};
    Grid grid(P, tab, reinterpret_cast<const float4*>(g), grid_of(gf, dims, start, rows, cells));
    grid.sink = &sink;
    const Scene walk(P, tab, reinterpret_cast<const float4*>(g), &sink);
    const float* p = pts + 3 * i;
    float gx, gy, gz;
    out[4 * i] = use_grid
        ? grid.template dist_bwd<true>(p[0], p[1], p[2], gd[i], gx, gy, gz, gP)
        : walk.template dist_bwd<true>(p[0], p[1], p[2], gd[i], gx, gy, gz, gP);
    out[4 * i + 1] = gx; out[4 * i + 2] = gy; out[4 * i + 3] = gz;
  }
}
"""

_EVAL_ENTRIES = r"""
// K7's distance at each point through the grid and through the walk
extern "C" void host_eval(const float* plane_y, const float* s, const float* g,
                          const float* bbox, int ns, int ng, const float* gf, const int* dims,
                          const int* start, const int* rows, const float* cells, const float* p,
                          int n, float* got, float* walked, int* fell) {
  const lol::InstancedTables tab{reinterpret_cast<const float4*>(s), nullptr,
                                 reinterpret_cast<const float4*>(g), bbox, ns, ng};
  const lol::GridTables grid{gf[0], gf[1], gf[2], dims[0], dims[1], dims[2], gf[3], gf[4],
                             gf[5], gf[6], gf[7], start, rows,
                             reinterpret_cast<const float4*>(cells), nullptr};
  const lol_gen::Scene walk(plane_y, tab, reinterpret_cast<const float4*>(g));
  for (size_t i = 0; i < (size_t)n; ++i) {
    const lol_gen::SceneOnGridStats on_grid(plane_y, tab, reinterpret_cast<const float4*>(g),
                                            grid);
    lol::eval_at(on_grid, p, got, i);
    fell[i] = (int)on_grid.n_fallback;
    lol::eval_at(walk, p, walked, i);
  }
}
"""

_LIBS = {}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """lib(kind, structure, cfg): the generated source of `kind`
    ("render", "train" or "eval") built for the host once per text (g++,
    IEEE arithmetic without contraction, as nvcc's --fmad=false)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    tmp = tmp_path_factory.mktemp("grid_host")

    def lib(kind, structure, cfg):
        if kind == "eval":
            text = _SHIM + generate_eval_source(structure, cfg) + _EVAL_ENTRIES
        else:
            train = kind == "train"
            text = (_SHIM + generate_instanced_source(structure, cfg, residuals=train)
                    + _ENTRIES + (_TRAIN_ENTRIES if train else ""))
        stem = "grid_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
        if stem not in _LIBS:
            src, so = tmp / f"{stem}.cpp", tmp / f"{stem}.so"
            src.write_text(text)
            subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                            "-fPIC", "-o", str(so), str(src)],
                           check=True, capture_output=True, text=True)
            _LIBS[stem] = ctypes.CDLL(str(so))
        return _LIBS[stem]

    return lib


@pytest.fixture(scope="module")
def tied():
    """instanced_spheres(300, seed 9) with sphere 200 a copy of sphere 17:
    equal distances everywhere, so the first-wins rule decides."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    scene.params.sphere_point[200] = scene.params.sphere_point[17]
    scene.params.sphere_radius[200] = scene.params.sphere_radius[17]
    return scene


def _grid_args(grid):
    """The grid's host arrays (kept alive by the caller) and arguments."""
    arrays = [np.asarray([*grid.origin, 1.0 / grid.cell, grid.reach, grid.r_max, grid.tilt,
                          grid.coord], np.float32),
              np.asarray(grid.dims, np.int32), grid.cell_start.numpy(), grid.cell_rows.numpy(),
              grid.cell_spheres.numpy()]
    return arrays, [_ptr(a) for a in arrays]


def _inside(grid, pts):
    f = (pts - np.asarray(grid.origin, np.float32)) * np.float32(1.0 / grid.cell)
    return ((f >= 0) & (f < np.asarray(grid.dims, np.float32))).all(axis=1)


def _face_points(grid, n, seed):
    """Points on cell faces (one coordinate on a cell boundary) and cell
    edges, inside the grid."""
    rng = np.random.default_rng(seed)
    o, dims = np.asarray(grid.origin, np.float64), np.asarray(grid.dims)
    pts = o + rng.uniform(0, 1, (n, 3)) * dims * grid.cell
    for axis in range(3):
        k = rng.integers(0, dims[axis], n)
        on = rng.random(n) < 0.5
        pts[on, axis] = o[axis] + k[on] * grid.cell
    return pts.astype(np.float32)


def _outside_points(bbox, n, seed):
    """Points 3 to 60 units outside the AABB `bbox` [6]: beyond the grid
    (whose reach is under 3) in every direction, some over its faces, some
    over its edges and corners."""
    rng = np.random.default_rng(seed)
    lo, hi = bbox[:3].astype(np.float64), bbox[3:].astype(np.float64)
    q = rng.uniform(lo, hi, (n, 3))
    out = rng.normal(0.0, 1.0, (n, 3))
    side = np.where(out > 0, hi, lo)
    keep = rng.random((n, 3)) < 0.5  # axes left inside the slab
    keep[np.arange(n), rng.integers(0, 3, n)] = False
    q = np.where(keep, q, side)
    out = np.where(keep, 0.0, np.abs(out) * np.sign(out))
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    return (q + out * rng.uniform(3.0, 60.0, (n, 1))).astype(np.float32)


def _eval(host_lib, scene, cfg, cell, pts):
    st, params = scene.structure, scene.params
    tab = pack_instanced(st, params)
    grid = build_cell_grid(tab, reach_for(tab, cfg.step_clamp), cell)
    keep = [pack_fields(st, params).numpy()] + [t.numpy() for t in tab]
    garr, gargs = _grid_args(grid)
    out = np.zeros((len(pts), 8), np.float32)
    fell = np.zeros(len(pts), np.int32)
    host_lib("render", st, cfg).host_grid_eval(
        *[_ptr(a) for a in keep], st.num_spheres, tab.groups.shape[0], *gargs, _ptr(pts),
        len(pts), _ptr(out), _ptr(fell))
    return out, fell.astype(bool), grid


@pytest.mark.parametrize("cfg", [CLAMPED, CLAMP2, EXACT], ids=["shadow8", "clamp2", "exact"])
@pytest.mark.parametrize("n", [1, 64, 300], ids=["single", "n64", "n300_tied"])
def test_grid_scene_is_the_run_walk_and_the_brute_force(host_lib, tied, n, cfg):
    """GridScene's dist, shadow_dist and sdf_mat (material and distance)
    bitwise InstancedScene's and the brute force's (min; unclamped
    first-wins argmin's material, ties to the smaller SoA index) at the
    seeded points of the instanced host test, on cell faces and outside
    the grid; under clamp 2 a search within 100 units of the spheres' AABB
    never falls back (beyond reach of it, it takes the list of the AABB's
    nearest point)."""
    scene = tied if n == 300 else instanced_spheres(n=n, seed=7, device="cpu")
    cell = 0.5 if n == 64 else 1.0
    tab = pack_instanced(scene.structure, scene.params)
    grid = build_cell_grid(tab, reach_for(tab, cfg.step_clamp), cell)
    pts = np.concatenate([_points(scene), _face_points(grid, 400, n),
                          _outside_points(tab.bbox.numpy(), 300, n)])
    out, fell, grid = _eval(host_lib, scene, cfg, cell, pts)
    np.testing.assert_array_equal(out[:, :4], out[:, 4:])
    want_d, want_mat = _brute_force(scene, pts, cfg.step_clamp)
    want_sd, _ = _brute_force(scene, pts, cfg.effective_shadow_clamp())
    np.testing.assert_array_equal(out[:, 0], want_d)
    np.testing.assert_array_equal(out[:, 1], want_sd)
    np.testing.assert_array_equal(out[:, 2], want_mat)
    inside = _inside(grid, pts)
    assert inside.sum() > 500 and (~inside).sum() > 100
    bbox = tab.bbox.numpy()
    in_box = ((pts >= bbox[:3]) & (pts <= bbox[3:])).all(axis=1)
    assert in_box.sum() > 300 and inside[in_box].all()
    d_box = np.linalg.norm(np.maximum(np.maximum(bbox[:3] - pts, pts - bbox[3:]), 0), axis=1)
    assert (~inside & (d_box < 100)).sum() > 250
    if cfg.step_clamp is not None:
        assert not fell[d_box < 100].any()
    else:  # exact: certified where a listed sphere lies within the reach
        assert (~fell[in_box]).sum() > 50
    if n == 300:
        assert (out[:, 2] == scene.structure.material_ids[18]).sum() > 50


@pytest.mark.parametrize("cfg", [ENV, RenderConfig(shadow_grad="envelope")],
                         ids=["clamp2", "exact"])
def test_grid_dist_bwd_is_the_run_walks_and_autograd(host_lib, tied, cfg):
    """GridScene::dist_bwd<true> at the seeded points: its value, point
    gradient, plane gradient and record bitwise InstancedScene's, and
    within the instanced host test's tolerance of torch autograd of the
    plain training SDF (instanced_train.make_train_sdf); the tied copy
    (sphere 200 of 17) never takes a gradient."""
    st, params = tied.structure, tied.params
    tab = pack_instanced(st, params)
    grid = build_cell_grid(tab, reach_for(tab, cfg.step_clamp))
    pts = np.concatenate([_points(tied), _face_points(grid, 300, 3),
                          _outside_points(tab.bbox.numpy(), 200, 3)])
    n = len(pts)
    gd = np.random.default_rng(1).uniform(-1.0, 1.0, n).astype(np.float32)
    keep = [pack_fields(st, params).numpy()] + [t.numpy() for t in tab]
    garr, gargs = _grid_args(grid)
    lib = host_lib("train", st, cfg)
    got = []
    for use_grid in (1, 0):
        out = np.zeros((n, 4), np.float32)
        g_fields = np.zeros(packed_size(st), np.float32)
        rows = np.full(n, -7, np.int32)
        vals = np.zeros((n, 4), np.float32)
        lib.host_dist_bwd(*[_ptr(a) for a in keep], st.num_spheres, tab.groups.shape[0], *gargs,
                          use_grid, _ptr(pts), _ptr(gd), n, _ptr(out), _ptr(g_fields),
                          _ptr(rows), _ptr(vals))
        got.append((out, g_fields, rows, vals))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    out, g_fields, rows, vals = got[0]

    fields = pack_fields(st, params).requires_grad_(True)
    spheres = tab.spheres.clone().requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    pos, rad = soa_spheres(st, tab._replace(spheres=spheres))
    tp = dataclasses.replace(params, sphere_point=pos, sphere_radius=rad,
                             plane_y=unpack_fields(st, fields)["plane_y"])
    d = instanced_train.make_train_sdf(st, cfg.step_clamp)(tp, p)
    gp, gf, gs = torch.autograd.grad((d * torch.from_numpy(gd)).sum(), (p, fields, spheres))
    np.testing.assert_allclose(out[:, 0], d.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[:, 1:], gp.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_fields, gf.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_scatter(rows, vals, st.num_spheres), gs.numpy(), atol=1e-5,
                               rtol=0)
    ids = tab.ids.numpy()[:, 0]
    assert (rows >= 0).sum() > 100 and (ids[rows[rows >= 0]] != 200).all()


@pytest.mark.parametrize("clamp", [2.0, None], ids=["clamp2", "exact"])
def test_grid_eval_over_a_shard_is_the_run_walk(host_lib, clamp):
    """K7's source: GridScene::dist bitwise InstancedScene::dist over the
    last shard of instanced:300 (seed 9) padded over 11 (eight sentinel
    spheres) under the AABB of all real spheres, its grid over the shard's
    own spheres, at points across and around the scene."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    padded = pad_spheres_for_sharding(scene.params, 11)
    per = padded.sphere_radius.shape[0] // 11
    local = dataclasses.replace(padded, sphere_point=padded.sphere_point[10 * per:],
                                sphere_radius=padded.sphere_radius[10 * per:])
    structure = dataclasses.replace(scene.structure, num_spheres=per, material_ids=())
    tables = pack_eval_tables(local)._replace(bbox=pack_eval_tables(scene.params).bbox)
    grid = build_cell_grid(tables, reach_for(tables, clamp))
    rng = np.random.default_rng(5)
    pos = local.sphere_point.numpy()[local.sphere_radius.numpy() > 0]
    pts = np.concatenate([
        pos[rng.integers(0, len(pos), 300)] + rng.normal(0, 1.0, (300, 3)),
        np.stack([rng.uniform(-50, 50, 300), rng.uniform(-2, 40, 300),
                  rng.uniform(-90, 10, 300)], axis=-1),
        _face_points(grid, 200, 6),
        _outside_points(tables.bbox.numpy(), 200, 6),
    ]).astype(np.float32)
    arrs = [t.numpy() for t in tables]
    garr, gargs = _grid_args(grid)
    got = np.zeros(len(pts), np.float32)
    walked = np.zeros(len(pts), np.float32)
    fell = np.zeros(len(pts), np.int32)
    host_lib("eval", structure, RenderConfig(step_clamp=clamp)).host_eval(
        _ptr(scene.params.plane_y.numpy()), *[_ptr(a) for a in arrs], arrs[0].shape[0],
        arrs[1].shape[0], *gargs, _ptr(pts), len(pts), _ptr(got), _ptr(walked), _ptr(fell))
    np.testing.assert_array_equal(got, walked)
    inside = _inside(grid, pts)
    assert inside.sum() > 300 and (~inside).sum() > 100
    if clamp is not None:
        assert not fell[inside].all() and fell[~inside].any() and not fell[~inside].all()
