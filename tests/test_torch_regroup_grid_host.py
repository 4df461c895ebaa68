"""Host side of the regrouped instanced forward over the cell grid
(csrc/regroup.cuh's `lol_rg_march`, `lol_rg_shadow` and `lol_rg_shade` on
csrc/grid_scene.cuh's `GridScene`), on a machine without CUDA: the
generated regroup source built for the host with g++ through the shim of
tests/test_torch_regroup_host.py, on instanced:300 (seed 9) with sphere 200
a copy of sphere 17 (ties everywhere, as tests/test_torch_grid_host.py
places them), at clamp 2, exact, clamp 2 with AA and shadow clamp 8:

- `rg_march_pixel` over the grid bitwise the same function over the run
  walk (`InstancedScene`);
- `rg_shadow_at` over the grid bitwise the same over the run walk, the
  records in the Morton order and in pixel order;
- `rg_shade_pixel` over the grid bitwise the same over the run walk (with
  AA a miss's material lookup too), the counting grid's bitwise the
  grid's;
- the whole per-pixel pipeline over the grid (the march, each light's
  sorted shadows, the shade half) bitwise `render_pixel` over the walk;
- the grid counting view's searches per ray equal to the plain shadow
  loop's evaluations, its other counts consistent.

The kernels themselves run only on the card (chip_smoke.py phases 22-24)."""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render import regroup
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cell_grid import grid_for
from loltracer_tpu_torch.render.cuda_scene import generate_regroup_source, pack_fields
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.render.march_kernels import pack_march_scene, shadow_values_reference
from loltracer_tpu_torch.scenes import instanced_spheres
from test_torch_regroup_host import _SHIM, _ptr

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 12, 28

CFGS = {
    "clamp2": RenderConfig(step_clamp=2.0),
    "exact": RenderConfig(),
    "clamp2_aa": RenderConfig(step_clamp=2.0, antialias=True),
    "shadow8": RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0),
}

# the search of a host launch
WALK, GRID = 0, 1

_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;
using lol_gen::SceneOnGrid;
using lol_gen::SceneOnGridStats;
#define TABLES const float* s, const int* ids, const float* g, const float* bbox, int ns, int ng
#define GRID const float* gf, const int* dims, const int* start, const int* rows, \
             const float* cells
#define SCENES                                                                           \
  const lol::InstancedTables tab{reinterpret_cast<const float4*>(s),                     \
                                 reinterpret_cast<const int2*>(ids),                     \
                                 reinterpret_cast<const float4*>(g), bbox, ns, ng};      \
  const lol::GridTables gt{gf[0], gf[1], gf[2], dims[0], dims[1], dims[2], gf[3], gf[4], \
                           gf[5], gf[6], gf[7], start, rows,                             \
                           reinterpret_cast<const float4*>(cells), nullptr};             \
  const float4* grp = reinterpret_cast<const float4*>(g);                                \
  const Scene walk(P, tab, grp);                                                         \
  const SceneOnGrid grid(P, tab, grp, gt)

// lol_rg_march's body over the walk (search 0) or the grid (1)
extern "C" void host_rg_march(int search, const float* cam, const float* P, TABLES, GRID,
                              float* track, float* hitp, float* rec, int height, int width) {
  SCENES;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      if (search)
        lol::rg_march_pixel<Cfg>(cam, grid, P, x, y, height, width, track, hitp, rec,
                                 (size_t)height * width);
      else
        lol::rg_march_pixel<Cfg>(cam, walk, P, x, y, height, width, track, hitp, rec,
                                 (size_t)height * width);
    }
}

// lol_rg_shadow's body over the walk (0) or the grid (1); with counts
// [5, n], the grid counting view instead
extern "C" void host_rg_shadow(int search, const float* P, TABLES, GRID, const float* rec,
                               const long long* perm, float* out, float* counts, int n) {
  SCENES;
  for (int i = 0; i < n; ++i) {
    if (counts) {
      const SceneOnGridStats counted(P, tab, grp, gt);
      const lol::GridCountingScene<Cfg, SceneOnGridStats> view{counted};
      lol::rg_shadow_at<Cfg>(view, rec, perm, out, i, n);
      counts[i] = (float)counted.n_search;
      counts[n + i] = (float)counted.n_fallback;
      counts[2 * n + i] = (float)counted.n_read;
      counts[3 * n + i] = view.lists_warp;
      counts[4 * n + i] = view.one_list;
    } else if (search == 1) {
      lol::rg_shadow_at<Cfg>(grid, rec, perm, out, i, n);
    } else {
      lol::rg_shadow_at<Cfg>(walk, rec, perm, out, i, n);
    }
  }
}

// lol_rg_shade's body over the walk (search 0), the grid (1) or the
// counting grid (2, its counts into counts [3])
extern "C" void host_rg_shade(int search, const float* cam, const float* P, TABLES, GRID,
                              const float* track, const float* shadow, float* img, int height,
                              int width, long long* counts) {
  SCENES;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      const size_t n = (size_t)height * width;
      if (search == 2) {
        const SceneOnGridStats counted(P, tab, grp, gt);
        lol::rg_shade_pixel<Cfg>(cam, counted, P, x, y, height, width, track, shadow, img, n);
        counts[0] += (long long)counted.n_search;
        counts[1] += (long long)counted.n_fallback;
        counts[2] += (long long)counted.n_read;
      } else if (search == 1) {
        lol::rg_shade_pixel<Cfg>(cam, grid, P, x, y, height, width, track, shadow, img, n);
      } else {
        lol::rg_shade_pixel<Cfg>(cam, walk, P, x, y, height, width, track, shadow, img, n);
      }
    }
}

// render_pixel over the run walk: K5's walk image
extern "C" void host_render(const float* cam, const float* P, TABLES, GRID, float* img,
                            int height, int width) {
  SCENES;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<Cfg, Scene>(cam, walk, P, x, y, height, width, img, nullptr,
                                    (size_t)height * width);
}
"""


@pytest.fixture(scope="module")
def tied():
    """instanced_spheres(300, seed 9) with sphere 200 a copy of sphere 17."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    scene.params.sphere_point[200] = scene.params.sphere_point[17]
    scene.params.sphere_radius[200] = scene.params.sphere_radius[17]
    return scene


@pytest.fixture(scope="module", params=list(CFGS), ids=list(CFGS))
def case(request, tied, tmp_path_factory):
    """The host build of the regroup source for this config, the scene's
    packed inputs, its cell grid (as regrouped_forward builds it) and the
    arguments every host entry takes after its own."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    cfg = CFGS[request.param]
    st = tied.structure
    text = _SHIM + generate_regroup_source(st, cfg) + _ENTRIES
    stem = "regroup_grid_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    tmp = tmp_path_factory.mktemp("regroup_grid_host")
    src, so = tmp / f"{stem}.cpp", tmp / f"{stem}.so"
    src.write_text(text)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True, capture_output=True, text=True)
    cam = camera_pack(tied.params, H, W, cfg)
    fields = pack_fields(st, tied.params)
    tables = pack_instanced(st, tied.params)
    grid = grid_for(tables, cfg.step_clamp)
    keep = [fields.numpy(), *(t.numpy() for t in tables),
            np.asarray([*grid.origin, 1.0 / grid.cell, grid.reach, grid.r_max, grid.tilt,
                        grid.coord], np.float32),
            np.asarray(grid.dims, np.int32), grid.cell_start.numpy(), grid.cell_rows.numpy(),
            grid.cell_spheres.numpy()]
    args = [_ptr(keep[0]), *[_ptr(a) for a in keep[1:5]], st.num_spheres,
            tables.groups.shape[0], *[_ptr(a) for a in keep[5:]]]
    return dict(cfg=cfg, scene=tied, lib=ctypes.CDLL(str(so)), cam=cam.numpy(), args=args,
                keep=keep, grid=grid)


def _march(case, search):
    L = case["scene"].structure.num_lights
    track = np.zeros((3, H, W), np.float32)
    hitp = np.zeros((3, H, W), np.float32)
    rec = np.zeros((L, 7, H, W), np.float32)
    case["lib"].host_rg_march(search, _ptr(case["cam"]), *case["args"], _ptr(track),
                              _ptr(hitp), _ptr(rec), H, W)
    return track, hitp, rec


def _shadow(case, search, rec_l, perm, counts=None):
    n = H * W
    rec_l = np.ascontiguousarray(rec_l.reshape(7, n))
    out = np.zeros((2, n), np.float32)
    case["lib"].host_rg_shadow(search, *case["args"], _ptr(rec_l), _ptr(perm), _ptr(out),
                               None if counts is None else _ptr(counts), n)
    return out.reshape(2, H, W)


def _shade(case, search, track, shadow, counts=None):
    img = np.zeros((H, W, 3), np.float32)
    counts = np.zeros(3, np.int64) if counts is None else counts
    case["lib"].host_rg_shade(search, _ptr(case["cam"]), *case["args"], _ptr(track),
                              _ptr(shadow), _ptr(img), H, W, _ptr(counts))
    return img


def _sorted_shadows(case, track, hitp, rec):
    """Each light's planes [L, 2, H, W], marched over the grid in the Morton
    order."""
    shadow = np.zeros((rec.shape[0], 2, H, W), np.float32)
    for li, order, perm in _orders(hitp, rec):
        if order == "sorted":
            shadow[li] = _shadow(case, GRID, rec[li], perm)
    return shadow


def _orders(hitp, rec):
    """Per light, the Morton order of its records and pixel order."""
    lo, hi = regroup.hit_box(torch.from_numpy(hitp))
    for li in range(rec.shape[0]):
        perm = regroup.shadow_order(torch.from_numpy(rec[li]), lo, hi).numpy()
        assert not np.array_equal(perm, np.arange(H * W))
        yield li, "sorted", perm
        yield li, "pixel order", np.arange(H * W, dtype=np.int64)


def test_rg_march_over_the_grid_is_the_walks(case):
    """rg_march_pixel over GridScene: t_sh, hit, material, the shading
    points and every light's records bitwise the run walk's; the tied copy
    never decides a material (first wins)."""
    grid, walk = _march(case, GRID), _march(case, WALK)
    for a, b in zip(grid, walk):
        np.testing.assert_array_equal(a, b)
    track = grid[0]
    assert track[1].sum() > 0.2 * H * W and (track[1] == 0).any()
    assert np.isfinite(grid[2]).all()


def test_rg_shadow_over_the_grid_is_the_walks(case):
    """rg_shadow_at over GridScene bitwise over the run walk, for every
    light, sorted and in pixel order; the planes are the same in both
    orders."""
    _, hitp, rec = _march(case, GRID)
    planes = {}
    for li, order, perm in _orders(hitp, rec):
        want = _shadow(case, WALK, rec[li], perm)
        np.testing.assert_array_equal(_shadow(case, GRID, rec[li], perm), want,
                                      err_msg=f"light {li} {order}")
        planes.setdefault(li, []).append(want)
    for li, (a, b) in planes.items():
        np.testing.assert_array_equal(a, b)
        assert (a[0] < 1).any()  # some record is shadowed


def test_rg_shade_over_the_grid_is_the_walks(case):
    """rg_shade_pixel over GridScene bitwise over the run walk, from the
    same frozen planes, and the counting grid's bitwise the grid's: four
    normal taps a hit pixel, under AA a material lookup a miss; at clamp 2
    without AA no search falls back, and the counts stay consistent
    (fallbacks at most the searches)."""
    track, hitp, rec = _march(case, GRID)
    shadow = _sorted_shadows(case, track, hitp, rec)
    want = _shade(case, WALK, track, shadow)
    counts = np.zeros(3, np.int64)
    np.testing.assert_array_equal(_shade(case, GRID, track, shadow), want)
    np.testing.assert_array_equal(_shade(case, 2, track, shadow, counts), want)
    search, fell, read = counts
    hits = int(track[1].sum())
    assert search >= 4 * hits and fell <= search and read > 0
    if case["cfg"].antialias:
        assert search > 4 * hits  # the misses' material lookups
    elif case["cfg"].step_clamp is not None:
        assert fell == 0


def test_grid_pipeline_is_render_pixel(case):
    """The pipeline over the grid (rg_march_pixel, each light's Morton
    order, rg_shadow_at, rg_shade_pixel) bitwise render_pixel over the
    run walk: path D's image is K5's."""
    lib = case["lib"]
    track, hitp, rec = _march(case, GRID)
    img = _shade(case, GRID, track, _sorted_shadows(case, track, hitp, rec))
    want = np.zeros((H, W, 3), np.float32)
    lib.host_render(_ptr(case["cam"]), *case["args"], _ptr(want), H, W)
    np.testing.assert_array_equal(img, want)
    assert img.max() > 0


def test_grid_counting_view_counts_the_plain_loop(case):
    """The grid counting view (lol_rg_shadow_grid_stats' body): searches
    per ray the plain shadow loop's evaluations for that ray alone, its
    planes bitwise lol_rg_shadow's; fallbacks at most the searches; on the
    host a warp is one lane, so every step is in one list."""
    st, cfg = case["scene"].structure, case["cfg"]
    _, hitp, rec = _march(case, GRID)
    n = H * W
    perm = next(_orders(hitp, rec))[2]
    counts = np.zeros((5, n), np.float32)
    got = _shadow(case, GRID, rec[0], perm, counts)
    np.testing.assert_array_equal(got, _shadow(case, GRID, rec[0], perm))
    search, fall, read, lists, one = counts
    np.testing.assert_array_equal(lists, search)
    np.testing.assert_array_equal(one, search)
    assert (fall <= search).all() and read.sum() > 0
    r = rec[0].reshape(7, n)
    ro, rd = np.ascontiguousarray(r[0:3].T), np.ascontiguousarray(r[3:6].T)
    dist = np.ascontiguousarray(r[6])
    scene = pack_march_scene(st, case["scene"].params)
    for p in range(0, n, 17):
        live = []
        shadow_values_reference(st, cfg, torch.from_numpy(ro[p:p + 1]),
                                torch.from_numpy(rd[p:p + 1]), torch.from_numpy(dist[p:p + 1]),
                                scene, live)
        i = int(np.nonzero(perm == p)[0][0])
        assert search[i] == len(live), (p, search[i], len(live))
    if cfg.shadow_step_clamp is None and cfg.step_clamp is not None:
        assert fall.sum() < 0.05 * search.sum()

