"""Host side of lol_instanced_bwd over the cell grid (csrc/instanced_bwd.cuh's
per-pixel body on csrc/grid_scene.cuh's `GridScene`) and of its scatter's
sum, on a machine without CUDA: the generated training source built for the
host with g++ through the shim of tests/test_torch_instanced_host.py.

- `pixel_bwd` over the grid bitwise `pixel_bwd` over the run walk
  (`InstancedScene`), in each pixel's accumulators (camera and small
  fields) and in every record (row and vals), at seeded pixels of
  instanced:300 with sphere 200 a copy of sphere 17 (ties everywhere),
  under clamp 2, exact and clamp 2 with AA, envelope shadows; the counting
  grid bitwise the grid, its fallbacks counted;
- `rec_add`, the scatter's per-row sum staged as rec_sum_kernel stages it,
  bitwise a numpy float32 cumsum of each row's records in increasing
  record index;
- `InstancedTrainRender` builds one grid a step and hands its forward's
  grid to the backward.

The kernels themselves run only on the card (chip_smoke.py phases 13-16)."""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render import cell_grid, instanced_train
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack
from loltracer_tpu_torch.render.cell_grid import grid_for
from loltracer_tpu_torch.render.cuda_scene import generate_instanced_source, pack_fields
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scenes import instanced_spheres
from test_torch_instanced_host import _SHIM, _ptr

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 40, 56
PIXELS = 400  # seeded pixels of the frame

CFGS = {
    "clamp2": RenderConfig(step_clamp=2.0, shadow_grad="envelope"),
    "exact": RenderConfig(shadow_grad="envelope"),
    "clamp2_aa": RenderConfig(step_clamp=2.0, antialias=True, shadow_grad="envelope"),
}

# the search of a host launch
WALK, GRID, COUNTING = 0, 1, 2

_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;
using lol_gen::SceneOnGrid;
using lol_gen::SceneOnGridStats;
constexpr int kN = lol::kCamSize + Scene::kNumFields;
constexpr int kSites = 1 + 4 + Scene::kNumLights;
#define TABLES const float* s, const int* ids, const float* g, const float* bbox, int ns, int ng
#define GRID const float* gf, const int* dims, const int* start, const int* rows, \
             const float* cells

static lol::InstancedTables tables(TABLES) {
  return {reinterpret_cast<const float4*>(s), reinterpret_cast<const int2*>(ids),
          reinterpret_cast<const float4*>(g), bbox, ns, ng};
}

static lol::GridTables grid_of(GRID) {
  return {gf[0], gf[1], gf[2], dims[0], dims[1], dims[2], gf[3], gf[4], gf[5], gf[6], gf[7],
          start, rows, reinterpret_cast<const float4*>(cells), nullptr};
}

extern "C" int host_kn() { return kN; }

// lol_instanced_fwd's pixel body over the run walk: the frame's residuals
extern "C" void host_train_fwd(const float* cam, const float* P, TABLES, float* img,
                               float* res, int height, int width) {
  const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g));
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                    (size_t)height * width);
}

// lol_instanced_bwd's pixel body at the listed pixels over the walk (search
// 0), the grid (1) or the counting grid (2, its counts into counts [3]):
// each pixel's accumulators acc [npix][kN], the records [kSites][pixels]
// as the kernel writes them
extern "C" void host_pixel_bwd(int search, const float* cam, const float* P, TABLES, GRID,
                               const float* res, const float* ct, const int* pix, int npix,
                               int height, int width, float* acc, int* rec_rows,
                               float* rec_vals, long long* counts) {
  const lol::InstancedTables tab = tables(s, ids, g, bbox, ns, ng);
  const lol::GridTables gt = grid_of(gf, dims, start, rows, cells);
  const float4* grp = reinterpret_cast<const float4*>(g);
  const size_t pixels = (size_t)height * width;
  for (int i = 0; i < npix; ++i) {
    const int x = pix[i] % width, y = pix[i] / width;
    float* a = acc + (size_t)i * kN;
    for (int j = 0; j < kN; ++j) a[j] = 0.f;
    lol::RecordSink sink{rec_rows, reinterpret_cast<float4*>(rec_vals), pixels,
                         (size_t)pix[i], 0};
    const float* r = res + pix[i];
    const float* c = ct + 3 * (size_t)pix[i];
    if (search == 0) {
      const Scene scn(P, tab, grp, &sink);
      lol::pixel_bwd<Cfg, Scene>(cam, scn, P, x, y, height, width, r, pixels, c, a);
    } else if (search == 1) {
      const SceneOnGrid scn(P, tab, grp, gt, &sink);
      lol::pixel_bwd<Cfg, SceneOnGrid>(cam, scn, P, x, y, height, width, r, pixels, c, a);
    } else {
      const SceneOnGridStats scn(P, tab, grp, gt, &sink);
      lol::pixel_bwd<Cfg, SceneOnGridStats>(cam, scn, P, x, y, height, width, r, pixels, c,
                                            a);
      counts[0] += (long long)scn.n_search;
      counts[1] += (long long)scn.n_fallback;
      counts[2] += (long long)scn.n_read;
    }
    sink.close(kSites);
  }
}

// rec_sum_kernel's arithmetic per row: the bucket's records staged 256 at
// a time (kSumBatch), each batch added by rec_add
extern "C" void host_rec_sum(const int* order, const int* start, const int* count,
                             const float* vals, int ns, float* dsph) {
  const float4* v = reinterpret_cast<const float4*>(vals);
  float4 stage[256];
  for (int r = 0; r < ns; ++r) {
    float4 sum{0.f, 0.f, 0.f, 0.f};
    const int b = start[r], e = b + count[r];
    for (int base = b; base < e; base += 256) {
      const int n = e - base < 256 ? e - base : 256;
      for (int k = 0; k < n; ++k) stage[k] = v[order[base + k]];
      lol::rec_add(sum, stage, n);
    }
    reinterpret_cast<float4*>(dsph)[r] = sum;
  }
}
"""

_LIBS = {}


def _lib(structure, cfg, tmp_path_factory):
    """The training source with the entries above, built for the host once
    per text (g++, IEEE arithmetic without contraction, as nvcc's
    --fmad=false)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    text = _SHIM + generate_instanced_source(structure, cfg, residuals=True) + _ENTRIES
    stem = "inst_bwd_grid_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    if stem not in _LIBS:
        tmp = tmp_path_factory.mktemp("inst_bwd_grid_host")
        src, so = tmp / f"{stem}.cpp", tmp / f"{stem}.so"
        src.write_text(text)
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                        "-o", str(so), str(src)], check=True, capture_output=True, text=True)
        _LIBS[stem] = ctypes.CDLL(str(so))
    return _LIBS[stem]


@pytest.fixture(scope="module")
def tied():
    """instanced_spheres(300, seed 9) with sphere 200 a copy of sphere 17."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    scene.params.sphere_point[200] = scene.params.sphere_point[17]
    scene.params.sphere_radius[200] = scene.params.sphere_radius[17]
    return scene


@pytest.mark.parametrize("name", list(CFGS))
def test_pixel_bwd_over_the_grid_is_the_walks(tied, name, tmp_path_factory):
    """pixel_bwd over GridScene (the grid as the training step builds it)
    at 400 seeded pixels of a 40x56 frame (300 of them hit): every pixel's accumulators and
    every record slot (row, and vals where a row is recorded) bitwise
    pixel_bwd over InstancedScene's run walk, and the counting grid's
    bitwise the grid's; the tied copy (sphere 200 of 17) is never recorded;
    under clamp 2 fewer than 1 % of the searches fall back."""
    cfg = CFGS[name]
    st, params = tied.structure, tied.params
    lib = _lib(st, cfg, tmp_path_factory)
    cam = camera_pack(params, H, W, cfg).numpy()
    tab = pack_instanced(st, params)
    grid = grid_for(tab, cfg.step_clamp)
    keep = [pack_fields(st, params).numpy(), *(t.numpy() for t in tab),
            np.asarray([*grid.origin, 1.0 / grid.cell, grid.reach, grid.r_max, grid.tilt,
                        grid.coord], np.float32),
            np.asarray(grid.dims, np.int32), grid.cell_start.numpy(), grid.cell_rows.numpy(),
            grid.cell_spheres.numpy()]
    args = [_ptr(keep[0]), *[_ptr(a) for a in keep[1:5]], st.num_spheres, tab.groups.shape[0],
            *[_ptr(a) for a in keep[5:]]]
    img = np.zeros((H, W, 3), np.float32)
    res = np.zeros((instanced_train.num_residuals(st), H, W), np.float32)
    lib.host_train_fwd(_ptr(cam), *args[:7], _ptr(img), _ptr(res), H, W)
    rng = np.random.default_rng(5)
    ct = rng.uniform(-1.0, 1.0, (H, W, 3)).astype(np.float32)
    hit = np.flatnonzero(res[1].reshape(-1) > 0.5)  # 3 in 4 on a sphere or a plane
    rest = np.setdiff1d(np.arange(H * W), hit)
    pix = np.sort(np.concatenate([rng.choice(hit, 3 * PIXELS // 4, replace=False),
                                  rng.choice(rest, PIXELS // 4, replace=False)]))
    pix = pix.astype(np.int32)
    kn, sites = lib.host_kn(), instanced_train.num_sites(st)
    assert kn == CAM_SIZE + keep[0].size
    out = {}
    counts = np.zeros(3, np.int64)
    for search in (WALK, GRID, COUNTING):
        acc = np.zeros((PIXELS, kn), np.float32)
        rows = np.full((sites, H * W), -7, np.int32)
        vals = np.zeros((sites, H * W, 4), np.float32)
        lib.host_pixel_bwd(search, _ptr(cam), *args, _ptr(res), _ptr(ct), _ptr(pix), PIXELS,
                           H, W, _ptr(acc), _ptr(rows), _ptr(vals), _ptr(counts))
        out[search] = (acc, rows[:, pix], vals[:, pix])
    for search in (GRID, COUNTING):
        for a, b in zip(out[search], out[WALK]):
            np.testing.assert_array_equal(a, b)
    acc, rows, vals = out[WALK]
    assert (rows >= -1).all() and (rows >= 0).sum() > 100
    assert np.abs(acc).max() > 0 and np.abs(vals[rows >= 0]).max() > 0
    ids = tab.ids.numpy()[:, 0]
    assert (ids[rows[rows >= 0]] != 200).all()
    search, fell, read = counts
    assert search >= 4 * PIXELS and fell <= search and read > 0
    if cfg.step_clamp is not None and not cfg.antialias:
        assert fell < 0.01 * search


def test_rec_add_is_the_cumsum_in_record_order(tmp_path_factory):
    """The scatter's per-row sum (rec_add over rec_sum_kernel's batches of
    256) of seeded records bucketed per row in increasing record index,
    bitwise numpy's float32 cumsum of each row's records in that order
    (np.add.accumulate adds one by one); rows of 0, 1, 255, 256, 257 and
    thousands of records; values spread over six decades, so numpy's
    pairwise sum differs."""
    st = instanced_spheres(n=3, device="cpu").structure
    lib = _lib(st, CFGS["clamp2"], tmp_path_factory)
    rng = np.random.default_rng(11)
    sizes = np.array([0, 1, 255, 256, 257, 511, 512, 513, 4000, 9000, 37], np.int64)
    ns, n = len(sizes), int(sizes.sum())
    rec_rows = rng.permutation(np.repeat(np.arange(ns), sizes)).astype(np.int32)
    vals = (rng.normal(0.0, 1.0, (n, 4)) * 10.0 ** rng.uniform(-3, 3, (n, 4))).astype(np.float32)
    order = np.argsort(rec_rows, kind="stable").astype(np.int32)  # each bucket ascending
    count = np.bincount(rec_rows, minlength=ns).astype(np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    dsph = np.zeros((ns, 4), np.float32)
    lib.host_rec_sum(_ptr(order), _ptr(start), _ptr(count), _ptr(vals), ns, _ptr(dsph))
    want = np.zeros((ns, 4), np.float32)
    pairwise = np.zeros((ns, 4), np.float32)
    for r in range(ns):
        v = vals[order[start[r]:start[r] + count[r]]]
        if len(v):
            want[r] = np.cumsum(v, axis=0, dtype=np.float32)[-1]
            pairwise[r] = np.ascontiguousarray(v.T).sum(axis=1, dtype=np.float32)
    np.testing.assert_array_equal(dsph, want)
    assert (pairwise != want).any()  # the order is what the test holds


def test_training_render_passes_its_grid_to_the_backward(monkeypatch):
    """InstancedTrainRender on CPU tensors: one cell grid built per step
    (cell_grid.builds), and the backward hands instanced_train_backward
    the very grid its forward searched."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    cfg = CFGS["clamp2"]
    seen = {}
    real_fwd, real_bwd = (instanced_train.instanced_train_forward,
                          instanced_train.instanced_train_backward)

    def fwd(*a, grid=None, **k):
        seen["fwd"] = grid
        return real_fwd(*a, grid=grid, **k)

    def bwd(*a, grid=None, **k):
        seen["bwd"] = grid
        return real_bwd(*a, grid=grid, **k)

    monkeypatch.setattr(instanced_train, "instanced_train_forward", fwd)
    monkeypatch.setattr(instanced_train, "instanced_train_backward", bwd)
    render = instanced_train.make_instanced_training_renderer(scene.structure, 12, 16, cfg,
                                                              device="cpu")
    leaves = scene.params.__class__(**{
        f: v.clone().requires_grad_(f == "sphere_point") for f, v in vars(scene.params).items()})
    before = cell_grid.builds
    ((render(leaves) - 0.5) ** 2).mean().backward()
    assert cell_grid.builds == before + 1
    assert isinstance(seen["fwd"], cell_grid.CellGrid) and seen["bwd"] is seen["fwd"]
    assert leaves.sphere_point.grad is not None and leaves.sphere_point.grad.abs().max() > 0
