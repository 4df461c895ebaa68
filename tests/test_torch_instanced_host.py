"""Host side of the port's instanced kernels (`lol_instanced_render`, and
for training `lol_instanced_fwd` / `lol_instanced_bwd`), on a machine
without CUDA:

- the generated sources: deterministic, and one text for every sphere count
  and seed (no scene number, no sphere count, no material table in it);
- the instanced `Scene` of csrc/instanced_scene.cuh and `render_pixel` over
  it, compiled for the host with g++ through a small shim, against a
  brute-force min and first-wins argmin over every sphere: this is where
  the exactness of the bound-guided search is checked without a card;
- its adjoint `InstancedScene::dist_bwd` and the record sink against torch
  autograd of the plain training SDF (winner normal, cut, plane, ties), and
  `render_pixel` with residuals and `pixel_bwd` over it, the records summed
  per row in record order, against the plain versions;
- the wrappers' device rules and the CLI on `instanced:N`.

The kernels themselves run only on the card (chip_smoke.py)."""

import ctypes
import dataclasses
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch import cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render import instanced_fwd, instanced_train
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer, make_instanced_renderer
from loltracer_tpu_torch.render.cuda_scene import (
    CSRC,
    generate_instanced_source,
    generate_source,
    pack_fields,
)
from loltracer_tpu_torch.render.camera import CAM_SIZE
from loltracer_tpu_torch.render.cuda_scene import packed_size, unpack_fields
from loltracer_tpu_torch.render.instanced_pack import pack_instanced, soa_spheres
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils.image import image_to_u8, read_png

torch.set_num_threads(1)  # one intra-op thread per pytest worker

CLAMPED = RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0)
EXACT = RenderConfig()


@pytest.fixture(scope="module")
def tied():
    """instanced_spheres(300, seed 9) with sphere 200 a copy of sphere 17
    (materials 3 and 6): equal distances everywhere, so the first-wins
    rule decides their material."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    scene.params.sphere_point[200] = scene.params.sphere_point[17]
    scene.params.sphere_radius[200] = scene.params.sphere_radius[17]
    return scene


# --- the generated source ------------------------------------------------------


def test_instanced_source_is_one_text_for_every_count_and_seed():
    cfg = RenderConfig(step_clamp=2.0)
    a, b = instanced_spheres(n=300, device="cpu"), instanced_spheres(n=10_000, seed=3, device="cpu")
    src = generate_instanced_source(a.structure, cfg)
    assert src == generate_instanced_source(a.structure, cfg)
    assert src == generate_instanced_source(b.structure, cfg)
    generated = src.split("namespace lol_gen {", 1)[1]
    for text in ("300", "10000", "299", "9999"):
        assert text not in generated
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    assert "lol_instanced_render" in entries and "lol_render_fused" not in entries
    assert src != generate_instanced_source(a.structure, EXACT)
    assert src != generate_instanced_source(a.structure, cfg.replace(shadow_step_clamp=8.0))
    train = generate_instanced_source(a.structure, cfg, residuals=True)
    assert train == generate_instanced_source(b.structure, cfg, residuals=True)
    for text in ("300", "10000", "299", "9999"):
        assert text not in train.split("namespace lol_gen {", 1)[1]
    entries = train.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_instanced_fwd", "lol_instanced_bwd", "lol_instanced_bwd_walk",
                 "lol_instanced_bwd_stats", "lol_instanced_bwd_blocks",
                 "lol_instanced_rec_hist_rows"):
        assert f"int {name}(" in entries
    assert "launch_instanced_bwd<lol_gen::Cfg, lol_gen::SceneOnGrid>" in entries
    assert "launch_instanced_bwd<lol_gen::Cfg, lol_gen::Scene>" in entries
    assert "lol_instanced_render" not in entries
    assert "with_residuals = true;" in train and "with_residuals = false;" in src
    assert (CSRC / "instanced_bwd.cuh").read_text() in train
    assert (CSRC / "instanced_bwd.cuh").read_text() not in src


def test_instanced_structures_are_checked():
    st = instanced_spheres(n=3, device="cpu").structure
    with pytest.raises(NotImplementedError):
        generate_source(st, EXACT)
    with pytest.raises(ValueError, match="boxes"):
        generate_instanced_source(dataclasses.replace(st, num_boxes=1), EXACT)
    with pytest.raises(ValueError, match="spheres and planes"):
        make_instanced_renderer(dataclasses.replace(st, num_unions=1), 4, 4, device="cpu")


# --- the device code, compiled for the host --------------------------------------

_SHIM = r"""
#include <cstddef>
#define __device__
#define __host__
#define __forceinline__ inline
#define __ldg(p) (*(p))
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
"""

_HOST_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;

static lol::InstancedTables tables(const float* s, const int* ids, const float* g,
                                   const float* bbox, int ns, int ng) {
  return {reinterpret_cast<const float4*>(s), reinterpret_cast<const int2*>(ids),
          reinterpret_cast<const float4*>(g), bbox, ns, ng};
}

// per point: dist, shadow_dist, sdf_mat's material and distance
extern "C" void host_eval(const float* P, const float* s, const int* ids, const float* g,
                          const float* bbox, int ns, int ng, const float* pts, int n,
                          float* out) {
  const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g));
  for (int i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    float dm;
    out[4 * i] = scn.dist(p[0], p[1], p[2]);
    out[4 * i + 1] = scn.shadow_dist(p[0], p[1], p[2]);
    out[4 * i + 2] = (float)scn.sdf_mat(p[0], p[1], p[2], dm);
    out[4 * i + 3] = dm;
  }
}

extern "C" void host_render(const float* cam, const float* P, const float* s, const int* ids,
                            const float* g, const float* bbox, int ns, int ng, float* img,
                            int height, int width) {
  const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g));
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, nullptr, 0);
}
"""


_HOST_TRAIN_ENTRIES = r"""
constexpr int kN = lol::kCamSize + Scene::kNumFields;
constexpr int kSites = 1 + 4 + Scene::kNumLights;

// per point: dist_bwd<true>'s value and point gradient (rows of 4); its
// plane gradient into gP; its record in slot (0, i) of a sink of stride n
extern "C" void host_dist_bwd(const float* P, const float* s, const int* ids, const float* g,
                              const float* bbox, int ns, int ng, const float* pts,
                              const float* gd, int n, float* out, float* gP, int* rows,
                              float* vals) {
  for (int i = 0; i < n; ++i) {
    lol::RecordSink sink{rows, reinterpret_cast<float4*>(vals), (size_t)n, (size_t)i, 0};
    const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g),
                    &sink);
    const float* p = pts + 3 * i;
    float gx, gy, gz;
    out[4 * i] = scn.template dist_bwd<true>(p[0], p[1], p[2], gd[i], gx, gy, gz, gP);
    out[4 * i + 1] = gx; out[4 * i + 2] = gy; out[4 * i + 3] = gz;
    if (scn.dist(p[0], p[1], p[2]) != out[4 * i]) out[4 * i] = NAN;
  }
}

extern "C" void host_train_fwd(const float* cam, const float* P, const float* s, const int* ids,
                               const float* g, const float* bbox, int ns, int ng, float* img,
                               float* res, int height, int width) {
  const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g));
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                    (size_t)height * width);
}

// the per-pixel part of lol_instanced_bwd: grads summed over pixels, the
// records [kSites][pixels] written as the kernel writes them
extern "C" void host_train_bwd(const float* cam, const float* P, const float* s, const int* ids,
                               const float* g, const float* bbox, int ns, int ng,
                               const float* res, const float* ct, double* grads, int* rows,
                               float* vals, int height, int width) {
  const size_t pixels = (size_t)height * width;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      float acc[kN] = {};
      const size_t pix = (size_t)y * width + x;
      lol::RecordSink sink{rows, reinterpret_cast<float4*>(vals), pixels, pix, 0};
      const Scene scn(P, tables(s, ids, g, bbox, ns, ng), reinterpret_cast<const float4*>(g),
                      &sink);
      lol::pixel_bwd<Cfg, Scene>(cam, scn, P, x, y, height, width, res + pix, pixels,
                                 ct + 3 * pix, acc);
      sink.close(kSites);
      for (int j = 0; j < kN; ++j) grads[j] += acc[j];
    }
}
"""


def _host_library(structure, cfg, tmp_path, residuals=False):
    """The instanced source's device functions built for the host (g++,
    IEEE arithmetic without contraction, as nvcc's --fmad=false); with
    `residuals`, the training source and its entry points."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    text = (_SHIM + generate_instanced_source(structure, cfg, residuals=residuals)
            + _HOST_ENTRIES + (_HOST_TRAIN_ENTRIES if residuals else ""))
    # one file name per source: dlopen returns a library already loaded
    # from the same path
    stem = "instanced_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    src = tmp_path / f"{stem}.cpp"
    src.write_text(text)
    so = tmp_path / f"{stem}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(src)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _table_args(structure, params):
    tab = pack_instanced(structure, params)
    arrays = [pack_fields(structure, params).numpy()] + [t.numpy() for t in tab]
    return arrays, [_ptr(a) for a in arrays] + [structure.num_spheres, tab.groups.shape[0]]


def _brute_force(scene, pts, clamp):
    """dist under `clamp` and (material, dist) of the unclamped first-wins
    argmin, over every sphere at once in numpy float32 (correctly rounded
    sqrt, as glibc's sqrtf and the card's), then the planes."""
    st, params = scene.structure, scene.params
    c, r = params.sphere_point.numpy(), params.sphere_radius.numpy()
    d = pts[:, None, :] - c
    dist = np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]) - r
    dmin, arg = dist.min(axis=1), dist.argmin(axis=1)
    mat = np.asarray(st.material_ids)[1 + arg]
    if clamp is not None:
        lo, hi = (c - r[:, None]).min(0), (c + r[:, None]).max(0)
        q = np.maximum(np.maximum(lo - pts, pts - hi), np.float32(0))
        s = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
        d_bbox = np.where(s > 0, np.sqrt(np.where(s > 0, s, 1)), 0).astype(np.float32)
        dmin = np.minimum(dmin, np.maximum(d_bbox, np.float32(clamp)))
    for k, y in enumerate(params.plane_y.numpy()):
        dp = pts[:, 1] - y
        win = dp < dmin
        dmin = np.where(win, dp, dmin)
        mat = np.where(win, st.material_ids[st.num_spheres + 1 + k], mat)
    return dmin, mat


def _points(scene, n_pts=1024, seed=0):
    """Seeded points: near spheres (inside many), in the field, on the
    AABB's faces, far outside, and around the tied pair."""
    rng = np.random.default_rng(seed)
    pos, rad = scene.params.sphere_point.numpy(), scene.params.sphere_radius.numpy()
    lo, hi = (pos - rad[:, None]).min(0), (pos + rad[:, None]).max(0)
    k = n_pts // 5
    near = pos[rng.integers(0, len(pos), k)] + rng.normal(0.0, 0.4, (k, 3))
    field = rng.uniform(lo, hi, (k, 3))
    faces = rng.uniform(lo, hi, (k, 3))
    axis = rng.integers(0, 3, k)
    faces[np.arange(k), axis] = np.where(rng.random(k) < 0.5, lo[axis], hi[axis])
    tie = pos[min(17, len(pos) - 1)] + rng.normal(0.0, 0.5, (k, 3))
    far = rng.uniform(-300.0, 300.0, (n_pts - 4 * k, 3))
    return np.concatenate([near, field, faces, tie, far]).astype(np.float32)


@pytest.mark.parametrize("n", [1, 300], ids=["single", "n300_tied"])
def test_host_built_scene_is_the_brute_force_min_and_argmin(tied, n, tmp_path):
    """Scene::dist (clamp 2), Scene::shadow_dist (clamp 8), and with the
    exact config Scene::dist: bitwise the brute-force min; Scene::sdf_mat:
    the unclamped first-wins argmin's material (the tied copy never wins
    over sphere 17) and the clamped distance, bitwise."""
    scene = tied if n == 300 else instanced_spheres(n=1, seed=7, device="cpu")
    pts = _points(scene)
    for cfg in (CLAMPED, EXACT):
        lib = _host_library(scene.structure, cfg, tmp_path)
        keep, args = _table_args(scene.structure, scene.params)
        out = np.zeros((len(pts), 4), np.float32)
        lib.host_eval(*args, _ptr(pts), len(pts), _ptr(out))
        want_d, want_mat = _brute_force(scene, pts, cfg.step_clamp)
        want_sd, _ = _brute_force(scene, pts, cfg.effective_shadow_clamp())
        np.testing.assert_array_equal(out[:, 0], want_d)
        np.testing.assert_array_equal(out[:, 1], want_sd)
        np.testing.assert_array_equal(out[:, 2], want_mat)
        np.testing.assert_array_equal(out[:, 3], want_d)
    if n == 300:
        assert (out[:, 2] == scene.structure.material_ids[18]).sum() > 50


@pytest.mark.parametrize("cfg", [CLAMPED, RenderConfig(step_clamp=2.0, antialias=True)],
                         ids=["clamp-shadow8", "clamp-aa"])
def test_host_built_render_pixel_matches_plain_version(tied, cfg, tmp_path):
    """render_pixel over the instanced Scene, per pixel on the host, vs
    instanced_forward_reference at 12x16: within 5e-5 (torch's CPU sqrt
    may round 1 ulp off glibc's; on the card both are correctly rounded),
    and the image is not flat."""
    st = tied.structure
    h, w = 12, 16
    lib = _host_library(st, cfg, tmp_path)
    cam_t = camera_pack(tied.params, h, w, cfg)
    keep, args = _table_args(st, tied.params)
    cam = cam_t.numpy()
    img = np.zeros((h, w, 3), np.float32)
    lib.host_render(_ptr(cam), *args, _ptr(img), h, w)
    tab = pack_instanced(st, tied.params)
    ref = instanced_fwd.instanced_forward_reference(
        st, cfg, cam_t, pack_fields(st, tied.params), tab, h, w
    ).numpy()
    np.testing.assert_allclose(img, ref, atol=5e-5, rtol=0)
    assert img.std() > 0.01


ENV_CLAMPED = RenderConfig(step_clamp=2.0, shadow_grad="envelope")


def _scatter(rows, vals, ns):
    """The records' sum per sorted row in increasing record index (the
    kernel's deterministic scatter), in float64."""
    out = np.zeros((ns, 4), np.float64)
    for i in np.flatnonzero(rows >= 0):
        out[rows[i]] += vals[i]
    return out


@pytest.mark.parametrize("cfg", [ENV_CLAMPED, RenderConfig(shadow_grad="envelope")],
                         ids=["clamp2", "exact"])
def test_host_built_dist_bwd_matches_autograd(tied, cfg, tmp_path):
    """InstancedScene::dist_bwd<true> and its record at the seeded points vs
    torch autograd of the plain training SDF (instanced_train.make_train_sdf)
    in the point, plane_y and the sphere table: its value is Scene::dist's
    bitwise; where a sphere wins the point gradient is gd times its unit
    normal and the record holds (-gd n, -gd) on its sorted row; where the
    cut wins, 0 and no record; where the plane wins, (0, gd, 0), -gd to
    plane_y and no record. The tied copy (sphere 200 of 17) never takes a
    gradient: ties go to the smaller SoA index in both versions."""
    st, params = tied.structure, tied.params
    pts = _points(tied)
    n = len(pts)
    gd = np.random.default_rng(1).uniform(-1.0, 1.0, n).astype(np.float32)
    lib = _host_library(st, cfg, tmp_path, residuals=True)
    keep, args = _table_args(st, params)
    out = np.zeros((n, 4), np.float32)
    g_fields = np.zeros(packed_size(st), np.float32)
    rows = np.full(n, -7, np.int32)
    vals = np.zeros((n, 4), np.float32)
    lib.host_dist_bwd(*args, _ptr(pts), _ptr(gd), n, _ptr(out), _ptr(g_fields), _ptr(rows),
                      _ptr(vals))
    assert np.isfinite(out[:, 0]).all()

    tab = pack_instanced(st, params)
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
    assert set(np.unique(rows)) <= set(range(-1, st.num_spheres))

    sphere = rows >= 0
    plane = (rows == -1) & (out[:, 2] != 0)
    cut = (rows == -1) & ~plane
    np.testing.assert_allclose(np.linalg.norm(out[sphere, 1:], axis=1), np.abs(gd[sphere]),
                               rtol=1e-5)
    np.testing.assert_array_equal(vals[sphere, 3], -gd[sphere])
    np.testing.assert_array_equal(out[plane, 2], gd[plane])
    assert (out[plane][:, [1, 3]] == 0).all() and (out[cut, 1:] == 0).all()
    assert sphere.sum() > 100 and plane.sum() > 10
    if cfg.step_clamp is not None:
        assert cut.sum() > 100
    else:
        assert cut.sum() == 0
    ids = tab.ids.numpy()[:, 0]
    tie_rows = rows[sphere & (np.abs(pts - params.sphere_point[17].numpy()).max(1) < 1.5)]
    assert (ids[tie_rows] == 17).sum() > 20 and (ids[rows[sphere]] != 200).all()


@pytest.mark.parametrize(
    "cfg", [ENV_CLAMPED, RenderConfig(step_clamp=2.0, antialias=True, shadow_grad="envelope")],
    ids=["clamp2", "clamp2-aa"])
def test_host_built_training_pixels_match_plain_versions(cfg, tmp_path):
    """render_pixel with residuals and pixel_bwd over the instanced Scene,
    per pixel on the host, vs instanced_train_forward_reference /
    instanced_train_backward_reference at 12x16 (instanced:300, seed 9):
    the image within 5e-5 and bitwise lol_instanced_render's host build,
    the residual planes as chip_smoke.py holds them; dcam rtol 2e-3, every
    field and the sphere table (records summed per row in record order)
    within 1e-4 * max|grad|."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    st = scene.structure
    h, w = 12, 16
    lib = _host_library(st, cfg, tmp_path, residuals=True)
    cam_t = camera_pack(scene.params, h, w, cfg)
    fields_t = pack_fields(st, scene.params)
    tab = pack_instanced(st, scene.params)
    keep, args = _table_args(st, scene.params)
    cam = cam_t.numpy()
    img = np.zeros((h, w, 3), np.float32)
    res = np.zeros((instanced_train.num_residuals(st), h, w), np.float32)
    lib.host_train_fwd(_ptr(cam), *args, _ptr(img), _ptr(res), h, w)
    img0 = np.zeros_like(img)
    _host_library(st, cfg, tmp_path).host_render(_ptr(cam), *args, _ptr(img0), h, w)
    np.testing.assert_array_equal(img, img0)
    img_p, res_p = instanced_train.instanced_train_forward_reference(
        st, cfg, cam_t, fields_t, tab, h, w)
    np.testing.assert_allclose(img, img_p.numpy(), atol=5e-5, rtol=0)
    res_p = res_p.numpy()
    assert (res[1:3] != res_p[1:3]).sum() <= 2
    with np.errstate(invalid="ignore"):  # inf - inf: a hard shadow's first step
        close = (res == res_p) | (np.abs(res - res_p) <= 1e-4 * np.maximum(1.0, np.abs(res_p)))
    for plane in [0] + list(range(4, res.shape[0])):
        assert (~close[plane]).sum() <= 2, plane
    live = (res_p[1] > 0.5) & (np.abs(res_p[3]) > 1e-2)
    assert live.sum() > 20
    np.testing.assert_allclose(res[3][live], res_p[3][live], rtol=1e-4)

    ct = np.random.default_rng(0).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    grads = np.zeros(CAM_SIZE + packed_size(st), np.float64)
    sites = instanced_train.num_sites(st)
    rows = np.full(sites * h * w, -7, np.int32)
    vals = np.zeros((sites * h * w, 4), np.float32)
    lib.host_train_bwd(_ptr(cam), *args, _ptr(res), _ptr(ct), _ptr(grads), _ptr(rows),
                       _ptr(vals), h, w)
    assert (rows >= -1).all() and (rows >= 0).sum() > 20
    dcam, dfields, dsph = instanced_train.instanced_train_backward_reference(
        st, cfg, cam_t, fields_t, tab, torch.from_numpy(res), torch.from_numpy(ct))
    dcam = dcam.numpy()
    np.testing.assert_allclose(
        grads[:CAM_SIZE], dcam, rtol=2e-3, atol=1e-5 * max(1.0, np.abs(dcam).max()))
    ours = unpack_fields(st, torch.from_numpy(grads[CAM_SIZE:]))
    for f, want in list(unpack_fields(st, dfields).items()) + [
            ("sphere table", dsph)]:
        got = _scatter(rows, vals, st.num_spheres) if f == "sphere table" else ours[f].numpy()
        want = want.numpy()
        if want.size == 0:
            continue
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=f)
    assert np.abs(dsph.numpy()).max() > 0


# --- the wrappers' device rules and the CLI --------------------------------------


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    scene = instanced_spheres(n=40, seed=2, device="cpu")
    st, cfg = scene.structure, RenderConfig(step_clamp=2.0)
    instanced_fwd.launches = 0
    cam = camera_pack(scene.params, 6, 10, cfg)
    fields = pack_fields(st, scene.params)
    tab = pack_instanced(st, scene.params)
    img = instanced_fwd.instanced_forward(st, cfg, cam, fields, tab, 6, 10)
    ref = instanced_fwd.instanced_forward_reference(st, cfg, cam, fields, tab, 6, 10)
    assert torch.equal(img, ref)
    assert torch.equal(make_cuda_renderer(st, 6, 10, cfg, device="cpu")(scene.params), ref)
    assert instanced_fwd.launches == 0


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    st = instanced_spheres(n=3, device="cpu").structure
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_cuda_renderer, make_instanced_renderer):
        with pytest.raises(RuntimeError, match="is_available"):
            make(st, 8, 8)
    out = tmp_path / "out.png"
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["render", "instanced:30", "--step-clamp", "2", "--size", "8x4", "-o", str(out)])
    assert not out.exists()


def test_cli_render_instanced_on_cpu(tmp_path, capsys):
    out = tmp_path / "out.png"
    instanced_fwd.launches = 0
    cli.main(["render", "instanced:300", "--step-clamp", "2", "--size", "12x8",
              "--device", "cpu", "-o", str(out)])
    scene = instanced_spheres(n=300, device="cpu")
    ref = make_instanced_renderer(
        scene.structure, 8, 12, RenderConfig(step_clamp=2.0), device="cpu"
    )(scene.params)
    assert np.array_equal(read_png(str(out)), image_to_u8(ref.numpy()))
    assert instanced_fwd.launches == 0
    cli.main(["info", "instanced:300"])
    assert '"spheres": 300' in capsys.readouterr().out
    assert (CSRC / "instanced_scene.cuh").is_file()
