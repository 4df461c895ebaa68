"""Host side of the port's training path, on a machine without CUDA:

- the training source (deterministic, free of scene numbers, and apart
  from the residuals flag, the adjoint, the backward body and the entry
  points the same text as the forward source);
- the generated SDF adjoint `Scene::dist_bwd` and the kernels' per-pixel
  device functions (`render_pixel` with residuals, `pixel_bwd`), compiled
  for the host with g++ through a small shim, against torch autograd and
  the plain versions;
- the wrappers' device rules (CPU tensors take the plain versions and
  launch nothing; a CUDA request without CUDA raises);
- `fit_scene`, `masked_optimizer` and `default_project` against the JAX
  package's optax versions.

The kernels themselves run only on the card (chip_smoke.py phases 5-8)."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
from loltracer_tpu_torch.opt import (
    DEFAULT_TRAINABLE,
    default_project,
    fit_scene,
    masked_optimizer,
    trainable_leaves,
    trainable_mask,
)
from loltracer_tpu_torch.render import cuda_scene, fused_train
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack
from loltracer_tpu_torch.render.cuda_scene import generate_source, pack_fields, packed_size
from loltracer_tpu_torch.render.fused_fwd import fused_forward_reference
from loltracer_tpu_torch.render.camera import rays_from_pack
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import segment_lit
from loltracer_tpu_torch.render.vecmath import dot, normalize
from loltracer_tpu_torch.scene import FIELDS, SceneParams, build_scene, params_to_numpy

from test_torch_kernel_host import _f32, _numbers, _structured

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
CFG = RenderConfig(shadow_grad="envelope")
CFG_AA = dataclasses.replace(CFG, antialias=True)


@pytest.fixture(scope="module")
def examples(examples_dir):
    return {n: build_scene(parse_scene_file(str(examples_dir / n)), device="cpu") for n in SCENES}


# --- the training source -----------------------------------------------------


def test_training_source_is_deterministic_and_free_of_numbers(examples):
    s = examples["scene4.lol"].structure
    assert generate_source(s, CFG_AA, True) == generate_source(s, CFG_AA, True)
    a, b = _structured(1), _structured(2)
    src = generate_source(a.structure, CFG, True)
    assert src == generate_source(b.structure, CFG, True)
    for seed in (1, 2):
        for text in _numbers(seed).values():
            assert text not in src
            assert _f32(float(text)) not in src


@pytest.mark.parametrize("name", SCENES)
def test_training_source_differs_only_in_training_parts(examples, name):
    """Residuals on vs off: the Cfg flag, the SDF adjoint, the backward body
    and the entry points — nothing else. The forward source declares no
    residual output and no training entry."""
    s = examples[name].structure
    on = generate_source(s, CFG_AA, residuals=True)
    off = generate_source(s, CFG_AA, residuals=False)
    bwd_body = (cuda_scene.CSRC / "fused_bwd.cuh").read_text()
    rebuilt = (
        on.replace(bwd_body + "\n", "")
        .replace("\n\n" + cuda_scene._adjoint_source(s), "")
        .replace(cuda_scene._TRAIN_ENTRIES, cuda_scene._FWD_ENTRY)
        .replace("with_residuals = true;", "with_residuals = false;")
    )
    assert rebuilt == off
    assert "with_residuals = false;" in off and "dist_bwd" not in off.split("namespace lol_gen")[1]
    entries = off.rsplit("#ifdef __CUDACC__", 1)[1]
    assert "lol_train" not in entries and "res" not in entries.split("{")[0]


def test_segment_cull_is_emitted_only_where_it_applies(examples):
    """Scene::segment_lit and its flag are emitted for a compiled structure
    whose bound exists (no smooth-min over a plane) under cfg.shadow_cull,
    in the fused and the training sources alike, and in K3 / K4's march
    source (K4 culls by it); Cfg::shadow_cull carries the knob for
    compiled structures only; the instanced sources never carry the bound.
    The emitted bound holds offsets, not numbers."""
    from loltracer_tpu_torch.render.cuda_scene import (
        generate_instanced_source,
        generate_march_source,
    )
    from loltracer_tpu_torch.scenes import instanced_spheres

    from test_torch_segment_cull import _SMIN_PLANE

    marker = "kHasSegmentBound = true;"
    s4 = examples["scene4.lol"].structure
    no_cull = CFG.replace(shadow_cull=False)
    for residuals in (False, True):
        on = generate_source(s4, CFG, residuals)
        off = generate_source(s4, no_cull, residuals)
        assert marker in on and "shadow_cull = true;" in on
        assert marker not in off and "shadow_cull = false;" in off
        assert on.replace("\n\n" + cuda_scene._segment_source(s4), "").replace(
            "shadow_cull = true;", "shadow_cull = false;") == off
    smin_plane = build_scene(parse_scene(_SMIN_PLANE), device="cpu").structure
    assert marker not in generate_source(smin_plane, CFG)
    assert marker in generate_march_source(s4, CFG)
    assert marker not in generate_march_source(s4, no_cull)
    assert marker not in generate_march_source(smin_plane, CFG)
    inst = instanced_spheres(n=4, device="cpu").structure
    for src in (generate_instanced_source(inst, CFG), generate_instanced_source(inst, CFG, True)):
        assert "shadow_cull =" not in src and marker not in src
    a, b = _structured(1), _structured(2)
    src = generate_source(a.structure, CFG)
    assert marker in src and src == generate_source(b.structure, CFG)
    bound = cuda_scene._segment_source(a.structure)
    for seed in (1, 2):
        for text in _numbers(seed).values():
            assert text not in bound and _f32(float(text)) not in bound


# --- the generated device code, compiled for the host ------------------------

_SHIM = r"""
#include <cstddef>
#define __device__
#define __host__
#define __forceinline__ inline
#define __ldg(p) (*(p))
"""

_HOST_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;
constexpr int kN = lol::kCamSize + Scene::kNumFields;

// d, grad_p of dist at n points (rows of 4), and the param gradient of
// sum_i gd[i] * dist(p_i) added into gP
extern "C" void host_dist(const float* P, const float* pts, const float* gd, int n,
                          float* out, float* gP) {
  const Scene scn(P);
  for (int i = 0; i < n; ++i) {
    float gx, gy, gz;
    out[4 * i] = scn.template dist_bwd<true>(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                                             gd[i], gx, gy, gz, gP);
    out[4 * i + 1] = gx; out[4 * i + 2] = gy; out[4 * i + 3] = gz;
    if (scn.dist(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]) != out[4 * i]) out[4 * i] = NAN;
  }
}

extern "C" void host_train_fwd(const float* cam, const float* P, float* img, float* res,
                               int height, int width) {
  const Scene scn(P);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                    (size_t)height * width);
}

// the segment cull's flags of n shadow rays (so, l: rows of 3; T), -1 where
// the Scene has no cull
template <class S>
int seg_lit(const S& scn, const float* so, const float* l, float T) {
  if constexpr (lol::SegmentCull<Cfg, S>::value)
    return scn.segment_lit(so[0], so[1], so[2], l[0], l[1], l[2], T);
  else
    return -1;
}

extern "C" void host_segment_lit(const float* P, const float* so, const float* l, const float* T,
                                 int n, int* out) {
  const Scene scn(P);
  for (int i = 0; i < n; ++i) out[i] = seg_lit(scn, so + 3 * i, l + 3 * i, T[i]);
}

// lol_train_bwd's blocks, one after another (`blocks` of them, or the
// kernel's grid, bwd_num_blocks, when 0): block b walks its tiles thread by
// thread (bwd_thread), each thread's accumulators a column of a
// [kN][kBwdThreads] array; then per slot the sum over the block's threads
// in thread order, a row of partials [blocks, kN]
extern "C" int host_train_bwd_blocks(const float* cam, const float* P, const float* res,
                                     const float* ct, float* partials, int height, int width,
                                     int blocks) {
  constexpr int T = lol::kBwdThreads;
  const Scene scn(P);
  if (blocks == 0) blocks = lol::bwd_num_blocks(height, width);
  static float cols[kN * T];
  for (int b = 0; b < blocks; ++b) {
    for (int i = 0; i < kN * T; ++i) cols[i] = NAN;
    for (int t = 0; t < T; ++t)
      lol::bwd_thread<Cfg, Scene>(cam, scn, P, res, ct, b, blocks, t, height, height, width,
                                  cols + t);
    for (int j = 0; j < kN; ++j) {
      float s = 0.f;
      for (int t = 0; t < T; ++t) s += cols[j * T + t];
      partials[(size_t)b * kN + j] = s;
    }
  }
  return blocks;
}

extern "C" void host_train_bwd(const float* cam, const float* P, const float* res,
                               const float* ct, double* grads, int height, int width) {
  const Scene scn(P);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      float acc[kN] = {};
      const size_t pix = (size_t)y * width + x;
      lol::pixel_bwd<Cfg, Scene>(cam, scn, P, x, y, height, width, res + pix,
                                 (size_t)height * width, ct + 3 * pix, acc);
      for (int j = 0; j < kN; ++j) grads[j] += acc[j];
    }
}
"""


def _host_library(structure, cfg, tmp_path, name="train_host"):
    """The training source's device functions built for the host (g++,
    IEEE arithmetic without contraction, as nvcc's --fmad=false)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    src = tmp_path / f"{name}.cpp"
    src.write_text(_SHIM + generate_source(structure, cfg, residuals=True) + _HOST_ENTRIES)
    so = tmp_path / f"{name}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(so), str(src)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("name", SCENES)
def test_generated_sdf_adjoint_matches_autograd(examples, name, tmp_path):
    """Scene::dist_bwd vs torch.autograd of the plain SDF at 256 seeded
    points: its value equal to Scene::dist bitwise (the host entry point writes
    NaN otherwise) and to the plain SDF within 1e-6 relative (torch's CPU
    kernels and glibc round a sqrt 1 ulp apart at some points), point and
    field gradients atol 1e-5 * scale."""
    scene = examples[name]
    st = scene.structure
    lib = _host_library(st, CFG, tmp_path)
    rng = np.random.default_rng(SCENES.index(name))
    pts = rng.uniform(-6.0, 6.0, (256, 3)).astype(np.float32)
    pts[:, 2] -= 6.0  # the examples' objects sit in front of the camera, at -z
    gd = rng.uniform(-1.0, 1.0, 256).astype(np.float32)
    fields = pack_fields(st, scene.params).numpy()
    out = np.zeros((256, 4), np.float32)
    g_fields = np.zeros_like(fields)
    lib.host_dist(_ptr(fields), _ptr(pts), _ptr(gd), 256, _ptr(out), _ptr(g_fields))

    f_t = torch.from_numpy(fields).requires_grad_(True)
    p_t = torch.from_numpy(pts).requires_grad_(True)
    d = make_scene_sdf(st)(fused_train._params_of(st, torch.zeros(CAM_SIZE), f_t), p_t)
    gp, gf = torch.autograd.grad((d * torch.from_numpy(gd)).sum(), (p_t, f_t))
    np.testing.assert_allclose(out[:, 0], d.detach().numpy(), rtol=1e-6, atol=1e-6)
    want_p = gp.numpy()  # both scaled by the cotangent gd
    for got, want in ((out[:, 1:], want_p), (g_fields, gf.numpy())):
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize(
    "name,cfg",
    [("scene.lol", CFG_AA), ("scene2.lol", CFG), ("scene3.lol", CFG_AA), ("scene4.lol", CFG_AA)],
    ids=["scene_aa", "scene2", "scene3_aa", "scene4_aa"],
)
def test_host_built_kernels_match_plain_versions(examples, name, cfg, tmp_path):
    """The per-pixel functions of lol_train_fwd and lol_train_bwd, built
    for the host, vs train_forward_reference / train_backward_reference at
    12x40: the tolerances chip_smoke.py holds the kernels to on the card."""
    scene = examples[name]
    st = scene.structure
    h, w = 12, 40
    lib = _host_library(st, cfg, tmp_path)
    cam_t = camera_pack(scene.params, h, w, cfg)
    fields_t = pack_fields(st, scene.params)
    img_p, res_p = fused_train.train_forward_reference(st, cfg, cam_t, fields_t, h, w)
    cam, fields = cam_t.numpy(), fields_t.numpy()
    img = np.zeros((h, w, 3), np.float32)
    res = np.zeros((fused_train.num_residuals(st), h, w), np.float32)
    lib.host_train_fwd(_ptr(cam), _ptr(fields), _ptr(img), _ptr(res), h, w)
    np.testing.assert_allclose(img, img_p.numpy(), atol=5e-5, rtol=0)
    res_p = res_p.numpy()
    assert (res[1:3] != res_p[1:3]).sum() <= 2
    with np.errstate(invalid="ignore"):  # inf - inf: a hard shadow's first step
        close = (res == res_p) | (np.abs(res - res_p) <= 1e-4 * np.maximum(1.0, np.abs(res_p)))
    for plane in [0] + list(range(4, res.shape[0])):
        assert (~close[plane]).sum() <= 2, plane
    live = (res_p[1] > 0.5) & (np.abs(res_p[3]) > 1e-2)
    np.testing.assert_allclose(res[3][live], res_p[3][live], rtol=1e-4)

    ct = np.random.default_rng(0).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    grads = np.zeros(CAM_SIZE + packed_size(st), np.float64)
    lib.host_train_bwd(_ptr(cam), _ptr(fields), _ptr(res), _ptr(ct), _ptr(grads), h, w)
    dcam, dfields = fused_train.train_backward_reference(
        st, cfg, cam_t, fields_t, torch.from_numpy(res), torch.from_numpy(ct)
    )
    dcam = dcam.numpy()
    np.testing.assert_allclose(
        grads[:CAM_SIZE], dcam, rtol=2e-3, atol=1e-5 * max(1.0, np.abs(dcam).max())
    )
    for f, sl in _field_slices(st).items():
        want = dfields.numpy()[sl]
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(grads[CAM_SIZE:][sl], want, atol=1e-4 * scale,
                                   rtol=0, err_msg=f)


def _shadow_rays(structure, params, res, cam, h, w, cfg):
    """Per light, the shadow rays render_pixel marches from the residuals'
    shading distance: (origin, unit direction, distance to the light)."""
    ro, rd = rays_from_pack(cam, torch.arange(h), h, w)
    p = ro + res[0][..., None] * rd
    out = []
    for li in range(structure.num_lights):
        to_light = params.light_point[li] - p
        ld = normalize(to_light)
        out.append((p + ld * cfg.shadow_offset, ld, torch.sqrt(dot(to_light, to_light))))
    return out


@pytest.mark.parametrize(
    "name,cfg",
    [("scene.lol", CFG_AA), ("scene2.lol", CFG), ("scene4.lol", CFG_AA)],
    ids=["scene_aa", "scene2", "scene4_aa"],
)
def test_host_built_segment_cull(examples, name, cfg, tmp_path):
    """The generated Scene::segment_lit bitwise the plain flags
    (shading.segment_lit) on every light's shadow rays of a 12x40 frame,
    and render_pixel under Cfg::shadow_cull bitwise the build without the
    cull (cfg.shadow_cull=False) in the image and every residual plane."""
    scene = examples[name]
    st = scene.structure
    h, w = 12, 40
    on = _host_library(st, cfg, tmp_path, "cull_on")
    off = _host_library(st, cfg.replace(shadow_cull=False), tmp_path, "cull_off")
    cam_t = camera_pack(scene.params, h, w, cfg)
    cam, fields = cam_t.numpy(), pack_fields(st, scene.params).numpy()
    out = {}
    for key, lib in (("on", on), ("off", off)):
        img = np.zeros((h, w, 3), np.float32)
        res = np.zeros((fused_train.num_residuals(st), h, w), np.float32)
        lib.host_train_fwd(_ptr(cam), _ptr(fields), _ptr(img), _ptr(res), h, w)
        out[key] = img, res
    np.testing.assert_array_equal(out["on"][0], out["off"][0])
    np.testing.assert_array_equal(out["on"][1], out["off"][1])

    culled = 0
    for so, ld, dist in _shadow_rays(st, scene.params, torch.from_numpy(out["on"][1]), cam_t,
                                     h, w, cfg):
        so, ld, dist = (a.reshape(-1, *a.shape[2:]).contiguous().numpy() for a in (so, ld, dist))
        want = segment_lit(st, scene.params, torch.from_numpy(so), torch.from_numpy(ld),
                           torch.from_numpy(dist), cfg.shadow_w).numpy()
        for lib, expect in ((on, want.astype(np.int32)), (off, np.full(len(dist), -1, np.int32))):
            got = np.zeros(len(dist), np.int32)
            lib.host_segment_lit(_ptr(fields), _ptr(so), _ptr(ld), _ptr(dist), len(dist),
                                 _ptr(got))
            np.testing.assert_array_equal(got, expect)
        culled += int(want.sum())
    assert culled > 0, "no shadow ray of the frame is culled"


def test_host_built_shared_accumulators_match_plain_version(examples, tmp_path):
    """lol_train_bwd's blocks (bwd_pixels over StridedAcc columns, the
    block's fixed-order sum) built for the host, scene4 AA at 12x40 (six
    tiles of 32 x 4): on the kernel's grid of six blocks and on four (two
    of them walking two tiles), the partials summed within 1e-4 *
    max|grad| per field of train_backward_reference (dcam rtol 2e-3), and
    two runs bitwise equal."""
    scene = examples["scene4.lol"]
    st = scene.structure
    h, w = 12, 40
    lib = _host_library(st, CFG_AA, tmp_path)
    cam_t = camera_pack(scene.params, h, w, CFG_AA)
    fields_t = pack_fields(st, scene.params)
    _, res_t = fused_train.train_forward_reference(st, CFG_AA, cam_t, fields_t, h, w)
    cam, fields, res = cam_t.numpy(), fields_t.numpy(), res_t.numpy()
    ct = np.random.default_rng(1).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    n = CAM_SIZE + packed_size(st)
    dcam, dfields = fused_train.train_backward_reference(
        st, CFG_AA, cam_t, fields_t, res_t, torch.from_numpy(ct))
    dcam = dcam.numpy()
    for grid in (0, 4):
        runs = []
        for _ in range(2):
            partials = np.full((64, n), np.nan, np.float32)
            blocks = lib.host_train_bwd_blocks(_ptr(cam), _ptr(fields), _ptr(res), _ptr(ct),
                                               _ptr(partials), h, w, grid)
            runs.append(partials[:blocks])
        assert blocks == (grid or 6)
        np.testing.assert_array_equal(runs[0], runs[1])
        grads = runs[0].astype(np.float64).sum(0)
        np.testing.assert_allclose(
            grads[:CAM_SIZE], dcam, rtol=2e-3, atol=1e-5 * max(1.0, np.abs(dcam).max()))
        for f, sl in _field_slices(st).items():
            want = dfields.numpy()[sl]
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(grads[CAM_SIZE:][sl], want, atol=1e-4 * scale, rtol=0,
                                       err_msg=f)


def _field_slices(structure):
    off = cuda_scene.field_offsets(structure)
    return {
        f: slice(o, o + int(np.prod(cuda_scene.field_shape(structure, f))))
        for f, o in off.items()
    }


# --- the wrappers' device rules --------------------------------------------------


def test_training_renderer_refuses_what_the_kernels_do_not_implement(examples, monkeypatch,
                                                                   tmp_path):
    st = examples["scene4.lol"].structure
    with pytest.raises(ValueError, match="envelope"):
        fused_train.make_training_renderer(st, 8, 8, RenderConfig(shadow_grad="exact"))
    with pytest.raises(ValueError, match="instanced"):
        fused_train.make_training_renderer(
            dataclasses.replace(st, instanced=True), 8, 8, CFG
        )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fused_train.make_training_renderer(st, 8, 8, CFG)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_scene(st, examples["scene4.lol"].params, np.zeros((4, 4, 3), np.float32), steps=1)
    # a mesh and a checkpoint are taken (on the CPU, which needs no card)
    from loltracer_tpu_torch.opt import load_checkpoint
    from loltracer_tpu_torch.parallel import make_mesh

    ckpt = str(tmp_path / "fit.ckpt")
    try:
        fit = fit_scene(st, examples["scene4.lol"].params, np.zeros((8, 4, 3)), steps=1,
                        mesh=make_mesh(1, device="cpu"), checkpoint_path=ckpt,
                        checkpoint_every=1, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    assert np.isfinite(fit.losses).all() and load_checkpoint(ckpt, st)[0] == 1
    # the exact estimator is no longer refused on the card (its march runs
    # the kernel K3): past the gate, it reaches for the device, which this
    # CPU build of torch does not have
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        fit_scene(st, examples["scene4.lol"].params, np.zeros((4, 4, 3), np.float32),
                  cfg=RenderConfig(shadow_grad="exact"), device="cuda")


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    scene = _structured(5)
    st = scene.structure
    fused_train.launches_fwd = fused_train.launches_bwd = 0
    render = fused_train.make_training_renderer(st, 6, 10, CFG_AA, device="cpu")
    params = trainable_leaves(scene.params, DEFAULT_TRAINABLE)
    img = render(params)
    cam = camera_pack(scene.params, 6, 10, CFG_AA)
    fields = pack_fields(st, scene.params)
    assert torch.equal(img.detach(), fused_forward_reference(st, CFG_AA, cam, fields, 6, 10))
    img.sum().backward()
    assert params.sphere_point.grad is not None and params.cam_fov.grad is None
    assert fused_train.launches_fwd == 0 and fused_train.launches_bwd == 0


@pytest.mark.parametrize("cfg", [CFG, CFG_AA], ids=["parity", "aa"])
def test_plain_loops_count_live_rays_without_changing_values(examples, cfg):
    """train_forward_reference's `live` counts (the SDF evaluations a
    thread-per-ray kernel makes, which chip_smoke.py's bounds use): without
    the segment cull every ray evaluates at the first step of the march and
    of each light's shadow march; the counts never rise within a loop; the
    per-ray counts ("rays") add up to them; under cfg.shadow_cull the march
    counts are the same, the shadow counts no more and the culled rays
    evaluate nothing in their shadow march; and the outputs are bitwise
    those of a call without counting, the cull on or off."""
    s = examples["scene4.lol"]
    h, w = 6, 10
    cam = camera_pack(s.params, h, w, cfg)
    fields = pack_fields(s.structure, s.params)
    no_cull = cfg.replace(shadow_cull=False)
    live = {"march": [], "shadow": [], "rays": torch.zeros((h, w), dtype=torch.int32)}
    img, res = fused_train.train_forward_reference(s.structure, no_cull, cam, fields, h, w,
                                                   live=live)
    img0, res0 = fused_train.train_forward_reference(s.structure, cfg, cam, fields, h, w)
    live_c = {"march": [], "shadow": [], "rays": torch.zeros((h, w), dtype=torch.int32)}
    img_c, res_c = fused_train.train_forward_reference(s.structure, cfg, cam, fields, h, w,
                                                       live=live_c)
    assert torch.equal(img, img0) and torch.equal(res, res0)
    assert torch.equal(img_c, img0) and torch.equal(res_c, res0)
    march = live["march"]
    assert march[0] == h * w and all(a >= b > 0 for a, b in zip(march, march[1:]))
    assert len(march) <= cfg.max_steps
    starts = [i for i, n in enumerate(live["shadow"]) if n == h * w]
    assert starts[0] == 0 and len(starts) >= s.structure.num_lights
    assert all(0 < n <= h * w for n in live["shadow"])
    assert len(live["shadow"]) <= s.structure.num_lights * cfg.shadow_steps
    for lv in (live, live_c):
        assert int(lv["rays"].sum()) == sum(lv["march"]) + sum(lv["shadow"])
    assert live_c["march"] == march and sum(live_c["shadow"]) <= sum(live["shadow"])
    assert bool((live_c["rays"] <= live["rays"]).all())


# --- the optimizer ---------------------------------------------------------------


def test_fit_scene_loss_decreases_under_adam(examples):
    """The port of tests/test_train.py::test_fused_loss_decreases_under_adam:
    scene3 at 24x128, image-plane sphere positions perturbed and the only
    trainable field, Adam 3e-2, 12 steps: the least loss is below half the
    first. Frozen fields stay bitwise unchanged."""
    scene = examples["scene3.lol"]
    st = scene.structure
    target = fused_train.make_training_renderer(st, 24, 128, CFG_AA, device="cpu")(scene.params)
    delta = torch.zeros_like(scene.params.sphere_point)
    delta[:, 0], delta[:, 1] = 0.15, -0.1
    start = dataclasses.replace(scene.params, sphere_point=scene.params.sphere_point + delta)
    out = fit_scene(st, start, target.detach(), steps=13, learning_rate=3e-2,
                    trainable=("sphere_point",), cfg=CFG_AA, device="cpu")
    assert out.losses.shape == (13,) and np.isfinite(out.losses).all()
    assert out.losses[1:].min() < 0.5 * out.losses[0], out.losses
    before, after = params_to_numpy(start), params_to_numpy(out.params)
    for f in FIELDS:
        if f != "sphere_point":
            np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert not np.array_equal(after["sphere_point"], before["sphere_point"])


def test_masked_adam_matches_optax():
    """masked_optimizer + 3 Adam steps vs the JAX package's masked optax
    Adam on the same numpy gradients: atol 1e-6. default_project equals
    the JAX package's."""
    import jax.numpy as jnp
    import optax

    from loltracer_tpu.opt import default_project as jax_project
    from loltracer_tpu.opt import masked_optimizer as jax_masked
    from loltracer_tpu.scene import SceneParams as JaxParams

    fields = ("sphere_point", "mat_diffuse", "light_point")
    rng = np.random.default_rng(0)
    # numbers of magnitude below 1, where 1e-6 is several float32 ulps
    start = {f: rng.uniform(-1, 1, v.shape).astype(np.float32)
             for f, v in params_to_numpy(_structured(6).params).items()}
    grads = [{f: rng.normal(size=v.shape).astype(np.float32) for f, v in start.items()}
             for _ in range(3)]

    params = trainable_leaves(SceneParams(**{f: torch.from_numpy(v) for f, v in start.items()}),
                              fields)
    opt = masked_optimizer(params, fields, lr=3e-2)
    for g in grads:
        for f in fields:
            getattr(params, f).grad = torch.from_numpy(g[f])
        opt.step()

    jp = JaxParams(**{f: jnp.asarray(v) for f, v in start.items()})
    jopt = jax_masked(optax.adam(3e-2), jp, fields)
    state = jopt.init(jp)
    for g in grads:
        updates, state = jopt.update(JaxParams(**{f: jnp.asarray(v) for f, v in g.items()}),
                                     state, jp)
        jp = optax.apply_updates(jp, updates)

    ours = params_to_numpy(params)
    for f in FIELDS:
        np.testing.assert_allclose(ours[f], np.asarray(getattr(jp, f)), atol=1e-6, rtol=0,
                                   err_msg=f)
        if f not in fields:
            np.testing.assert_array_equal(ours[f], start[f], err_msg=f)
    assert [f for f in FIELDS if getattr(trainable_mask(params, fields), f)] == [
        f for f in FIELDS if f in fields
    ]

    wild = {f: rng.normal(size=v.shape).astype(np.float32) for f, v in start.items()}
    mine = params_to_numpy(default_project(SceneParams(**{
        f: torch.from_numpy(v) for f, v in wild.items()
    })))
    theirs = jax_project(JaxParams(**{f: jnp.asarray(v) for f, v in wild.items()}))
    for f in FIELDS:
        np.testing.assert_array_equal(mine[f], np.asarray(getattr(theirs, f)), err_msg=f)
