"""Host side of the port's instanced kernel (`lol_instanced_render`), on a
machine without CUDA:

- the generated source: deterministic, and one text for every sphere count
  and seed (no scene number, no sphere count, no material table in it);
- the instanced `Scene` of csrc/instanced_scene.cuh and `render_pixel` over
  it, compiled for the host with g++ through a small shim, against a
  brute-force min and first-wins argmin over every sphere: this is where
  the exactness of the bound-guided search is checked without a card;
- the wrappers' device rules and the CLI on `instanced:N`.

The kernel itself runs only on the card (chip_smoke.py)."""

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
from loltracer_tpu_torch.render import instanced_fwd
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer, make_instanced_renderer
from loltracer_tpu_torch.render.cuda_scene import (
    CSRC,
    generate_instanced_source,
    generate_source,
    pack_fields,
)
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils.image import image_to_u8, read_png

CLAMPED = RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0)
EXACT = RenderConfig()


@pytest.fixture(scope="module")
def tied():
    """instanced_spheres(300, seed 9) with sphere 200 a copy of sphere 17
    (materials 3 and 6): equal distances everywhere, so the first-wins
    rule decides their material."""
    scene = instanced_spheres(n=300, seed=9)
    scene.params.sphere_point[200] = scene.params.sphere_point[17]
    scene.params.sphere_radius[200] = scene.params.sphere_radius[17]
    return scene


# --- the generated source ------------------------------------------------------


def test_instanced_source_is_one_text_for_every_count_and_seed():
    cfg = RenderConfig(step_clamp=2.0)
    a, b = instanced_spheres(n=300), instanced_spheres(n=10_000, seed=3)
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


def test_instanced_structures_are_checked():
    st = instanced_spheres(n=3).structure
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
      lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, nullptr);
}
"""


def _host_library(structure, cfg, tmp_path):
    """The instanced source's device functions built for the host (g++,
    IEEE arithmetic without contraction, as nvcc's --fmad=false)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    text = _SHIM + generate_instanced_source(structure, cfg) + _HOST_ENTRIES
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
    scene = tied if n == 300 else instanced_spheres(n=1, seed=7)
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


# --- the wrappers' device rules and the CLI --------------------------------------


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    scene = instanced_spheres(n=40, seed=2)
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
    st = instanced_spheres(n=3).structure
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
    scene = instanced_spheres(n=300)
    ref = make_instanced_renderer(
        scene.structure, 8, 12, RenderConfig(step_clamp=2.0), device="cpu"
    )(scene.params)
    assert np.array_equal(read_png(str(out)), image_to_u8(ref.numpy()))
    assert instanced_fwd.launches == 0
    cli.main(["info", "instanced:300"])
    assert '"spheres": 300' in capsys.readouterr().out
    assert (CSRC / "instanced_scene.cuh").is_file()
