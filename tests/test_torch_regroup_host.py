"""Host side of the regrouped instanced forward K9 (`lol_rg_march`,
`lol_rg_shadow`, `lol_rg_shade`, csrc/regroup.cuh) and of the split of
csrc/fused_fwd.cuh's `render_pixel` into a march half and a shade half, on
a machine without CUDA (g++ through the shim of
tests/test_torch_instanced_host.py):

- the regroup source: deterministic, one text for every sphere count, its
  entry points (the grid kernels, their walk twins, the two counting
  launches, the shade kernel);
- `render_pixel` (march half + shade half) against the function as it was
  written before the split (kept below, verbatim but for its name): image
  and residual planes bitwise, on scene4 with AA (K1, K1r) and on
  instanced:300 at clamp 2 with AA and exact (K5, K5r);
- the regrouped pipeline per pixel (rg_march_pixel, the Morton order of
  render/regroup.py, rg_shadow_at, rg_shade_pixel) bitwise render_pixel;
- `rg_shadow_at`'s per-record body bitwise K4's `shadow_at` on the same
  rays; lol_rg_march's planes against the plain march_track_reference
  (hit and material equal, the rest by the rule of
  tests/test_torch_march_host.py: torch's CPU kernels and g++ may round a
  sum apart);
- an AA miss's coverage value: `sdf_mat`'s distance (what K5 and
  lol_rg_shade use) bitwise `dist` (what the JAX package's
  `_shade_from_frozen` uses) at the closest-approach points;
- `CountingScene`'s evaluations per ray equal the plain shadow loop's.

The kernels themselves run only on the card (chip_smoke.py phases 22-24)."""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render import regroup
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import (
    CSRC,
    generate_instanced_source,
    generate_regroup_source,
    generate_source,
    pack_fields,
)
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.render.march_kernels import pack_march_scene, shadow_values_reference
from loltracer_tpu_torch.scene import build_scene
from loltracer_tpu_torch.scenes import instanced_spheres

torch.set_num_threads(1)  # one intra-op thread per pytest worker

_SHIM = r"""
#include <cstddef>
#define __device__
#define __host__
#define __forceinline__ inline
#define __ldg(p) (*(p))
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
"""

# csrc/fused_fwd.cuh's render_pixel as it was before the march / shade split
_OLD_RENDER_PIXEL = r"""
namespace lol {
// One pixel (x, y) of the image, and with Cfg::with_residuals its residual
// planes (res_out points at plane 0, pixel (0, 0); planes are `plane`
// floats apart: the launch's rows times W).
template <class Cfg, class Scene>
__device__ __forceinline__ void render_pixel_old(const float* cam, const Scene& scn,
                                             const float* __restrict__ P, int x,
                                             int y, int height, int width,
                                             float* __restrict__ img,
                                             float* __restrict__ res_out,
                                             size_t plane) {
  [[maybe_unused]] float* const rp =
      Cfg::with_residuals ? res_out + ((size_t)y * width + x) : nullptr;

  // --- camera ray (camera.rays_from_pack) ------------------------------
  const float ox = cam[0], oy = cam[1], oz = cam[2];
  const float vx = ((float)x + 0.5f) / (float)width * 2.f - 1.f;
  const float vy = 1.f - ((cam[15] + (float)y) + 0.5f) / (float)height * 2.f;
  const float sx = vx * cam[12], sy = vy * cam[13];
  float dx = cam[3] * sx + cam[6] * sy + cam[9];
  float dy = cam[4] * sx + cam[7] * sy + cam[10];
  float dz = cam[5] * sx + cam[8] * sy + cam[11];
  normalize3(dx, dy, dz);

  // --- march (march.py march) -------------------------------------------
  float t, t_query, s_min, t_close;
  march_ray<Cfg, Cfg::antialias>(scn, ox, oy, oz, dx, dy, dz, t, t_query, s_min, t_close);
  const bool hit = t < Cfg::max_dist;

  if constexpr (Cfg::with_residuals) {
    // IFT denominator: d/dt f(ro + t rd) at the marched t = grad f . rd
    float gx, gy, gz;
    scn.template dist_bwd<false>(ox + t * dx, oy + t * dy, oz + t * dz, 1.f, gx,
                                 gy, gz, nullptr);
    float den = dot3(gx, gy, gz, dx, dy, dz);
    if (fabsf(den) < kMinDen) den = den < 0.f ? -kMinDen : kMinDen;
    rp[3 * plane] = den;
  }

  // --- shading distance, material, coverage (march.py intersect_aa) -----
  float t_sh, alpha = 1.f;
  int mat;
  if (Cfg::antialias) {
    const float tc = hit ? t_query : t_close;
    float f_close;
    mat = scn.sdf_mat(ox + tc * dx, oy + tc * dy, oz + tc * dz, f_close);
    if (!hit) {
      const float s = f_close / (tc > 0.f ? tc : 1.f);
      alpha = tc > 0.f ? jclip(1.f - s / cam[14], 0.f, 1.f) : 0.f;
    }
    t_sh = hit ? t : tc;
  } else {
    float unused;
    mat = scn.sdf_mat(ox + t_query * dx, oy + t_query * dy, oz + t_query * dz,
                      unused);
    if (!hit) mat = 0;
    t_sh = t;
  }
  if constexpr (Cfg::with_residuals) {
    rp[0] = t_sh;
    rp[plane] = hit ? 1.f : 0.f;
    rp[2 * plane] = (float)mat;
  }
  const float px = ox + t_sh * dx, py = oy + t_sh * dy, pz = oz + t_sh * dz;

  // --- tetrahedron normal (shading.py get_normal) -----------------------
  const float h = t_sh * Cfg::normal_h_scale;
  float nx = 0.f, ny = 0.f, nz = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // taps (1,-1,-1), (-1,-1,1), (-1,1,-1), (1,1,1)
    const float kx = (k == 0 || k == 3) ? 1.f : -1.f;
    const float ky = (k >= 2) ? 1.f : -1.f;
    const float kz = (k == 1 || k == 3) ? 1.f : -1.f;
    const float d = scn.dist(px + kx * h, py + ky * h, pz + kz * h);
    nx = nx + kx * d;
    ny = ny + ky * d;
    nz = nz + kz * d;
  }
  normalize3(nx, ny, nz);

  // --- Phong with per-light soft shadows (shading.py shade) -------------
  const float shin = __ldg(P + Scene::kMatShininess + mat);
  float dif[3], spec[3], amb[3], col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dif[c] = __ldg(P + Scene::kMatDiffuse + 3 * mat + c);
    spec[c] = __ldg(P + Scene::kMatSpecular + 3 * mat + c);
    amb[c] = __ldg(P + Scene::kMatAmbient + 3 * mat + c);
    col[c] = 0.f;
  }
  float cx = cam[0] - px, cy = cam[1] - py, cz = cam[2] - pz;
  normalize3(cx, cy, cz);

#pragma unroll
  for (int l = 0; l < Scene::kNumLights; ++l) {
    const float* lp = P + Scene::kLightPoint + 3 * l;
    const float tlx = __ldg(lp) - px, tly = __ldg(lp + 1) - py,
                tlz = __ldg(lp + 2) - pz;
    const float light_dist = sqrtf(dot3(tlx, tly, tlz, tlx, tly, tlz));
    float lx = tlx, ly = tly, lz = tlz;
    normalize3(lx, ly, lz);
    const float sox = px + lx * Cfg::shadow_offset;
    const float soy = py + ly * Cfg::shadow_offset;
    const float soz = pz + lz * Cfg::shadow_offset;

    // soft-shadow march (shading.py soft_shadow)
    float t_star;
    const float res = shadow_ray<Cfg>(scn, sox, soy, soz, lx, ly, lz, light_dist, t_star);
    if constexpr (Cfg::with_residuals) {
      rp[(4 + 2 * l) * plane] = res;
      rp[(5 + 2 * l) * plane] = t_star;
    }
    const float shadow = jmax(res, 0.f);

    const float ndl = dot3(nx, ny, nz, lx, ly, lz);
    const float diffuse_incidence = jclip(ndl, 0.f, 1.f);
    const float w_diff = shadow * diffuse_incidence;
    const float two_ldn = 2.f * dot3(lx, ly, lz, nx, ny, nz);
    const float rx = nx * two_ldn - lx, ry = ny * two_ldn - ly,
                rz = nz * two_ldn - lz;
    const float base = jclip(dot3(rx, ry, rz, cx, cy, cz), 0.f, 1.f);
    const float powv = base > 0.f ? powf(base, shin) : (shin == 0.f ? 1.f : 0.f);
    const float w_spec = shadow * (diffuse_incidence * powv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[c] = col[c] + __ldg(P + Scene::kLightDiffuse + 3 * l + c) * w_diff * dif[c];
      col[c] = col[c] + __ldg(P + Scene::kLightSpecular + 3 * l + c) * w_spec * spec[c];
    }
  }

  float* out = img + ((size_t)y * width + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ambient = __ldg(P + Scene::kAmbientColor + c);
    float v = jclip(col[c] + ambient * amb[c], 0.f, 1.f);
    if (Cfg::antialias) {
      // blend toward the background (material 0 ambient) in linear space
      const float bg = jclip(ambient * __ldg(P + Scene::kMatAmbient + c), 0.f, 1.f);
      v = alpha * v + (1.f - alpha) * bg;
    }
    out[c] = v > 0.f ? powf(v, Cfg::gamma) : 0.f;
  }
}
}  // namespace lol
"""

_COMPILED_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;

extern "C" void host_render(const float* cam, const float* P, float* img, float* res,
                            int old, int height, int width) {
  const Scene scn(P);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      if (old)
        lol::render_pixel_old<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                          (size_t)height * width);
      else
        lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                      (size_t)height * width);
    }
}

extern "C" void host_close(const float* P, const float* pts, int n, float* out) {
  const Scene scn(P);
  for (int i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    scn.sdf_mat(p[0], p[1], p[2], out[2 * i]);
    out[2 * i + 1] = scn.dist(p[0], p[1], p[2]);
  }
}
"""

_INSTANCED_ENTRIES = r"""
using lol_gen::Cfg;
using lol_gen::Scene;
#define TABLES const float* s, const int* ids, const float* g, const float* bbox, int ns, int ng
#define SCENE                                                                        \
  const lol::InstancedTables tab{reinterpret_cast<const float4*>(s),                 \
                                 reinterpret_cast<const int2*>(ids),                 \
                                 reinterpret_cast<const float4*>(g), bbox, ns, ng};  \
  const Scene scn(P, tab, reinterpret_cast<const float4*>(g))

extern "C" void host_render(const float* cam, const float* P, TABLES, float* img, float* res,
                            int old, int height, int width) {
  SCENE;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      if (old)
        lol::render_pixel_old<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                          (size_t)height * width);
      else
        lol::render_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, img, res,
                                      (size_t)height * width);
    }
}

extern "C" void host_close(const float* P, TABLES, const float* pts, int n, float* out) {
  SCENE;
  for (int i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    scn.sdf_mat(p[0], p[1], p[2], out[2 * i]);
    out[2 * i + 1] = scn.dist(p[0], p[1], p[2]);
  }
}

extern "C" void host_rg_march(const float* cam, const float* P, TABLES, float* track,
                              float* hitp, float* rec, int height, int width) {
  SCENE;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::rg_march_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, track, hitp, rec,
                                      (size_t)height * width);
}

// counts: null for lol_rg_shadow's body, else [3, n] of CountingScene's counts
extern "C" void host_rg_shadow(const float* P, TABLES, const float* rec, const long long* perm,
                               float* out, float* counts, int n) {
  SCENE;
  for (int i = 0; i < n; ++i) {
    if (!counts) {
      lol::rg_shadow_at<Cfg, Scene>(scn, rec, perm, out, i, n);
      continue;
    }
    const lol::CountingScene<Cfg, Scene> counting{scn};
    lol::rg_shadow_at<Cfg, lol::CountingScene<Cfg, Scene>>(counting, rec, perm, out, i, n);
    counts[i] = counting.evals;
    counts[n + i] = counting.runs_lane;
    counts[2 * n + i] = counting.runs_warp;
  }
}

extern "C" void host_rg_shade(const float* cam, const float* P, TABLES, const float* track,
                              const float* shadow, float* img, int height, int width) {
  SCENE;
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::rg_shade_pixel<Cfg, Scene>(cam, scn, P, x, y, height, width, track, shadow, img,
                                      (size_t)height * width);
}

// K4's body (csrc/march.cuh shadow_at) on rays ro [n, 3], rd [n, 3], max_dist [n]
extern "C" void host_shadow_at(const float* P, TABLES, const float* ro, const float* rd,
                               const float* max_dist, float* out, int n) {
  SCENE;
  const lol::MarchArgs a{ro, 3, rd, max_dist, out};
  for (int i = 0; i < n; ++i) lol::shadow_at<Cfg, Scene>(scn, a, i, n);
}
"""


def _build(text, tmp_path):
    """`text` built for the host (g++, IEEE arithmetic without contraction,
    as nvcc's --fmad=false), one file name per source."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    stem = "regroup_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
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


def _close(got, want, atol=1e-4, rtol=1e-4, most=2):
    """Equal or within atol + rtol |want| on all but `most` values."""
    bad = ~((got == want) | (np.abs(got - want) <= atol + rtol * np.abs(want)))
    assert bad.sum() <= most, int(bad.sum())


H, W = 10, 24
INST_CFGS = {"clamp2_aa": RenderConfig(step_clamp=2.0, antialias=True, shadow_grad="envelope"),
             "exact": RenderConfig(shadow_grad="envelope")}


def _render(lib, cam, table_args, planes, old, h=H, w=W):
    """render_pixel (old=0) or the old render_pixel (old=1) over the image:
    (img [h, w, 3], residual planes [planes, h, w])."""
    img = np.zeros((h, w, 3), np.float32)
    res = np.zeros((planes, h, w), np.float32)
    lib.host_render(_ptr(cam), *table_args, _ptr(img), _ptr(res), old, h, w)
    return img, res


def test_regroup_source_entries_and_determinism():
    a, b = instanced_spheres(n=300, device="cpu"), instanced_spheres(n=10_000, seed=3, device="cpu")
    cfg = RenderConfig(step_clamp=2.0)
    src = generate_regroup_source(a.structure, cfg)
    assert src == generate_regroup_source(b.structure, cfg)
    for text in ("300", "10000", "299", "9999"):
        assert text not in src.split("namespace lol_gen {", 1)[1]
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_rg_march", "lol_rg_march_walk", "lol_rg_shadow", "lol_rg_shadow_walk",
                 "lol_rg_shadow_stats", "lol_rg_shadow_grid_stats", "lol_rg_shade",
                 "lol_rg_shade_walk", "lol_rg_shade_stats"):
        assert f"int {name}(" in entries
    assert "launch_rg_shade<lol_gen::Cfg, lol_gen::SceneOnGrid>" in entries
    assert "launch_rg_shade<lol_gen::Cfg, lol_gen::Scene>" in entries
    for body in ("grid_scene.cuh", "regroup.cuh"):
        assert (CSRC / body).read_text() in src
    assert src != generate_regroup_source(a.structure, RenderConfig())
    with pytest.raises(ValueError):
        generate_regroup_source(build_scene(parse_scene_file(
            str(CSRC.parent.parent / "examples" / "scene4.lol")), device="cpu").structure, cfg)


@pytest.mark.parametrize("residuals", [False, True], ids=["render", "train"])
def test_split_render_pixel_is_bitwise_the_old_one_compiled(examples_dir, residuals, tmp_path):
    """K1 / K1r: scene4 with AA at 10x24, the split render_pixel against the
    old one, image and residual planes bitwise; an AA miss's sdf_mat value
    bitwise its dist."""
    scene = build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    lib = _build(_SHIM + generate_source(scene.structure, cfg, residuals=residuals)
                 + _OLD_RENDER_PIXEL + _COMPILED_ENTRIES, tmp_path)
    cam = camera_pack(scene.params, H, W, cfg).numpy()
    fields = pack_fields(scene.structure, scene.params).numpy()
    planes = 4 + 2 * scene.structure.num_lights
    new = _render(lib, cam, [_ptr(fields)], planes, 0, H, W)
    old = _render(lib, cam, [_ptr(fields)], planes, 1, H, W)
    np.testing.assert_array_equal(new[0], old[0])
    np.testing.assert_array_equal(new[1], old[1])
    assert new[0].max() > 0
    if residuals:
        _check_close_values(lib, [_ptr(fields)], cam, new[1], H, W)


def _check_close_values(lib, table_args, cam, res, h, w):
    """sdf_mat's value == dist, bitwise, at the shading points of the AA
    misses (t_sh is their closest approach) and of a few hits."""
    from loltracer_tpu_torch.render.camera import rays_from_pack

    ro, rd = rays_from_pack(torch.from_numpy(cam), torch.arange(h), h, w)
    pts = (ro + torch.from_numpy(res[0])[..., None] * rd).reshape(-1, 3).numpy()
    miss = res[1].reshape(-1) < 0.5
    assert miss.any()
    pts = np.ascontiguousarray(pts)
    out = np.zeros((pts.shape[0], 2), np.float32)
    lib.host_close(*table_args, _ptr(pts), pts.shape[0], _ptr(out))
    np.testing.assert_array_equal(out[:, 0], out[:, 1])


@pytest.fixture(scope="module", params=list(INST_CFGS), ids=list(INST_CFGS))
def inst(request, tmp_path_factory):
    """instanced:300 (seed 9) in this config: the host build of the training
    source (K5 / K5r) with regroup.cuh, march.cuh and the old render_pixel,
    the scene's packed inputs, and render_pixel's image and residuals."""
    cfg = INST_CFGS[request.param]
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    st = scene.structure
    text = (_SHIM + generate_instanced_source(st, cfg, residuals=True)
            + (CSRC / "regroup.cuh").read_text() + (CSRC / "march.cuh").read_text()
            + _OLD_RENDER_PIXEL + _INSTANCED_ENTRIES)
    lib = _build(text, tmp_path_factory.mktemp("regroup_host"))
    cam = camera_pack(scene.params, H, W, cfg)
    fields = pack_fields(st, scene.params)
    tables = pack_instanced(st, scene.params)
    np_tabs = [t.numpy() for t in tables]
    table_args = [_ptr(fields.numpy()), *[_ptr(t) for t in np_tabs], st.num_spheres,
                  tables.groups.shape[0]]
    planes = 4 + 2 * st.num_lights
    img, res = _render(lib, cam.numpy(), table_args, planes, 0)
    return dict(cfg=cfg, scene=scene, lib=lib, cam=cam, fields=fields, tables=tables,
                np_tabs=np_tabs, table_args=table_args, img=img, res=res, planes=planes)


def test_split_render_pixel_is_bitwise_the_old_one_instanced(inst):
    """K5 / K5r: the split render_pixel against the old one, image and
    residual planes bitwise; an AA miss's sdf_mat value bitwise its dist."""
    img, res = _render(inst["lib"], inst["cam"].numpy(), inst["table_args"], inst["planes"], 1)
    np.testing.assert_array_equal(inst["img"], img)
    np.testing.assert_array_equal(inst["res"], res)
    assert img.max() > 0
    if inst["cfg"].antialias:
        _check_close_values(inst["lib"], inst["table_args"], inst["cam"].numpy(), res, H, W)


def _rg_march(inst):
    L = inst["scene"].structure.num_lights
    track = np.zeros((3, H, W), np.float32)
    hitp = np.zeros((3, H, W), np.float32)
    rec = np.zeros((L, 7, H, W), np.float32)
    inst["lib"].host_rg_march(_ptr(inst["cam"].numpy()), *inst["table_args"], _ptr(track),
                              _ptr(hitp), _ptr(rec), H, W)
    return track, hitp, rec


def test_regrouped_pipeline_is_bitwise_render_pixel(inst):
    """rg_march_pixel, the Morton order of each light's records, rg_shadow_at
    over them and rg_shade_pixel give render_pixel's image bitwise; the
    march planes are render_pixel's residual planes 0-2 and the plain
    march_track_reference's, bitwise."""
    lib, st = inst["lib"], inst["scene"].structure
    track, hitp, rec = _rg_march(inst)
    np.testing.assert_array_equal(track, inst["res"][:3])
    ref = regroup.march_track_reference(st, inst["cfg"], inst["cam"], inst["fields"],
                                        inst["tables"], H, W)
    np.testing.assert_array_equal(track[1:], ref.track[1:].numpy())
    for got, want in ((track[0], ref.track[0]), (hitp, ref.hitp), (rec, ref.rec)):
        _close(got, want.numpy())
    lo, hi = regroup.hit_box(torch.from_numpy(hitp))
    shadow = np.zeros((st.num_lights, 2, H, W), np.float32)
    for li in range(st.num_lights):
        perm = regroup.shadow_order(torch.from_numpy(rec[li]), lo, hi).numpy()
        assert not np.array_equal(perm, np.arange(H * W))
        lib.host_rg_shadow(*inst["table_args"], _ptr(np.ascontiguousarray(rec[li])),
                           _ptr(perm), _ptr(shadow[li]), None, H * W)
        np.testing.assert_array_equal(shadow[li], inst["res"][4 + 2 * li:6 + 2 * li])
    img = np.zeros((H, W, 3), np.float32)
    lib.host_rg_shade(_ptr(inst["cam"].numpy()), *inst["table_args"], _ptr(track),
                      _ptr(shadow), _ptr(img), H, W)
    np.testing.assert_array_equal(img, inst["img"])


def test_rg_shadow_body_is_shadow_at_and_counts_the_plain_loop(inst):
    """Per record, rg_shadow_at's (res, t*) bitwise K4's shadow_at on the
    same rays; CountingScene's evaluations per ray the plain shadow loop's
    steps for that ray alone, and its counts leave the values as they
    were."""
    lib, st, cfg = inst["lib"], inst["scene"].structure, inst["cfg"]
    _, _, rec = _rg_march(inst)
    n = H * W
    r = np.ascontiguousarray(rec[0].reshape(7, n))
    perm = np.random.default_rng(0).permutation(n).astype(np.int64)
    got = np.zeros((2, n), np.float32)
    lib.host_rg_shadow(*inst["table_args"], _ptr(r), _ptr(perm), _ptr(got), None, n)
    ro, rd = np.ascontiguousarray(r[0:3].T), np.ascontiguousarray(r[3:6].T)
    dist = np.ascontiguousarray(r[6])
    want = np.zeros((2, n), np.float32)
    lib.host_shadow_at(*inst["table_args"], _ptr(ro), _ptr(rd), _ptr(dist), _ptr(want), n)
    np.testing.assert_array_equal(got, want)

    counted = np.zeros((2, n), np.float32)
    counts = np.zeros((3, n), np.float32)
    lib.host_rg_shadow(*inst["table_args"], _ptr(r), _ptr(perm), _ptr(counted), _ptr(counts), n)
    np.testing.assert_array_equal(counted, want)
    scene = pack_march_scene(st, inst["scene"].params)
    for p in range(0, n, 23):
        live = []
        shadow_values_reference(st, cfg, torch.from_numpy(ro[p:p + 1]),
                                torch.from_numpy(rd[p:p + 1]), torch.from_numpy(dist[p:p + 1]),
                                scene, live)
        i = int(np.nonzero(perm == p)[0][0])
        assert counts[0, i] == len(live), (p, counts[0, i], len(live))
    # on the host a "warp" is one lane: its distinct runs are its own
    np.testing.assert_array_equal(counts[1], counts[2])
    assert counts[1].sum() > 0
