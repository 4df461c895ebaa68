"""Host side of the port's value march kernels K3 (`lol_march`,
`lol_march_instanced`) and K4 (`lol_shadow_march`,
`lol_shadow_march_instanced`), on a machine without CUDA:

- the generated march source: deterministic, one text for every sphere
  count, the entry points where they belong (one launch shape a compiled
  kernel, no `_tile` entry), `Scene::segment_lit` under cfg.shadow_cull
  only where the structure allows it, and a library key that separates
  shadow_cull for compiled structures only;
- csrc/march.cuh's per-ray functions over the compiled and the instanced
  `Scene`, compiled for the host with g++ through the shim of
  tests/test_torch_train_host.py, ray by ray against the plain loops
  (march_values_reference, shadow_values_reference) on camera rays and on
  the real shadow rays of each light: scene4, and instanced:300 at clamp 2
  and exact;
- K4 with the segment cull bitwise its `shadow_cull=False` twin, and the
  plain loops with the cull bitwise without it, on every light of
  scene2, scene3, scene4 (AA) and a structure with a box;
- the compiled launch's ray mapping (`march_shape`, `march_ray_xy`) over
  ragged [rows, width] batches: each ray taken by exactly one thread at
  warp tile widths 32, 16 and 8 (the entries launch MARCH_TILE_W), each
  warp one tile;
- K7's per-point function `eval_at` (`lol_instanced_eval`) over the
  InstancedScene of its generated source, point by point against its
  plain version (`instanced_eval_reference`): instanced:300 whole at clamp
  2 and exact, and a sentinel-padded shard under the combined AABB;
- `render_pixel` after its march and shadow loops moved into `march_ray` /
  `shadow_ray`, against the same source with the loops written inline as
  they were: the two host builds give bitwise the same image and residual
  planes.

The kernels themselves run only on the card (chip_smoke.py phases 17-21
and 26)."""

import ctypes
import dataclasses
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
from loltracer_tpu_torch.render import cuda_scene, march_kernels
from loltracer_tpu_torch.render.camera import camera_pack, camera_rays
from loltracer_tpu_torch.render.cuda_scene import (
    generate_eval_source,
    generate_march_source,
    generate_source,
    pack_fields,
)
from loltracer_tpu_torch.render.march_kernels import (
    instanced_eval_reference,
    march_values_reference,
    pack_eval_tables,
    pack_march_scene,
    shadow_values_reference,
)
from loltracer_tpu_torch.render.shading import segment_lit
from loltracer_tpu_torch.render.vecmath import dot, normalize
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

# per ray i of n: K3's four planes [4, n] (max_dist null) or K4's two [2, n]
_COMPILED_ENTRY = r"""
using lol_gen::Cfg;
using lol_gen::Scene;

extern "C" void host_march(const float* P, const float* ro, int ro_stride, const float* rd,
                           const float* max_dist, float* out, int n) {
  const Scene scn(P);
  const lol::MarchArgs a{ro, ro_stride, rd, max_dist, out};
  for (size_t i = 0; i < (size_t)n; ++i) {
    if (max_dist) lol::value_at<true, Cfg>(scn, a, i, n);
    else lol::value_at<false, Cfg>(scn, a, i, n);
  }
}
"""

_INSTANCED_ENTRY = r"""
using lol_gen::Cfg;
using lol_gen::Scene;

extern "C" void host_march(const float* P, const float* s, const int* ids, const float* g,
                           const float* bbox, int ns, int ng, const float* ro, int ro_stride,
                           const float* rd, const float* max_dist, float* out, int n) {
  const lol::InstancedTables tab{reinterpret_cast<const float4*>(s),
                                 reinterpret_cast<const int2*>(ids),
                                 reinterpret_cast<const float4*>(g), bbox, ns, ng};
  const Scene scn(P, tab, reinterpret_cast<const float4*>(g));
  const lol::MarchArgs a{ro, ro_stride, rd, max_dist, out};
  for (size_t i = 0; i < (size_t)n; ++i) {
    if (max_dist) lol::value_at<true, Cfg>(scn, a, i, n);
    else lol::value_at<false, Cfg>(scn, a, i, n);
  }
}
"""

# K7 per point i of n
_EVAL_ENTRY = r"""
extern "C" void host_eval(const float* plane_y, const float* s, const float* g,
                          const float* bbox, int ns, int ng, const float* p, float* out, int n) {
  const lol::InstancedTables tab{reinterpret_cast<const float4*>(s), nullptr,
                                 reinterpret_cast<const float4*>(g), bbox, ns, ng};
  const lol_gen::Scene scn(plane_y, tab, reinterpret_cast<const float4*>(g));
  for (size_t i = 0; i < (size_t)n; ++i) lol::eval_at(scn, p, out, i);
}
"""

_RENDER_ENTRY = r"""
extern "C" void host_render(const float* cam, const float* P, float* img, float* res,
                            int height, int width) {
  const lol_gen::Scene scn(P);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      lol::render_pixel<lol_gen::Cfg, lol_gen::Scene>(cam, scn, P, x, y, height, width, img,
                                                      res, (size_t)height * width);
}
"""

# render_pixel's two loops as they were written before march_ray and
# shadow_ray took them over
_MARCH_CALL = """\
  float t, t_query, s_min, t_close;
  march_ray<Cfg, Cfg::antialias>(scn, ox, oy, oz, dx, dy, dz, t, t_query, s_min, t_close);
"""
_MARCH_INLINE = """\
  float t = 0.f, t_query = 0.f, s_min = INFINITY, t_close = 0.f;
  for (int step = 0; step < Cfg::max_steps; ++step) {
    const float d = scn.dist(ox + t * dx, oy + t * dy, oz + t * dz);
    const float new_t = t + d;
    if (Cfg::antialias) {
      const float s = d / (t > 0.f ? t : 1.f);
      if (t > 0.f && s < s_min) {
        s_min = s;
        t_close = t;
      }
    }
    t_query = t;
    t = new_t;
    if (d < Cfg::epsilon || new_t > Cfg::max_dist) break;
  }
"""
_SHADOW_CALL = """\
    float t_star;
    const float res = shadow_ray<Cfg>(scn, sox, soy, soz, lx, ly, lz, light_dist, t_star);
"""
_SHADOW_INLINE = """\
    float res = 1.f, ts = 0.f, t_star = 0.f;
    for (int step = 0; step < Cfg::shadow_steps; ++step) {
      const float d = scn.shadow_dist(sox + ts * lx, soy + ts * ly, soz + ts * lz);
      const float val =
          ts > 0.f ? Cfg::shadow_w * d / ts : (d < 0.f ? -INFINITY : INFINITY);
      if constexpr (Cfg::with_residuals) {
        if (val < res) t_star = ts;  // first-wins argmin (NaN never wins)
      }
      res = jmin(res, val);
      ts = ts + d;
      if (res < -1.f || ts > light_dist) break;
    }
"""


def _build(text, tmp_path):
    """`text` built for the host (g++, IEEE arithmetic without contraction,
    as nvcc's --fmad=false), one file name per source."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    stem = "march_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
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


@pytest.fixture(scope="module")
def scene4(examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")


def _shadow_rays(structure, params, ro, rd, t, cfg):
    """Per light, the shadow rays shading.phong marches from the hits at t:
    (origin, direction, distance to the light), contiguous."""
    p = ro + t[..., None] * rd
    out = []
    for li in range(structure.num_lights):
        to_light = params.light_point[li] - p
        light_dir = normalize(to_light)
        out.append(tuple(x.contiguous() for x in (
            p + light_dir * cfg.shadow_offset, light_dir, torch.sqrt(dot(to_light, to_light)))))
    return out


def _host_values(lib, structure, scene, ro, rd, max_dist):
    """The host build's planes [4 or 2, ...] for the rays ro, rd (and
    max_dist for K4)."""
    batch = tuple(rd.shape[:-1])
    n = int(np.prod(batch))
    out = np.zeros((4 if max_dist is None else 2, n), np.float32)
    ro_np, rd_np = ro.contiguous().numpy(), rd.contiguous().numpy()
    md = None if max_dist is None else max_dist.contiguous().numpy()
    args = [_ptr(ro_np), 0 if ro.dim() == 1 else 3, _ptr(rd_np),
            None if md is None else _ptr(md), _ptr(out), n]
    fields = scene.fields.numpy()
    if structure.instanced:
        tabs = [t.numpy() for t in scene.tables]
        lib.host_march(_ptr(fields), *[_ptr(t) for t in tabs], structure.num_spheres,
                       scene.tables.groups.shape[0], *args)
    else:
        lib.host_march(_ptr(fields), *args)
    return out.reshape((-1,) + batch)


def _close(got, want, what, atol=1e-4, rtol=1e-4, most=2):
    """Equal (infinities included) or within atol + rtol |want| on all but
    `most` rays: the rule chip_smoke.py holds the kernels to."""
    with np.errstate(invalid="ignore"):  # inf - inf
        bad = ~((got == want) | (np.abs(got - want) <= atol + rtol * np.abs(want)))
    assert bad.sum() <= most, (what, int(bad.sum()))


def _check_marches(lib, structure, params, cfg, h, w):
    """K3 on the camera rays and K4 on each light's shadow rays from K3's
    hits, host build vs the plain loops."""
    scene = pack_march_scene(structure, params)
    ro, rd = camera_rays(params, h, w, cfg)
    want = march_values_reference(structure, cfg, ro, rd, scene)
    got = _host_values(lib, structure, scene, ro, rd, None)
    for i, name in enumerate(("t", "t_query", "s_min", "t_close")):
        _close(got[i], want[i].numpy(), name)
    for li, (so, ld, dist) in enumerate(_shadow_rays(structure, params, ro, rd,
                                                     torch.from_numpy(got[0]), cfg)):
        want = shadow_values_reference(structure, cfg, so, ld, dist, scene)
        got_s = _host_values(lib, structure, scene, so, ld, dist)
        _close(got_s[0], want[0].numpy(), f"res of light {li}", atol=5e-5)
        _close(got_s[1], want[1].numpy(), f"t* of light {li}", atol=5e-5)
        # the per-ray origin layout (ro_stride 3) is exercised here too
        assert so.dim() == 3


def test_march_source_entries_and_determinism(scene4):
    cfg = RenderConfig(antialias=True)
    src = generate_march_source(scene4.structure, cfg)
    assert src == generate_march_source(scene4.structure, cfg)
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_march", "lol_shadow_march"):
        assert f"int {name}(" in entries
    # one launch shape a kernel: no `_tile` entry, no dispatch on a width
    assert "_tile" not in entries and "switch" not in entries
    assert f"constexpr int kMarchTileW = {cuda_scene.MARCH_TILE_W};" in src
    assert "instanced" not in entries
    assert (cuda_scene.CSRC / "march.cuh").read_text() in src
    a, b = instanced_spheres(n=300, device="cpu"), instanced_spheres(n=10_000, seed=3, device="cpu")
    clamp2 = RenderConfig(step_clamp=2.0)
    inst = generate_march_source(a.structure, clamp2)
    assert inst == generate_march_source(b.structure, clamp2)
    for text in ("300", "10000", "299", "9999"):
        assert text not in inst.split("namespace lol_gen {", 1)[1]
    entries = inst.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_march_instanced", "lol_shadow_march_instanced"):
        assert f"int {name}(" in entries
    assert inst != generate_march_source(a.structure, RenderConfig())
    # configs that agree on what the kernels compile in share one library
    k = march_kernels.kernel_config
    assert k(scene4.structure, cfg) == k(scene4.structure, RenderConfig(gamma=1.0))
    assert k(a.structure, clamp2) != k(a.structure, clamp2.replace(shadow_step_clamp=8.0))
    # the segment cull is compiled into K4 for compiled structures (its
    # twin a library of its own); the instanced entries have no bound, so
    # their key ignores it
    no_cull = cfg.replace(shadow_cull=False)
    assert k(scene4.structure, cfg) != k(scene4.structure, no_cull)
    assert k(scene4.structure, no_cull) == k(scene4.structure, RenderConfig(shadow_cull=False))
    assert k(a.structure, clamp2) == k(a.structure, clamp2.replace(shadow_cull=False))
    assert inst == generate_march_source(a.structure, clamp2.replace(shadow_cull=False))
    assert src != generate_march_source(scene4.structure, no_cull)


def test_host_built_compiled_marches_match_plain_loops(scene4, tmp_path):
    """scene4 at 12x40: K3's four planes and, per light, K4's res and t*
    on the shadow rays from the hits."""
    cfg = RenderConfig(antialias=True)
    src = _SHIM + generate_march_source(scene4.structure, cfg) + _COMPILED_ENTRY
    _check_marches(_build(src, tmp_path), scene4.structure, scene4.params, cfg, 12, 40)


@pytest.mark.parametrize(
    "cfg", [RenderConfig(step_clamp=2.0), RenderConfig()], ids=["clamp2", "exact"]
)
def test_host_built_instanced_marches_match_plain_loops(cfg, tmp_path):
    """instanced:300 (seed 9) at 10x24: the traversal under the primary
    clamp in K3 and under the shadow clamp in K4, against the plain loops
    over the blockwise SDF."""
    scene = instanced_spheres(n=300, seed=9, device="cpu")
    src = _SHIM + generate_march_source(scene.structure, cfg) + _INSTANCED_ENTRY
    _check_marches(_build(src, tmp_path), scene.structure, scene.params, cfg, 10, 24)


def test_eval_source_entry_and_determinism():
    """K7's source: its entry over the cell grid and the two check entries
    (the run walk, the grid with counts), deterministic, one text for every
    structure with as many planes whatever its spheres, lights and
    materials, and for every shadow clamp; the step clamp is compiled in."""
    a, b = instanced_spheres(n=300, device="cpu"), instanced_spheres(n=10_000, seed=3, device="cpu")
    clamp2 = RenderConfig(step_clamp=2.0)
    src = generate_eval_source(a.structure, clamp2)
    assert src == generate_eval_source(b.structure, clamp2.replace(shadow_step_clamp=8.0))
    shard = dataclasses.replace(b.structure, num_spheres=2_501, material_ids=())
    assert src == generate_eval_source(shard, clamp2)
    assert src != generate_eval_source(a.structure, RenderConfig())
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_instanced_eval", "lol_instanced_eval_walk", "lol_instanced_eval_stats"):
        assert f"int {name}(" in entries
    assert entries.count("extern") == 3
    assert (cuda_scene.CSRC / "march.cuh").read_text() in src
    assert (cuda_scene.CSRC / "grid_scene.cuh").read_text() in src


def _eval_points(n=300, seed=5):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([gen.uniform(-50, 50, n), gen.uniform(-2.0, 40, n),
                                      gen.uniform(-90, 10, n)], axis=-1).astype(np.float32))


@pytest.mark.parametrize("case", ["clamp2", "exact", "shard_clamp2", "shard_exact"])
def test_host_built_eval_matches_plain_version(case, tmp_path):
    """instanced:300 (seed 9) at 300 points, the whole set, or the last
    shard of its spheres padded over 11 (eight sentinel spheres of radius
    -1e30 among 28) under the AABB of all real spheres: within 1e-6, and
    bitwise on almost every point. (torch's CPU sqrt is not correctly
    rounded on every input, 1 ulp off where g++'s and nvcc's sqrtf are;
    on the card the kernel is held bitwise, chip_smoke.py phase 26.)"""
    from loltracer_tpu_torch.parallel.objects import pad_spheres_for_sharding

    scene = instanced_spheres(n=300, seed=9, device="cpu")
    clamp = None if case.endswith("exact") else 2.0
    params, structure = scene.params, scene.structure
    tables = pack_eval_tables(params)
    if case.startswith("shard"):
        padded = pad_spheres_for_sharding(params, 11)
        per = padded.sphere_radius.shape[0] // 11
        local = dataclasses.replace(padded, sphere_point=padded.sphere_point[10 * per:],
                                    sphere_radius=padded.sphere_radius[10 * per:])
        assert int((local.sphere_radius < -1e29).sum()) == 8
        structure = dataclasses.replace(structure, num_spheres=per, material_ids=())
        tables = pack_eval_tables(local)._replace(bbox=tables.bbox)
        assert (pack_eval_tables(local).bbox[:3] > tables.bbox[:3]).any()
    cfg = RenderConfig(step_clamp=clamp)
    lib = _build(_SHIM + generate_eval_source(structure, cfg) + _EVAL_ENTRY, tmp_path)
    pts = _eval_points()
    want = instanced_eval_reference(tables, params.plane_y, pts, clamp).numpy()
    got = np.zeros(pts.shape[0], np.float32)
    arrs = [t.numpy() for t in tables]
    lib.host_eval(_ptr(params.plane_y.numpy()), _ptr(arrs[0]), _ptr(arrs[1]), _ptr(arrs[2]),
                  arrs[0].shape[0], arrs[1].shape[0], _ptr(pts.numpy()), _ptr(got), len(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got == want).mean() >= 0.97


@pytest.mark.parametrize("residuals", [False, True], ids=["render", "train"])
def test_render_pixel_is_bitwise_what_it_was(scene4, residuals, tmp_path):
    """render_pixel with its loops in march_ray / shadow_ray vs the same
    source with the loops inline as before: scene4 with antialiasing at
    12x40, both built for the host; the image and, for the training
    source, the residual planes are bitwise equal."""
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    src = generate_source(scene4.structure, cfg, residuals=residuals)
    assert src.count(_MARCH_CALL) == 1 and src.count(_SHADOW_CALL) == 1
    old = src.replace(_MARCH_CALL, _MARCH_INLINE).replace(_SHADOW_CALL, _SHADOW_INLINE)
    h, w = 12, 40
    cam = camera_pack(scene4.params, h, w, cfg).numpy()
    fields = pack_fields(scene4.structure, scene4.params).numpy()
    planes = 4 + 2 * scene4.structure.num_lights
    outs = []
    for text in (src, old):
        lib = _build(_SHIM + text + _RENDER_ENTRY, tmp_path)
        img = np.zeros((h, w, 3), np.float32)
        res = np.zeros((planes, h, w), np.float32)
        lib.host_render(_ptr(cam), _ptr(fields), _ptr(img), _ptr(res) if residuals else None,
                        h, w)
        outs.append((img, res))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][0].max() > 0


def _cull_scene(examples_dir, name):
    """An example, or tests/test_torch_segment_cull.py's box structure."""
    if name == "box":
        from test_torch_segment_cull import _BOX

        return build_scene(parse_scene(_BOX), device="cpu")
    return build_scene(parse_scene_file(str(examples_dir / name)), device="cpu")


@pytest.mark.parametrize("name,aa", [("scene2.lol", False), ("scene3.lol", False),
                                     ("scene4.lol", True), ("box", False)],
                         ids=["scene2", "scene3", "scene4_aa", "box"])
def test_host_built_shadow_cull_is_bitwise_its_twin(examples_dir, name, aa, tmp_path):
    """K4 under Cfg::shadow_cull and its shadow_cull=False twin, both built
    for the host, on every light's real shadow rays from the plain march's
    hits at 12x40: res and t* bitwise equal, and within the phase-18 rule
    of the plain loops (bitwise but for torch's CPU sqrt, 1 ulp off on
    some inputs); the plain loops with the cull (culled rays started done)
    bitwise without it; some rays culled."""
    scene = _cull_scene(examples_dir, name)
    st = scene.structure
    cfg = RenderConfig(antialias=aa)
    twin_cfg = cfg.replace(shadow_cull=False)
    on = _build(_SHIM + generate_march_source(st, cfg) + _COMPILED_ENTRY, tmp_path)
    off = _build(_SHIM + generate_march_source(st, twin_cfg) + _COMPILED_ENTRY, tmp_path)
    scene_m = pack_march_scene(st, scene.params)
    ro, rd = camera_rays(scene.params, 12, 40, cfg)
    m = march_values_reference(st, cfg, ro, rd, scene_m)
    t_sh = torch.where(m.t < cfg.max_dist, m.t, m.t_close) if aa else m.t
    culled = 0
    for li, (so, ld, dist) in enumerate(_shadow_rays(st, scene.params, ro, rd, t_sh, cfg)):
        got = _host_values(on, st, scene_m, so, ld, dist)
        np.testing.assert_array_equal(got, _host_values(off, st, scene_m, so, ld, dist))
        want = [x.numpy() for x in shadow_values_reference(st, cfg, so, ld, dist, scene_m)]
        twin = [x.numpy() for x in shadow_values_reference(st, twin_cfg, so, ld, dist, scene_m)]
        for i, plane in enumerate(("res", "t*")):
            np.testing.assert_array_equal(want[i], twin[i])
            _close(got[i], want[i], f"{plane} of light {li}", atol=5e-5)
        lit = segment_lit(st, scene.params, so, ld, dist, cfg.shadow_w)
        assert (got[0][lit.numpy()] == 1).all() and (got[1][lit.numpy()] == 0).all()
        culled += int(lit.sum())
    assert culled > 0, "no shadow ray of the frame is culled"


def test_march_source_emits_no_bound_over_a_smooth_min_on_a_plane(tmp_path):
    """tests/test_torch_segment_cull.py's smooth-min over a plane: the
    march source carries Cfg::shadow_cull but no Scene::segment_lit, so K4
    culls nothing and its host build is bitwise the twin's."""
    from test_torch_segment_cull import _SMIN_PLANE

    scene = build_scene(parse_scene(_SMIN_PLANE), device="cpu")
    st = scene.structure
    src = generate_march_source(st, RenderConfig())
    assert "shadow_cull = true;" in src
    assert "kHasSegmentBound" not in src.split("namespace lol_gen {", 1)[1]
    twin = generate_march_source(st, RenderConfig(shadow_cull=False))
    assert src.replace("shadow_cull = true;", "shadow_cull = false;") == twin
    cfg = RenderConfig()
    on = _build(_SHIM + src + _COMPILED_ENTRY, tmp_path)
    off = _build(_SHIM + twin + _COMPILED_ENTRY, tmp_path)
    scene_m = pack_march_scene(st, scene.params)
    ro, rd = camera_rays(scene.params, 8, 20, cfg)
    t = march_values_reference(st, cfg, ro, rd, scene_m).t
    for so, ld, dist in _shadow_rays(st, scene.params, ro, rd, t, cfg):
        np.testing.assert_array_equal(_host_values(on, st, scene_m, so, ld, dist),
                                      _host_values(off, st, scene_m, so, ld, dist))


# the warp tile widths march_ray_xy<kTileW> is held to; the entries launch
# cuda_scene.MARCH_TILE_W
_COVER_WIDTHS = (32, 16, 8)

# every thread of a compiled launch over a [rows, width] batch: its ray
# (x, y), or -1 where the kernel masks it
_COVER_ENTRY = r"""
extern "C" long long host_cover(int rows, int width, int tile_w, int* xs, int* ys) {
  int gx, gy, tx, ty;
  lol::march_shape(rows, width, lol::kBlockX, lol::kBlockY, gx, gy, tx, ty);
  long long k = 0;
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx)
      for (int tid = 0; tid < tx * ty; ++tid, ++k) {
        int x, y;
        switch (tile_w) {
%s
          default: return -1;
        }
        const bool in = x < width && y < rows;
        xs[k] = in ? x : -1;
        ys[k] = in ? y : -1;
      }
  return k;
}
""" % "\n".join(f"          case {w}: lol::march_ray_xy<{w}>(rows, bx, by, tid, x, y); break;"
                for w in _COVER_WIDTHS)


@pytest.fixture(scope="module")
def cover_lib(scene4, tmp_path_factory):
    text = _SHIM + generate_march_source(scene4.structure, RenderConfig()) + _COVER_ENTRY
    return _build(text, tmp_path_factory.mktemp("cover"))


@pytest.mark.parametrize("rows,width", [(13, 37), (1, 97), (40, 8), (8, 256), (1, 1), (33, 1)])
@pytest.mark.parametrize("tile_w", _COVER_WIDTHS)
def test_march_tile_covers_each_ray_once(cover_lib, rows, width, tile_w):
    """The compiled launch (march_shape's grid, march_ray_xy's mapping) over
    a ragged [rows, width] batch: each ray taken by exactly one thread, the
    rest masked; in a batch of rows each warp's rays lie in one tile of
    tile_w x 32 / tile_w, in a one-row batch 32 consecutive rays."""
    cap = (-(-width // 32) + 8) * (-(-rows // 8) + 1) * 256
    xs, ys = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    k = cover_lib.host_cover(rows, width, tile_w, _ptr(xs), _ptr(ys))
    assert 0 < k <= cap and k % 32 == 0
    xs, ys = xs[:k], ys[:k]
    hits = np.zeros((rows, width), np.int64)
    live = xs >= 0
    np.add.at(hits, (ys[live], xs[live]), 1)
    assert (hits == 1).all()
    for wx, wy in zip(xs.reshape(-1, 32), ys.reshape(-1, 32)):
        on = wx >= 0
        if not on.any():
            continue
        span = (wx[on].max() - wx[on].min() + 1, wy[on].max() - wy[on].min() + 1)
        assert span[0] <= (32 if rows == 1 else tile_w) and span[1] <= (1 if rows == 1 else 32 // tile_w)


def test_march_wrappers_check_their_options_and_inputs(scene4):
    """lanes names an instanced width of MARCH_LANES on an instanced
    structure, else the wrappers raise, on any device; on CPU tensors the
    wrappers take the plain version (bitwise) and launch nothing; a launch
    refuses tensors off the card or of another shape before it starts."""
    from loltracer_tpu_torch.render.march_kernels import march_values, shadow_values

    st, cfg = scene4.structure, RenderConfig()
    inst = instanced_spheres(n=4, device="cpu")
    scene = pack_march_scene(st, scene4.params)
    ro, rd = camera_rays(scene4.params, 4, 6, cfg)
    dist = torch.full(rd.shape[:-1], 5.0)
    before = dict(march_kernels.launches)
    for a, b in zip(march_values(st, cfg, ro, rd, scene),
                    march_values_reference(st, cfg, ro, rd, scene)):
        assert torch.equal(a, b)
    for a, b in zip(shadow_values(st, cfg, ro + rd, rd, dist, scene),
                    shadow_values_reference(st, cfg, ro + rd, rd, dist, scene)):
        assert torch.equal(a, b)
    assert march_kernels.launches == before
    inst_scene = pack_march_scene(inst.structure, inst.params)
    for call in (lambda: march_values(st, cfg, ro, rd, scene, lanes=32),
                 lambda: shadow_values(st, cfg, ro + rd, rd, dist, scene, lanes=1),
                 lambda: march_values(inst.structure, cfg, ro, rd, inst_scene, lanes=4)):
        with pytest.raises(ValueError):
            call()
    entry = march_kernels._Entry(None, "lol_march", cuda_scene.packed_size(st))
    bad = scene._replace(fields=scene.fields[:-1])
    for args in ((scene, ro, rd, None), (bad, ro, rd, None), (scene, ro, rd, dist),
                 (scene, ro.double(), rd, None)):
        with pytest.raises(ValueError):
            march_kernels._launch(entry, st, *args, 4)
    assert march_kernels.launches == before
