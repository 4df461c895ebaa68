"""The exact soft shadow on the card, on a machine without CUDA: K4x
(`lol_exact_shadow`) and K4xb (`lol_exact_shadow_bwd`), their plain
versions and the renderer's route to them.

- `exact_shadow_reference` (K4xb's plain version, the reverse sweep in
  torch ops) against autograd through `shading.shadow_march`, the "exact"
  estimator's loop: the cotangents of ro, rd and the packed buffer on the
  real shadow rays of each light of scene4 and of a small box and
  smooth-min scene, and on rays built for the loop's quirks (step 0's
  +/-inf, the res < -1 exit, a stop at max_dist, a tie of a value with the
  running minimum, rays done from the start);
- `ExactShadow` through `make_cuda_exact_shadow` on CPU tensors (its plain
  versions) against the loop, to ro, rd and every SceneParams field;
- csrc/exact_shadow.cuh's per-ray functions, built for the host with g++
  (the shim of tests/test_torch_march_host.py), against the plain
  versions, K4xb's ray mapping over ragged batches, and its grid with the
  accumulators in global memory on a scene whose geometry outgrows shared
  memory;
- the generated source and its entries, `_march_kernels`' route (the
  kernels for exact shadows on a compiled structure on the card, the loop
  everywhere else) and the counters `shading.exact_kernel` /
  `shading.exact_loop`.

The kernels themselves run only on the card
(chip_tests/test_exact_shadow_chip.py)."""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
from loltracer_tpu_torch.render import cuda_scene, torch_renderer
from loltracer_tpu_torch.render.camera import camera_rays
from loltracer_tpu_torch.render.cuda_scene import (
    EXACT_SHADOW,
    EXACT_SHADOW_BLOCKS,
    EXACT_SHADOW_BWD,
    EXACT_SHADOW_SCRATCH,
    generate_exact_shadow_source,
    generate_march_source,
)
from loltracer_tpu_torch.render.march_kernels import (
    MarchScene,
    _scene_params,
    exact_shadow_reference,
    make_cuda_exact_shadow,
    march_values_reference,
    pack_march_scene,
    shadow_values_reference,
)
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import segment_lit, shadow_march
from loltracer_tpu_torch.render.vecmath import dot, normalize
from loltracer_tpu_torch.scene import FIELDS, SceneParams, build_scene
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils import tracing

torch.set_num_threads(1)  # one intra-op thread per pytest worker

# a box, a smooth-min of two spheres and a plane, two lights
_BOX_SMIN = """
materials {
  { shininess = 0, diffuse = (0, 0, 0), specular = (0, 0, 0), ambient = (0, 0, 0) },
  { shininess = 8, diffuse = (0.5, 0.4, 0.3), specular = (0.2, 0.2, 0.2), ambient = (0.1, 0.1, 0.1) }
}
scene {
  ambient { color = (0.1, 0.1, 0.1) },
  camera { point = (0, 1.5, 3), direction = (0, -0.3, -1), fov = 90 },
  point_light { point = (-2, 6, -1), diffuse_intensity = (1, 1, 1), specular_intensity = (1, 1, 1) },
  point_light { point = (4, 3, 1), diffuse_intensity = (0.5, 0.5, 0.5), specular_intensity = (0.5, 0.5, 0.5) },
  box { point = (-1.5, 0.2, -3), point2 = (0.9, 0.7, 0.6), radius = 0.1, material = #1 },
  smooth-union { smoothness = 0.6, material = #1,
    a = sphere { point = (1.2, 0.4, -3.5), radius = 0.7 },
    b = sphere { point = (1.9, 1.1, -4), radius = 0.5 } },
  plane { y = -1, material = #1 }
}
"""

_SHIM = r"""
#include <cstddef>
#define __device__
#define __host__
#define __forceinline__ inline
#define __ldg(p) (*(p))
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
"""

# per ray i of n: K4x's res, then K4xb's cotangents, the geometry's summed
# into gP over the rays in order
_EXACT_ENTRY = r"""
using lol_gen::Cfg;
using lol_gen::Scene;

extern "C" void host_exact(const float* P, const float* so, const float* l, const float* md,
                           const float* g, float* res, float* g_so, float* g_l, float* gP,
                           int n) {
  const Scene scn(P);
  const lol::ExactArgs a{so, l, md, g, g_so, g_l};
  for (size_t i = 0; i < (size_t)n; ++i) {
    res[i] = lol::exact_shadow_ray<Cfg>(scn, so[3 * i], so[3 * i + 1], so[3 * i + 2], l[3 * i],
                                        l[3 * i + 1], l[3 * i + 2], md[i]);
    lol::exact_bwd_at<Cfg>(scn, a, i, gP);
  }
}

// K4xb's tiles over a [rows, width] batch: thread tid of tile b, k = b * 128
// + tid, takes ray (xs[k], ys[k]), or -1 where the kernel masks it
extern "C" long long host_cover(int rows, int width, int* xs, int* ys) {
  const int tiles = lol::exact_bwd_tiles(rows, width);
  long long k = 0;
  for (int b = 0; b < tiles; ++b)
    for (int tid = 0; tid < lol::kExactThreads; ++tid, ++k) {
      int x, y;
      lol::exact_ray_xy(rows, width, b, tid, x, y);
      const bool in = x < width && y < rows;
      xs[k] = in ? x : -1;
      ys[k] = in ? y : -1;
    }
  return k;
}

// `blocks` blocks walking the tiles: ray i is taken hits[i] times, last by
// thread tid of block b, owner[i] = b * 128 + tid
extern "C" void host_walk(int rows, int width, int blocks, int* owner, int* hits) {
  for (int b = 0; b < blocks; ++b)
    for (int tid = 0; tid < lol::kExactThreads; ++tid)
      lol::exact_thread_rays(rows, width, b, blocks, tid, [&](size_t i) {
        owner[i] = b * lol::kExactThreads + tid;
        ++hits[i];
      });
}

extern "C" int host_shared() { return lol::exact_acc_shared<Scene::kNumGeom>(); }
extern "C" int host_blocks(int rows, int width) {
  return lol::exact_bwd_blocks<Scene::kNumGeom>(rows, width);
}
extern "C" long long host_scratch(int rows, int width) {
  return lol::exact_bwd_scratch<Scene::kNumGeom>(rows, width);
}

// K4xb's grid over a [rows, width] batch with its accumulators in global
// memory, one thread after another: each block's columns cols [N][128]
// zeroed, each thread's rays into its column, then the block's column sums
// into its row of partials [blocks][N]
extern "C" void host_exact_grid(const float* P, const float* so, const float* l,
                                const float* md, const float* g, float* g_so, float* g_l,
                                float* cols, float* partials, int rows, int width) {
  constexpr int N = Scene::kNumGeom;
  const Scene scn(P);
  const lol::ExactArgs a{so, l, md, g, g_so, g_l};
  const int blocks = lol::exact_bwd_blocks<N>(rows, width);
  for (int b = 0; b < blocks; ++b) {
    for (size_t j = 0; j < (size_t)N * lol::kExactThreads; ++j) cols[j] = 0.f;
    for (int tid = 0; tid < lol::kExactThreads; ++tid) {
      const lol::StridedAcc<lol::kExactThreads> acc{cols + tid};
      lol::exact_thread_rays(rows, width, b, blocks, tid,
                             [&](size_t i) { lol::exact_bwd_at<Cfg>(scn, a, i, acc); });
    }
    for (int tid = 0; tid < lol::kExactThreads; ++tid)
      lol::exact_column_sums<N>(cols, partials + (size_t)b * N, tid);
  }
}
"""


def _build(text, tmp_path):
    """`text` built for the host (g++, IEEE arithmetic without contraction,
    as nvcc's --fmad=false)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the generated CUDA source needs it")
    stem = "exact_host_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    src = tmp_path / f"{stem}.cpp"
    src.write_text(text)
    so = tmp_path / f"{stem}.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def scenes(examples_dir):
    return {"scene4": build_scene(parse_scene_file(str(examples_dir / "scene4.lol")),
                                  device="cpu"),
            "box_smin": build_scene(parse_scene(_BOX_SMIN), device="cpu")}


def _shadow_rays(scene, cfg, h, w):
    """Per light, the shadow rays of the plain march's shading points at
    h x w: (origin, direction, distance to the light), contiguous."""
    st, params = scene.structure, scene.params
    ro, rd = camera_rays(params, h, w, cfg)
    m = march_values_reference(st, cfg, ro, rd, pack_march_scene(st, params))
    t_sh = torch.where(m.t < cfg.max_dist, m.t, m.t_close) if cfg.antialias else m.t
    p = ro + t_sh[..., None] * rd
    out = []
    for li in range(st.num_lights):
        to_light = params.light_point[li] - p
        ld = normalize(to_light)
        out.append(tuple(x.contiguous() for x in (
            p + ld * cfg.shadow_offset, ld, torch.sqrt(dot(to_light, to_light)))))
    return out


def _loop_grads(structure, cfg, so, ld, dist, fields, g_res):
    """(res, g_so, g_ld, g_fields) of autograd through the plain exact loop
    (no cull) over the packed buffer's SceneParams views."""
    f = fields.detach().clone().requires_grad_(True)
    so_ = so.detach().clone().requires_grad_(True)
    ld_ = ld.detach().clone().requires_grad_(True)
    res, _ = shadow_march(make_scene_sdf(structure), _scene_params(structure, MarchScene(f, None)),
                          so_, ld_, dist, cfg)
    (res * g_res).sum().backward()
    return res.detach(), so_.grad, ld_.grad, f.grad


def _near(got, want, what, rtol=2e-4):
    """Within rtol of want's largest magnitude, elementwise."""
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (what, err, scale)


def _check_against_loop(structure, cfg, so, ld, dist, fields, g_res, rtol=2e-4):
    res, *want = _loop_grads(structure, cfg, so, ld, dist, fields, g_res)
    got = exact_shadow_reference(structure, cfg, so, ld, dist, fields, g_res)
    for name, a, b in zip(("g_ro", "g_rd", "g_fields"), got, want):
        _near(a, b, name, rtol)
    return res, got


@pytest.mark.parametrize("name", ["scene4", "box_smin"])
def test_reference_matches_autograd_through_the_loop(scenes, name):
    """On each light's real shadow rays (AA, 8 x 12, a seeded cotangent):
    the reverse sweep's cotangents of ro, rd and the packed buffer are
    autograd's through the uncull'd loop; the rays the cull takes are
    among them (the loop gives them nothing either), and the sweep with
    the cull off gives the same."""
    scene = scenes[name]
    st = scene.structure
    cfg = RenderConfig(antialias=True)
    fields = pack_march_scene(st, scene.params).fields
    culled = 0
    for li, (so, ld, dist) in enumerate(_shadow_rays(scene, cfg, 8, 12)):
        g = torch.randn(dist.shape, generator=torch.Generator().manual_seed(li))
        _, got = _check_against_loop(st, cfg, so, ld, dist, fields, g)
        lit = segment_lit(st, scene.params, so, ld, dist, cfg.shadow_w)
        assert (got[0][lit] == 0).all() and (got[1][lit] == 0).all()
        culled += int(lit.sum())
        off = exact_shadow_reference(st, cfg.replace(shadow_cull=False), so, ld, dist, fields, g)
        for a, b in zip(got, off):
            _near(a, b, "cull off")
    assert culled > 0, "no shadow ray is culled"


def test_reference_float64_total(scenes):
    """exact_shadow_reference's `sum_dtype` total (each ray's term of each
    step alone, by torch.func.vmap, summed in that dtype): on one ray at a
    time with float32 sums it is the plain sweep's g_fields bitwise, so each
    term is the plain sweep's; over a batch with float64 sums, g_ro and g_rd
    are the plain sweep's bitwise and g_fields is float64."""
    scene = scenes["scene4"]
    st = scene.structure
    cfg = RenderConfig(antialias=True)
    fields = pack_march_scene(st, scene.params).fields
    so, ld, dist = _shadow_rays(scene, cfg, 4, 6)[1]
    g = torch.randn(dist.shape, generator=torch.Generator().manual_seed(3))
    seen = 0
    for y, x in ((0, 1), (1, 4), (2, 2), (3, 5)):
        one = [t[y:y + 1, x:x + 1] for t in (so, ld, dist, g)]
        a = exact_shadow_reference(st, cfg, *one[:3], fields, one[3])
        b = exact_shadow_reference(st, cfg, *one[:3], fields, one[3], sum_dtype=torch.float32)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        seen += int(a[2].abs().sum() > 0)
    assert seen >= 2
    a = exact_shadow_reference(st, cfg, so, ld, dist, fields, g)
    b = exact_shadow_reference(st, cfg, so, ld, dist, fields, g, sum_dtype=torch.float64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert b[2].dtype == torch.float64 and b[2].shape == fields.shape


def _quirk_rays():
    """Rays of the box and smooth-min scene, one per quirk of the loop, in
    two groups with their configs. Under the default w = 50, without the
    segment cull (whose bound takes l to be unit): 0 starts inside the box
    (step 0's -inf, the hard zero at once); 1 and 2 run at |l| = 1.5 into
    the box and the spheres, overshooting (a value below -1 at t > 0 ends
    them); 3 takes a zero cotangent; 4 and 5 ordinary rays toward the
    lights. Under w = 1: 6 stops at max_dist after three steps;
    7 runs level 0.3 above the plane, far from the rest, so that its step 1
    value w d / t is exactly the running minimum 1 (a tie) and max_dist
    ends it there."""
    ld = normalize(torch.tensor([[0.0, 1.0, 0.0], [0.0, -0.1, -1.0], [0.0, 0.0, -1.0],
                                 [0.0, 1.0, 0.0], [-0.3, 1.0, 0.2], [0.1, 1.0, 0.8],
                                 [0.2, -1.0, 0.1], [1.0, 0.0, 0.0]]))
    ld[1:3] = ld[1:3] * 1.5
    so = torch.tensor([[-1.5, 0.2, -3.0], [-1.5, 0.5, 0.5], [1.2, 0.4, -1.0],
                       [0.0, 0.5, -1.0], [0.3, -0.9, -2.0], [-0.5, 0.1, -5.0],
                       [0.0, 2.0, -3.0], [8.0, -0.7, 8.0]])
    dist = torch.tensor([50.0, 50.0, 50.0, 50.0, 30.0, 30.0, 2.0, 0.5])
    g = torch.tensor([1.0, 1.0, -0.7, 0.0, 0.9, -1.1, 0.8, 1.3])
    return [(RenderConfig(shadow_cull=False), so[:6], ld[:6], dist[:6], g[:6]),
            (RenderConfig(shadow_w=1.0), so[6:], ld[6:], dist[6:], g[6:])]


def test_reference_matches_the_loop_on_its_quirks(scenes):
    """The rays of _quirk_rays: each quirk occurs in the loop's values, and
    the reverse sweep's cotangents are autograd's: nothing for the ray that
    starts inside and for the zero cotangent's, half the cotangent through
    the tie."""
    scene = scenes["box_smin"]
    st = scene.structure
    fields = pack_march_scene(st, scene.params).fields
    sdf = make_scene_sdf(st)
    (cfg, so, ld, dist, g), (cfg1, so1, ld1, dist1, g1) = _quirk_rays()
    res, (g_ro, _, _) = _check_against_loop(st, cfg, so, ld, dist, fields, g)
    d0 = sdf(scene.params, so)
    assert res[0] == -float("inf") and d0[0] < 0
    assert (res[1:3] < -1).all() and (d0[1:3] > 0).all()
    assert (g_ro[0] == 0).all() and (g_ro[3] == 0).all()
    assert (g_ro[1:3] != 0).any(dim=-1).all()
    res1, (g_ro1, g_rd1, _) = _check_against_loop(st, cfg1, so1, ld1, dist1, fields, g1)
    steps = []
    shadow_march(sdf, scene.params, so1[:1], ld1[:1], dist1[:1], cfg1, live=steps)
    assert -1 < res1[0] < 1 and len(steps) == 3
    # the tie: step 1's value is exactly 1.0, and half the cotangent reaches it
    d = float(sdf(scene.params, so1[1:]))
    assert res1[1] == 1 and cfg1.shadow_w * d / d == 1.0
    assert float(g_rd1[1, 1]) == pytest.approx(0.5 * float(g1[1]), rel=1e-5)


@pytest.mark.parametrize("name", ["scene4", "box_smin"])
def test_exact_shadow_function_matches_the_loop_in_every_field(scenes, name):
    """make_cuda_exact_shadow on CPU tensors (ExactShadow over its plain
    versions, the packed buffer with its graph): res bitwise the loop's,
    and the gradients of a weighted sum of both lights' penumbrae to ro,
    rd and every SceneParams field those of autograd through the loop."""
    scene = scenes[name]
    st = scene.structure
    cfg = RenderConfig(antialias=True)
    rays = _shadow_rays(scene, cfg, 6, 10)

    def run(kernel):
        leaves = {f: getattr(scene.params, f).detach().clone().requires_grad_(True)
                  for f in FIELDS}
        params = SceneParams(**leaves)
        fn = make_cuda_exact_shadow(st, cfg)
        sdf = make_scene_sdf(st)
        total, outs, ins = 0.0, [], []
        for li, (so, ld, dist) in enumerate(rays):
            so, ld = so.clone().requires_grad_(True), ld.clone().requires_grad_(True)
            if kernel:
                res, t_star = fn(params, so, ld, dist)
                assert t_star is None
            else:
                res, _ = shadow_march(sdf, params, so, ld, dist, cfg)
            g = torch.randn(dist.shape, generator=torch.Generator().manual_seed(7 + li))
            total = total + (torch.clamp(res, min=0.0) * g).sum()
            outs.append(res.detach())
            ins += [so, ld]
        total.backward()
        return outs, [t.grad for t in ins], {f: leaves[f].grad for f in FIELDS}

    res_k, rays_k, fields_k = run(True)
    res_l, rays_l, fields_l = run(False)
    for a, b in zip(res_k, res_l):
        assert torch.equal(a, b)
    for a, b in zip(rays_k, rays_l):
        _near(a, b, "rays")
    for f in FIELDS:
        a, b = fields_k[f], fields_l[f]
        if b is None or not b.numel():
            assert a is None or not a.abs().sum(), f
            continue
        _near(a if a is not None else torch.zeros_like(b), b, f)
    assert any(fields_l[f] is not None and fields_l[f].abs().sum() > 0
               for f in ("sphere_point", "sphere_radius", "plane_y"))


@pytest.mark.parametrize("name", ["scene4", "box_smin"])
def test_host_built_kernels_match_their_plain_versions(scenes, name, tmp_path):
    """csrc/exact_shadow.cuh's per-ray functions built for the host over
    the generated Scene, ray by ray on each light's shadow rays and on the
    quirk rays: K4x's res within the rule of K4's host test (bitwise but
    for torch's CPU sqrt), K4xb's cotangents those of
    exact_shadow_reference; with shadow_cull and without."""
    scene = scenes[name]
    st = scene.structure
    cases = [(RenderConfig(antialias=True), r) for r in _shadow_rays(scene, RenderConfig(
        antialias=True), 6, 10)]
    if name == "box_smin":
        cases += [(cfg, (so, ld, dist)) for cfg, so, ld, dist, _ in _quirk_rays()]
    fields = pack_march_scene(st, scene.params).fields
    libs = {}
    for i, (cfg, (so, ld, dist)) in enumerate(cases):
        for cull in (True, False):
            c = cfg.replace(shadow_cull=cull)
            src = generate_exact_shadow_source(st, c)
            if src not in libs:
                libs[src] = _build(_SHIM + src + _EXACT_ENTRY, tmp_path)
            lib = libs[src]
            g = torch.randn(dist.shape, generator=torch.Generator().manual_seed(i))
            n = dist.numel()
            arrays = [t.contiguous().numpy() for t in (fields, so, ld, dist, g)]
            res = np.zeros(n, np.float32)
            g_so, g_ld = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
            g_f = np.zeros(fields.numel(), np.float32)
            lib.host_exact(*[_ptr(a) for a in arrays], _ptr(res), _ptr(g_so), _ptr(g_ld),
                           _ptr(g_f), n)
            want = shadow_values_reference(st, c, so, ld, dist, MarchScene(fields, None))[0]
            want = want.numpy().reshape(-1)
            with np.errstate(invalid="ignore"):
                bad = ~((res == want) | (np.abs(res - want) <= 5e-5 + 1e-4 * np.abs(want)))
            assert bad.sum() <= 2, int(bad.sum())
            ref = exact_shadow_reference(st, c, so, ld, dist, fields, g)
            for what, got, exp in zip(("g_ro", "g_rd", "g_fields"), (g_so, g_ld, g_f), ref):
                _near(torch.from_numpy(got), exp.reshape(got.shape), what, rtol=1e-3)


@pytest.mark.parametrize("rows,width", [(13, 37), (1, 97), (40, 8), (8, 256), (1, 1), (33, 1)])
def test_exact_bwd_blocks_cover_each_ray_once(scenes, rows, width, tmp_path_factory):
    """K4xb's launch (exact_bwd_tiles, exact_ray_xy) over a ragged [rows,
    width] batch: each ray taken by exactly one thread, the rest masked;
    each warp's rays within an 8 x 4 tile, a one-row batch's 32
    consecutive rays. Blocks fewer than the tiles walking them
    (exact_thread_rays, the global accumulators' grid) take each ray once
    too, by the same thread of its tile."""
    text = _SHIM + generate_exact_shadow_source(scenes["box_smin"].structure,
                                                RenderConfig()) + _EXACT_ENTRY
    lib = _build(text, tmp_path_factory.mktemp("cover"))
    cap = ((-(-width // 32)) * (-(-rows // 4)) + -(-width // 128)) * 128
    xs, ys = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    k = lib.host_cover(rows, width, _ptr(xs), _ptr(ys))
    assert 0 < k <= cap and k % 128 == 0
    assert lib.host_shared() == 1 and lib.host_blocks(rows, width) == k // 128
    xs, ys = xs[:k], ys[:k]
    hits = np.zeros((rows, width), np.int64)
    live = xs >= 0
    np.add.at(hits, (ys[live], xs[live]), 1)
    assert (hits == 1).all()
    for wx, wy in zip(xs.reshape(-1, 32), ys.reshape(-1, 32)):
        on = wx >= 0
        if on.any():
            span = (wx[on].max() - wx[on].min() + 1, wy[on].max() - wy[on].min() + 1)
            assert span[0] <= (32 if rows == 1 else 8) and span[1] <= (1 if rows == 1 else 4)
    tid = np.full((rows, width), -1)
    tid[ys[live], xs[live]] = np.nonzero(live)[0] % 128
    for blocks in {1, 3, k // 128}:
        owner = np.zeros(rows * width, np.int32)
        walked = np.zeros(rows * width, np.int32)
        lib.host_walk(rows, width, blocks, _ptr(owner), _ptr(walked))
        assert (walked == 1).all()
        assert (owner % 128 == tid.reshape(-1)).all()


def _sphere_field(n):
    """A compiled scene of n spheres on a grid above a plane, two lights."""
    spheres = ",\n".join(
        f"  sphere {{ point = ({(i % 12) * 0.6 - 3.3:.2f}, {0.3 + 0.25 * (i % 3):.2f}, "
        f"{-2.0 - (i // 12) * 0.6:.2f}), radius = {0.18 + 0.02 * (i % 4):.2f}, material = #1 }}"
        for i in range(n))
    text = _BOX_SMIN.split("  box {", 1)[0] + spheres + ",\n  plane { y = -1, material = #1 }\n}\n"
    return build_scene(parse_scene(text), device="cpu")


def test_large_scene_accumulates_in_global_memory(scenes, tmp_path):
    """A compiled scene whose geometry prefix outgrows a block's shared
    memory (112 spheres and a plane: 449 slots): exact_acc_shared is false,
    the grid is at most 528 blocks with a scratch of blocks x slots x 128
    floats (0 for scene4); K4xb's global-accumulator path run on the host
    (each thread's column, each block's column sums by its tree, the
    blocks' rows summed) gives exact_shadow_reference's cotangents on each
    light's shadow rays, with the cull and without."""
    big = _sphere_field(112)
    st = big.structure
    assert cuda_scene.geom_size(st) == 449
    small = _build(_SHIM + generate_exact_shadow_source(scenes["scene4"].structure,
                                                        RenderConfig()) + _EXACT_ENTRY, tmp_path)
    assert small.host_shared() == 1 and small.host_scratch(1080, 1920) == 0
    fields = pack_march_scene(st, big.params).fields
    n_geom = cuda_scene.geom_size(st)
    for cull in (True, False):
        cfg = RenderConfig(antialias=True, shadow_steps=48, shadow_cull=cull)
        lib = _build(_SHIM + generate_exact_shadow_source(st, cfg) + _EXACT_ENTRY, tmp_path)
        lib.host_scratch.restype = ctypes.c_longlong
        assert lib.host_shared() == 0
        assert lib.host_blocks(1080, 1920) == 528 and lib.host_blocks(8, 64) == 4
        assert lib.host_scratch(1080, 1920) == 528 * n_geom * 128
        for li, (so, ld, dist) in enumerate(_shadow_rays(big, cfg, 8, 32)):
            g = torch.randn(dist.shape, generator=torch.Generator().manual_seed(li))
            rows, width = dist.shape
            blocks = lib.host_blocks(rows, width)
            cols = np.zeros(n_geom * 128, np.float32)
            partials = np.zeros((blocks, n_geom), np.float32)
            g_so, g_ld = np.zeros((rows, width, 3), np.float32), np.zeros((rows, width, 3),
                                                                         np.float32)
            arrays = [t.contiguous().numpy() for t in (fields, so, ld, dist, g)]
            lib.host_exact_grid(*[_ptr(a) for a in arrays], _ptr(g_so), _ptr(g_ld), _ptr(cols),
                                _ptr(partials), rows, width)
            ref = exact_shadow_reference(st, cfg, so, ld, dist, fields, g)
            got = (g_so, g_ld, np.concatenate([partials.sum(0), np.zeros(
                fields.numel() - n_geom, np.float32)]))
            for what, a, b in zip(("g_ro", "g_rd", "g_fields"), got, ref):
                _near(torch.from_numpy(a), b, f"{what} light {li} cull {cull}", rtol=1e-3)
            assert ref[2][:n_geom].abs().sum() > 0


def test_exact_source_entries_and_determinism(scenes):
    """The generated exact source: deterministic, both entries (and the
    block count) after `#ifdef __CUDACC__`, the SDF adjoint and, under
    shadow_cull, the segment bound in its Scene; K3 / K4's source carries
    none of it; an instanced structure is refused."""
    st = scenes["scene4"].structure
    src = generate_exact_shadow_source(st, RenderConfig())
    assert src == generate_exact_shadow_source(st, RenderConfig())
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in (EXACT_SHADOW, EXACT_SHADOW_BWD, EXACT_SHADOW_BLOCKS):
        assert f'extern "C" int {name}(' in entries
    assert f'extern "C" long long {EXACT_SHADOW_SCRATCH}(' in entries
    scene_part = src.split("namespace lol_gen {", 1)[1]
    assert "dist_bwd" in scene_part and "segment_lit" in scene_part
    twin = generate_exact_shadow_source(st, RenderConfig(shadow_cull=False))
    assert "segment_lit" not in twin.split("namespace lol_gen {", 1)[1]
    march = generate_march_source(st, RenderConfig())
    assert EXACT_SHADOW not in march and "exact_shadow_kernel" not in march
    with pytest.raises(NotImplementedError):
        generate_exact_shadow_source(instanced_spheres(n=4, device="cpu").structure,
                                     RenderConfig())
    with pytest.raises(NotImplementedError):
        make_cuda_exact_shadow(instanced_spheres(n=4, device="cpu").structure, RenderConfig())


def _kernels_on_the_cpu(monkeypatch):
    """Sends the renderer's marches to the kernels' wrappers on CPU
    tensors, where they run their plain versions."""
    monkeypatch.setattr(torch_renderer, "resolve_march_backend",
                        lambda backend, *t: "jnp" if backend == "jnp" else "pallas")


def _fn_name(fn):
    return None if fn is None else fn.func.__qualname__


def test_march_kernels_route_exact_shadows(scenes, monkeypatch):
    """_march_kernels where the backend resolves to the kernels: K4x / K4xb
    for exact shadows on a compiled structure, K4 for envelope ones, the
    loop for an instanced structure's exact shadows; the loops everywhere
    under "jnp" (and on CPU tensors); live-ray counting refused."""
    sc = scenes["box_smin"]
    inst = instanced_spheres(n=4, device="cpu")
    rd = torch.zeros(2, 3)
    exact, envelope = RenderConfig(), RenderConfig(shadow_grad="envelope")
    assert torch_renderer._march_kernels(sc.structure, sc.params, rd, exact, None, None) == (
        None, None)
    _kernels_on_the_cpu(monkeypatch)
    route = torch_renderer._march_kernels
    params = SceneParams(**{f: getattr(sc.params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    march_fn, fn = route(sc.structure, params, rd, exact, None, None)
    assert _fn_name(fn) == "make_cuda_exact_shadow.<locals>.shadow_fn"
    assert fn.keywords["fields"].requires_grad  # the buffer keeps its graph
    assert not march_fn.keywords["scene"].fields.requires_grad
    _, fn = route(sc.structure, sc.params, rd, envelope, None, None)
    assert _fn_name(fn) == "make_cuda_shadow_march.<locals>.shadow_fn"
    march_fn, fn = route(inst.structure, inst.params, rd, exact, None, None)
    assert fn is None and march_fn is not None
    assert route(sc.structure, sc.params, rd, exact.replace(march_backend="jnp"), None,
                 None) == (None, None)
    with pytest.raises(ValueError):
        route(sc.structure, sc.params, rd, exact, {"shadow": []}, None)


def _counts():
    c = tracing.counters()
    return c["shading.exact_kernel"], c["shading.exact_loop"]


def test_counters_and_the_routed_render(scenes, monkeypatch):
    """shading.exact_kernel / shading.exact_loop count each light's exact
    march by its route: the loop on CPU tensors and under an `sdf`
    override, the kernels' route where the backend resolves to them; the
    routed render (K3's and K4x / K4xb's plain versions) gives the loop's
    image and, within float32's order of summation, its gradient in every
    field."""
    sc = scenes["box_smin"]
    st = sc.structure
    cfg = RenderConfig(antialias=True)
    L = st.num_lights

    def grads():
        leaves = {f: getattr(sc.params, f).detach().clone().requires_grad_(True)
                  for f in FIELDS}
        img = torch_renderer.render_image(st, SceneParams(**leaves), 6, 8, cfg)
        img.pow(2).sum().backward()
        return img.detach(), {f: leaves[f].grad for f in FIELDS}

    k0, l0 = _counts()
    img_l, g_l = grads()
    assert _counts() == (k0, l0 + L)
    ro, rd = camera_rays(sc.params, 2, 3, cfg)
    with torch.no_grad():
        torch_renderer.render_rays(st, sc.params, ro, rd, cfg, sdf=make_scene_sdf(st))
    assert _counts() == (k0, l0 + 2 * L)
    _kernels_on_the_cpu(monkeypatch)
    img_k, g_k = grads()
    assert _counts() == (k0 + L, l0 + 2 * L)
    assert torch.equal(img_k, img_l)
    for f in FIELDS:
        if g_l[f] is not None and g_l[f].numel():
            _near(g_k[f], g_l[f], f, rtol=1e-3)
    assert "shading" in tracing._sources
