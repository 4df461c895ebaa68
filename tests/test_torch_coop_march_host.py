"""Host side of the lane-group instanced march kernels K3i / K4i
(`lol_march_instanced`, `lol_shadow_march_instanced` at a group of lanes a
ray, csrc/coop_march.cuh), on a machine without CUDA:

- the width rule `march_kernels.lanes_for` (a pure function of the ray
  count and the SM count) and the generated entries' width dispatch;
- the order key of the group min (`order_key` / `key_value`): a total
  order on float bits that agrees with `<` and round-trips;
- `CoopInstancedScene`'s traversal, compiled for the host with g++
  through the shim of tests/test_torch_march_host.py, its group ops a
  loop over the lanes (`HostGroup` below: the ballot's bits, the
  reduction's min of the lanes' order keys): at widths 1, 4, 8 and 32,
  `dist` / `shadow_dist` bitwise `InstancedScene::dist` / `shadow_dist`
  at random points and at points along marched camera rays; and
  `march_at` / `shadow_at` over it, ray by ray,
  bitwise the one-thread-a-ray host build and within the kernels' rule of
  `march_values_reference` / `shadow_values_reference`: instanced:300 at
  clamp 2 and exact, instanced:1, and shadow clamp 8.

The kernels themselves run only on the card (chip_smoke.py phases 17, 18
and 21)."""

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.camera import camera_rays
from loltracer_tpu_torch.render.cuda_scene import MARCH_LANES, generate_march_source
from loltracer_tpu_torch.render.march_kernels import (
    lanes_for,
    march_values_reference,
    pack_march_scene,
    shadow_values_reference,
)
from loltracer_tpu_torch.scenes import instanced_spheres
from test_torch_march_host import _SHIM, _build, _close, _ptr, _shadow_rays

torch.set_num_threads(1)  # one intra-op thread per pytest worker

WIDTHS = (1, 4, 8, 32)

# The group ops of CoopInstancedScene on the host: all K lanes' parts in a
# loop; `min` is __reduce_min_sync's over the lanes' order keys.
_ENTRY = r"""
namespace {
template <int K>
struct HostGroup {
  static constexpr int kLanes = K;
  int lane = 0;

  template <class F>
  unsigned ballot(F pred) const {
    unsigned m = 0;
    for (int l = 0; l < K; ++l)
      if (pred(l)) m |= 1u << l;
    return m;
  }

  template <class F>
  float min(F part) const {
    unsigned k = 0xffffffffu;
    for (int l = 0; l < K; ++l) {
      const unsigned v = lol::order_key(part(l));
      if (v < k) k = v;
    }
    return lol::key_value(k);
  }
};

template <int K>
using Coop = lol::CoopInstancedScene<lol_gen::Layout, lol_gen::Cfg, HostGroup<K>>;

lol::InstancedTables tables(const float* s, const int* ids, const float* g, const float* bbox,
                            int ns, int ng) {
  return lol::InstancedTables{reinterpret_cast<const float4*>(s),
                              reinterpret_cast<const int2*>(ids),
                              reinterpret_cast<const float4*>(g), bbox, ns, ng};
}

template <class S>
void dist_all(const S& scn, int shadow, const float* p, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    const float* q = p + 3 * i;
    out[i] = shadow ? scn.shadow_dist(q[0], q[1], q[2]) : scn.dist(q[0], q[1], q[2]);
  }
}

template <class S>
void march_all(const S& scn, const float* ro, int ro_stride, const float* rd,
               const float* max_dist, float* out, int n) {
  const lol::MarchArgs a{ro, ro_stride, rd, max_dist, out};
  for (size_t i = 0; i < (size_t)n; ++i) {
    if (max_dist) lol::value_at<true, lol_gen::Cfg>(scn, a, i, n, scn.group.lane == 0);
    else lol::value_at<false, lol_gen::Cfg>(scn, a, i, n, scn.group.lane == 0);
  }
}
}  // namespace

// lanes 0: InstancedScene (one thread a ray); else CoopInstancedScene at
// that width. Returns -1 for a width not built here.
#define LOL_WIDTHS(X) X(1) X(4) X(8) X(32)

extern "C" int host_dist(int lanes, int shadow, const float* P, const float* s, const int* ids,
                         const float* g, const float* bbox, int ns, int ng, const float* p,
                         float* out, int n) {
  const lol::InstancedTables tab = tables(s, ids, g, bbox, ns, ng);
  const float4* grp = reinterpret_cast<const float4*>(g);
  if (lanes == 0) {
    dist_all(lol_gen::Scene(P, tab, grp), shadow, p, out, n);
    return 0;
  }
#define LOL_CASE(K) \
  if (lanes == K) {  \
    dist_all(Coop<K>(P, tab, grp, HostGroup<K>{}), shadow, p, out, n); \
    return 0; \
  }
  LOL_WIDTHS(LOL_CASE)
#undef LOL_CASE
  return -1;
}

extern "C" int host_march(int lanes, const float* P, const float* s, const int* ids,
                          const float* g, const float* bbox, int ns, int ng, const float* ro,
                          int ro_stride, const float* rd, const float* max_dist, float* out,
                          int n) {
  const lol::InstancedTables tab = tables(s, ids, g, bbox, ns, ng);
  const float4* grp = reinterpret_cast<const float4*>(g);
  if (lanes == 0) {
    const lol_gen::Scene scn(P, tab, grp);
    const lol::MarchArgs a{ro, ro_stride, rd, max_dist, out};
    for (size_t i = 0; i < (size_t)n; ++i) {
      if (max_dist) lol::value_at<true, lol_gen::Cfg>(scn, a, i, n);
      else lol::value_at<false, lol_gen::Cfg>(scn, a, i, n);
    }
    return 0;
  }
#define LOL_CASE(K) \
  if (lanes == K) {  \
    march_all(Coop<K>(P, tab, grp, HostGroup<K>{}), ro, ro_stride, rd, max_dist, out, n); \
    return 0; \
  }
  LOL_WIDTHS(LOL_CASE)
#undef LOL_CASE
  return -1;
}
"""

CFGS = {
    "clamp2": RenderConfig(step_clamp=2.0),
    "exact": RenderConfig(),
    "shadow_clamp8": RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0),
}

_libs = {}


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("coop_march_host")


def _lib(cfg_name, scene, build_dir):
    """The host build of the march source of cfg_name (one text for every
    sphere count) with the entries above, built once per module."""
    if cfg_name not in _libs:
        src = generate_march_source(scene.structure, CFGS[cfg_name])
        _libs[cfg_name] = _build(_SHIM + src + _ENTRY, build_dir)
    return _libs[cfg_name]


def _scene(n):
    return instanced_spheres(n=n, seed=9, device="cpu")


def _table_args(scene):
    ms = pack_march_scene(scene.structure, scene.params)
    tabs = [t.numpy() for t in ms.tables]
    return ms, [_ptr(ms.fields.numpy()), *[_ptr(t) for t in tabs],
                scene.structure.num_spheres, ms.tables.groups.shape[0]], tabs


def _points(scene, cfg, n_random=400, seed=5):
    """Random points over the sphere field and above it, and points along
    6x10 camera rays at 0, 1/4, 1/2, 3/4 and 1 of the plain march's last
    query point (near the surfaces the march stops at), [N, 3] f32."""
    gen = np.random.default_rng(seed)
    rnd = np.stack([gen.uniform(-50, 50, n_random), gen.uniform(-2.0, 15, n_random),
                    gen.uniform(-90, 10, n_random)], axis=-1)
    ms = pack_march_scene(scene.structure, scene.params)
    ro, rd = camera_rays(scene.params, 6, 10, cfg)
    tq = march_values_reference(scene.structure, cfg, ro, rd, ms).t_query
    frac = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])
    along = ro + (frac[:, None, None, None] * tq[None, ..., None]) * rd[None]
    return np.ascontiguousarray(np.concatenate(
        [rnd.astype(np.float32), along.reshape(-1, 3).numpy()]), dtype=np.float32)


def test_lanes_for_rule():
    """K3: the widest group at every size; K4: the widest group up to
    8192 rays per SM, one thread a ray above. On 132 SMs: a 16-row 1080p
    band and half a frame take the group, a full frame's shadow rays one
    thread a ray."""
    assert MARCH_LANES[0] == 1 and list(MARCH_LANES) == sorted(set(MARCH_LANES))
    assert all(w & (w - 1) == 0 and w <= 32 for w in MARCH_LANES)
    widest = MARCH_LANES[-1]
    band, frame = 16 * 1920, 1920 * 1080
    for n in (1, 100, band, frame // 2, frame, 4 * frame):
        assert lanes_for(n, 132) == widest
        assert lanes_for(n, 132, shadow=True) == (widest if n <= 8192 * 132 else 1)
    assert lanes_for(band, 132, shadow=True) == widest
    assert lanes_for(frame, 132, shadow=True) == 1
    assert lanes_for(frame, 264, shadow=True) == widest  # more SMs: a frame is not enough
    assert lanes_for(8192 * 66 + 1, 66, shadow=True) == 1


_KEY_ENTRY = r"""
extern "C" void host_keys(const float* x, unsigned* key, float* back, int n) {
  for (int i = 0; i < n; ++i) {
    key[i] = lol::order_key(x[i]);
    back[i] = lol::key_value(key[i]);
  }
}
"""


def test_order_key_is_a_total_order_agreeing_with_less(build_dir):
    """order_key over signed values, zeros, denormals and infinities:
    key(a) < key(b) exactly where a < b (and -0 before +0), and key_value
    gives the bits back."""
    scene = _scene(1)
    lib = _build(_SHIM + generate_march_source(scene.structure, CFGS["clamp2"]) + _KEY_ENTRY,
                 build_dir)
    gen = np.random.default_rng(3)
    x = np.concatenate([gen.normal(0, 10, 500), gen.normal(0, 1e-3, 200),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38, -3.4e38]])
    x = np.ascontiguousarray(x, dtype=np.float32)
    key = np.zeros(len(x), np.uint32)
    back = np.zeros(len(x), np.float32)
    lib.host_keys(_ptr(x), _ptr(key), _ptr(back), len(x))
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    less = x[:, None] < x[None, :]
    kless = key[:, None] < key[None, :]
    zeros = (x[:, None] == 0) & (x[None, :] == 0)
    assert (kless == less)[~zeros].all()
    assert key[len(x) - 7] < key[len(x) - 8]  # -0 before +0


def test_march_source_dispatches_every_width():
    scene = _scene(300)
    src = generate_march_source(scene.structure, CFGS["clamp2"])
    entries = src.rsplit("#ifdef __CUDACC__", 1)[1]
    for name in ("lol_march_instanced", "lol_shadow_march_instanced"):
        assert f"int {name}(" in entries
    for w in MARCH_LANES:
        assert entries.count(f"    case {w}:") == 2
    assert entries.count("launch_march_coop<") == 2 * (len(MARCH_LANES) - 1)
    assert entries.count("return (int)cudaErrorInvalidValue;") == 2


@pytest.mark.parametrize("lanes", WIDTHS)
@pytest.mark.parametrize("n", [300, 1], ids=["instanced300", "instanced1"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_coop_distance_is_bitwise_the_sequential_one(cfg_name, n, lanes, build_dir):
    """dist and shadow_dist of the lane group at ~700 points, bitwise
    InstancedScene's."""
    scene = _scene(n)
    lib = _lib(cfg_name, scene, build_dir)
    _, args, _ = _table_args(scene)
    pts = _points(scene, CFGS[cfg_name])
    for shadow in (0, 1):
        want = np.zeros(len(pts), np.float32)
        got = np.zeros(len(pts), np.float32)
        assert lib.host_dist(0, shadow, *args, _ptr(pts), _ptr(want), len(pts)) == 0
        assert lib.host_dist(lanes, shadow, *args, _ptr(pts), _ptr(got), len(pts)) == 0
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(want).all()


def _marches(lib, lanes, scene, ms, args, ro, rd, max_dist):
    """The host build's planes [4 or 2, n] for the rays."""
    n = int(np.prod(rd.shape[:-1]))
    out = np.zeros((4 if max_dist is None else 2, n), np.float32)
    ro_np, rd_np = ro.contiguous().numpy(), rd.contiguous().numpy()
    md = None if max_dist is None else max_dist.contiguous().numpy()
    rc = lib.host_march(lanes, *args, _ptr(ro_np), 0 if ro.dim() == 1 else 3, _ptr(rd_np),
                        None if md is None else _ptr(md), _ptr(out), n)
    assert rc == 0, f"no host build at {lanes} lanes"
    return out


_CASES = {
    "instanced300_clamp2": (300, "clamp2"),
    "instanced300_exact": (300, "exact"),
    "instanced1_clamp2": (1, "clamp2"),
    "instanced300_shadow_clamp8": (300, "shadow_clamp8"),
}
_refs = {}


def _reference(case):
    """The plain loops' K3 planes on 8x20 camera rays and, per light, K4's
    on the shadow rays from those hits, once per case."""
    if case not in _refs:
        n, cfg_name = _CASES[case]
        scene, cfg = _scene(n), CFGS[cfg_name]
        ms = pack_march_scene(scene.structure, scene.params)
        ro, rd = camera_rays(scene.params, 8, 20, cfg)
        k3 = march_values_reference(scene.structure, cfg, ro, rd, ms)
        shadows = []
        for so, ld, dist in _shadow_rays(scene.structure, scene.params, ro, rd, k3.t, cfg):
            shadows.append((so, ld, dist, shadow_values_reference(scene.structure, cfg, so, ld,
                                                                  dist, ms)))
        _refs[case] = (scene, cfg_name, ro, rd, k3, shadows)
    return _refs[case]


@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("case", list(_CASES))
def test_coop_marches_match_plain_loops(case, lanes, build_dir):
    """march_at / shadow_at over the lane group, ray by ray: bitwise the
    one-thread-a-ray host build, and within the kernels' rule (chip_smoke.py
    phase 18) of the plain versions on the camera rays (one origin) and
    on each light's shadow rays (one origin per ray)."""
    scene, cfg_name, ro, rd, k3, shadows = _reference(case)
    lib = _lib(cfg_name, scene, build_dir)
    ms, args, _ = _table_args(scene)
    got = _marches(lib, lanes, scene, ms, args, ro, rd, None)
    seq = _marches(lib, 0, scene, ms, args, ro, rd, None)
    np.testing.assert_array_equal(got.view(np.uint32), seq.view(np.uint32))
    for i, name in enumerate(("t", "t_query", "s_min", "t_close")):
        _close(got[i], k3[i].reshape(-1).numpy(), name)
    assert (got[0] < CFGS[cfg_name].max_dist).any()
    for li, (so, ld, dist, (res, t_star)) in enumerate(shadows):
        got_s = _marches(lib, lanes, scene, ms, args, so, ld, dist)
        seq_s = _marches(lib, 0, scene, ms, args, so, ld, dist)
        np.testing.assert_array_equal(got_s.view(np.uint32), seq_s.view(np.uint32))
        _close(got_s[0], res.reshape(-1).numpy(), f"res of light {li}", atol=5e-5)
        _close(got_s[1], t_star.reshape(-1).numpy(), f"t* of light {li}", atol=5e-5)
