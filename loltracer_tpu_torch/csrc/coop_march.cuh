// lol_march_instanced / lol_shadow_march_instanced with a lane group per
// ray: the instanced value march kernels K3i and K4i.
//
// Replace, with csrc/march.cuh's one-thread-per-ray kernel (one lane a
// ray), `loltracer_tpu/render/pallas_march.py: _march_kernel` (:94, the
// Pallas call `lol_march_instanced`) and `_shadow_kernel` (:111,
// `lol_shadow_march_instanced`) on instanced scenes. The function does not
// change: per ray, csrc/fused_fwd.cuh's `march_ray` (K3i) or `shadow_ray`
// (K4i) over the instanced distance of csrc/instanced_scene.cuh, and the
// result is bitwise that of the one-thread kernel.
//
// What bounds them on this card: FP32 / SFU issue in the traversal (11-12
// runs of 64 spheres visited per distance, each sphere a sqrtf), and, one
// thread a ray, the launch's shape. A 16-row 1080p band is 30 720 rays: one
// thread a ray is 960 warps on 132 SMs, ~7 of the 64 an SM holds, each
// thread's distance one dependent chain (~157 ball tests, then ~750 sphere
// distances), so the band took its slowest warps' chains, ~17x a full
// frame's time per ray; and a warp of 32 rays walks the union of their
// runs.
//
// The design: kLanes lanes of a warp (a power of two) share one ray. Every
// lane holds the same ray state, and the distance below returns the
// bitwise-same value in every lane of the group, so `march_ray` and
// `shadow_ray` run over this Scene unchanged and their `break` is uniform
// across the group; the group's first lane writes the ray's outputs. Inside
// one distance (`dist_under`), per round of kLanes consecutive runs:
//
// - the ball pass: lane l tests run g0 + l against the gate min(u, best) at
//   the round's start, and a ballot over the group's lanes gives the
//   round's candidates (exact mode: u is the group min of the lanes'
//   partial upper bounds);
// - the visited runs: all of the round's candidates at once, each run's
//   kGroup spheres split over the lanes (kGroup / kLanes each, neighbouring
//   lanes on neighbouring rows, float4 loads), and one group min
//   (`__reduce_min_sync`) ends the round. No run is tested again against
//   the best that the round's earlier runs leave: on the chip's scenes that
//   re-test drops ~4 % of the candidates and costs more than their spheres
//   (PERF.md);
// - why the value is InstancedScene::dist_under's, bitwise: `visit` is
//   monotone in the gate (gate + R and its square round monotonically), so
//   every run the sequential loop visits, at its own gate, is a candidate
//   of its round, whose gate is no smaller. A run visited here and skipped
//   there holds no sphere nearer than the best the sequential loop has at
//   that run (that is what its skip rests on: R bounds every member with a
//   margin), so it cannot lower the min, and each round ends on the
//   sequential loop's best after the round's runs. The min is order-free
//   under --fmad=false, and no NaN enters (every lane's update is
//   `d < best`). It is taken on the order key of the float's bits, a total
//   order, so all lanes end on the same bits; it agrees with the sequential
//   first-wins `<` because no -0 ever enters the min (a sphere distance
//   sqrtf(s) - r is -0 only for s = -0, and s, a sum of squares, is >= +0;
//   the cut is > 0), so float-equal values are bit-equal.
//
// The serial chain of one distance shrinks from ~157 ball tests + ~750
// sphere distances to ~157 / kLanes ball tests + ~750 / kLanes sphere
// distances + one reduction per round with candidates, for kLanes times
// the threads, and the group walks no other ray's runs. The wrapper
// (render/march_kernels.py `lanes_for`) picks kLanes per launch from the
// kernel, its ray count and the card's SM count. The run balls sit in
// shared memory, loaded once per block; the rays of a block are
// neighbouring pixels of a row. InstancedScene itself is not changed: one
// lane a ray is csrc/march.cuh's kernel over it, and K5, K5r, K6, K7 and
// K9 keep it.
//
// The per-lane pieces (`upper_part`, `ball`, `round_part`, `order_key`)
// and the walk compile as host C++ too: the walk reaches the group only
// through its Group type's `ballot` and `min`, which on the card are
// `WarpGroup`'s warp intrinsics over the group's lanes and in
// tests/test_torch_coop_march_host.py a loop over the lanes.

#include <cstring>

namespace lol {

// A total order on floats by their bits: key(a) < key(b) iff a < b, for
// all but -0 < +0 and the NaNs (above +inf, by payload).
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned b;
  memcpy(&b, &f, sizeof b);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  const unsigned b = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
}

// The lowest set bit of a non-zero mask.
__device__ __forceinline__ int low_bit(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

__device__ __forceinline__ constexpr unsigned low_bits(int k) {
  return k >= 32 ? 0xffffffffu : (1u << k) - 1u;
}

// L, C: the generated layout and Cfg, as InstancedScene's; G: the group
// (kLanes, this lane, and its collective ops `ballot` and `min`).
template <class L, class C, class G>
struct CoopInstancedScene : InstancedScene<L, C> {
  using Base = InstancedScene<L, C>;
  using Group = G;
  static constexpr int kLanes = G::kLanes;
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "a group is a power of two of a warp's lanes");
  static_assert(L::kGroup % kLanes == 0, "a run splits evenly over the lanes");

  G group;

  __device__ __forceinline__ CoopInstancedScene(const float* __restrict__ P_,
                                                const InstancedTables& t,
                                                const float4* groups, const G& g)
      : Base(P_, t, groups), group(g) {}

  // Lane `lane`'s part of Base::upper: the min over runs g = lane (mod
  // kLanes) of |p - ctr| + S.
  __device__ __forceinline__ float upper_part(int lane, float px, float py, float pz) const {
    float u = INFINITY;
    for (int g = lane; g < this->tab.num_groups; g += kLanes) {
      const float4 b = this->grp[2 * g];
      const float dx = px - b.x, dy = py - b.y, dz = pz - b.z;
      const float v = sqrtf((dx * dx + dy * dy) + dz * dz) + this->grp[2 * g + 1].x;
      if (v < u) u = v;
    }
    return u;
  }

  // A lane's bit of the ball pass: whether run g exists and can hold a
  // sphere at distance <= gate.
  __device__ __forceinline__ bool ball(int g, float px, float py, float pz, float gate) const {
    return g < this->tab.num_groups && this->visit(g, px, py, pz, gate);
  }

  // Lane `lane`'s part of the runs g0 + b for the set bits b of `cand`:
  // the min of `best` and its rows g * kGroup + lane + k * kLanes below
  // run_end(g) of each.
  __device__ __forceinline__ float round_part(unsigned cand, int g0, int lane, float px,
                                              float py, float pz, float best) const {
    while (cand) {
      const int g = g0 + low_bit(cand);
      cand &= cand - 1u;
      const int end = this->run_end(g);
#pragma unroll
      for (int k = 0; k < L::kGroup / kLanes; ++k) {
        const int j = g * L::kGroup + k * kLanes + lane;
        if (j < end) {
          const float d = this->sphere_dist(j, px, py, pz);
          if (d < best) best = d;
        }
      }
    }
    return best;
  }

  // Base::dist_under, bitwise, by the group (file comment).
  template <bool kHasClamp>
  __device__ __forceinline__ float dist_under(float px, float py, float pz,
                                              float clamp) const {
    float best = kHasClamp ? this->cut(px, py, pz, clamp) : INFINITY;
    const float u = kHasClamp
                        ? INFINITY
                        : group.min([&](int lane) { return upper_part(lane, px, py, pz); });
    for (int g0 = 0; g0 < this->tab.num_groups; g0 += kLanes) {
      const float gate = u < best ? u : best;
      const unsigned cand =
          group.ballot([&](int lane) { return ball(g0 + lane, px, py, pz, gate); });
      if (cand) best = group.min([&](int lane) {
        return round_part(cand, g0, lane, px, py, pz, best);
      });
    }
#pragma unroll
    for (int k = 0; k < L::kNumPlanes; ++k) {
      const float dp = py - this->plane_y[k];
      if (dp < best) best = dp;
    }
    return best;
  }

  __device__ __forceinline__ float dist(float px, float py, float pz) const {
    return dist_under<C::has_clamp>(px, py, pz, C::clamp);
  }

  __device__ __forceinline__ float shadow_dist(float px, float py, float pz) const {
    return dist_under<C::has_shadow_clamp>(px, py, pz, C::shadow_clamp);
  }
};

#ifdef __CUDACC__
// kLanes consecutive lanes of a warp, from lane 0 of the warp up: thread t
// of a 1-D block is lane t % kLanes of its group.
template <int K>
struct WarpGroup {
  static constexpr int kLanes = K;
  int lane;       // this thread's lane in the group
  int base;       // the group's first lane in the warp
  unsigned mask;  // the group's lanes in the warp

  __device__ __forceinline__ explicit WarpGroup(int thread)
      : lane(thread % K), base((thread & 31) & ~(K - 1)), mask(low_bits(K) << base) {}

  // bit l: pred(l) of lane l
  template <class F>
  __device__ __forceinline__ unsigned ballot(F pred) const {
    return (__ballot_sync(mask, pred(lane)) >> base) & low_bits(K);
  }

  // the group's min of part(l), by order_key
  template <class F>
  __device__ __forceinline__ float min(F part) const {
    return key_value(__reduce_min_sync(mask, order_key(part(lane))));
  }
};

constexpr int kCoopBlock = 256;

// Ray i of n is marched by threads i * kLanes .. i * kLanes + kLanes - 1 of
// a 1-D grid; a group past n leaves as a whole (it holds no ray), so no
// lane leaves its group's collectives early. Nothing is padded. The
// minimum of one resident block keeps ptxas from trading spills for
// occupancy (a lane group holds ~35-40 registers).
template <bool kShadow, class Cfg, class Scene>
__global__ void __launch_bounds__(kCoopBlock, 1)
    march_coop_kernel(const float* __restrict__ P, InstancedTables tab, MarchArgs a,
                      long long n) {
  extern __shared__ float4 s_groups[];
  for (int i = threadIdx.x; i < 2 * tab.num_groups; i += blockDim.x) s_groups[i] = tab.groups[i];
  __syncthreads();

  const long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / Scene::kLanes;
  if (ray >= n) return;
  const Scene scn(P, tab, s_groups, typename Scene::Group(threadIdx.x));
  value_at<kShadow, Cfg>(scn, a, (size_t)ray, (size_t)n, scn.group.lane == 0);
}

template <bool kShadow, class Cfg, class Scene>
int launch_march_coop(const float* P, const InstancedTables& tab, const MarchArgs& a,
                      long long n, cudaStream_t stream) {
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(march_coop_kernel<kShadow, Cfg, Scene>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n * Scene::kLanes + kCoopBlock - 1) / kCoopBlock;
  march_coop_kernel<kShadow, Cfg, Scene><<<(unsigned)blocks, kCoopBlock, smem, stream>>>(
      P, tab, a, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
