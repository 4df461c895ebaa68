// lol_rg_march, lol_rg_shadow and lol_rg_shade on Hopper: the regrouped
// forward render of an instanced scene, in three kernels with the shadow
// rays sorted by the Morton order of their origins in between.
//
// Replaces `loltracer_tpu/render/pallas_regroup.py`: `_march_track_kernel`
// (K9a, the Pallas call `lol_rg_march`), `_shadow_sorted_kernel` (K9b,
// `lol_rg_shadow`) and `_shade_planes_kernel` (K9c, `lol_rg_shade`). The
// three compute what lol_instanced_render (K5) computes in one thread per
// pixel, so the image is bitwise K5's:
//
// - lol_rg_march, one thread per pixel: render_pixel's march half
//   (csrc/fused_fwd.cuh `march_pixel`: camera ray, `march_ray`, `sdf_mat`
//   at the query point). It writes the planes t_sh, hit (1/0) and material
//   (K5r's residual planes 0-2), the shading point, and per light the
//   shadow record (origin, unit direction, distance to the light) by
//   render_pixel's own expressions (`light_ray`). The host then sorts each
//   light's records by the Morton code of their origins.
// - lol_rg_shadow, one thread per record, per light: thread i marches record
//   perm[i] with `shadow_ray` over the Scene's `shadow_dist` (K4's loop)
//   and writes res and t* straight back to pixel perm[i]. A warp is
//   then 32 shadow rays that are neighbours in 3-D, where K5's warp is an
//   8x4 pixel tile whose hit points can lie far apart at a silhouette.
// - lol_rg_shade, one thread per pixel: render_pixel's shade half
//   (`shade_pixel`) over the frozen planes: normals, Phong with each
//   light's res, the AA blend, gamma. An AA miss takes its coverage from
//   `sdf_mat`'s value at t_sh, the point and call K5 uses (JAX recovers it
//   with `dist_only`; the two agree bitwise, tests/test_torch_regroup_host.py).
//
// Per-pixel values depend only on the pixel's own ray, so the order in
// which shadow rays are marched changes no value: only which rays share a
// warp, i.e. how far a warp's rays diverge in the cells they search and in
// their step counts.
//
// The search. All three search csrc/grid_scene.cuh's `GridScene` (the cell
// grid of render/cell_grid.py, built once a frame and shared by the march,
// every light's shadow launch and the shade), with the run walk as its
// fallback, as K5 does; their `_walk` twins (`InstancedScene` alone) are
// the check and the yardstick. The shade's searches are its four normal
// taps under the primary clamp and, under AA, a miss's `sdf_mat`, which is
// unbounded and falls back where no listed sphere is near;
// `lol_rg_shade_stats` counts them.
//
// What bounds them on this card: as K5, FP32 / SFU issue, not bytes
// (lol_rg_march writes 24 + 28 L B per pixel, lol_rg_shadow reads 28 B and
// writes 8 B per record). On the walk an evaluation paid ~157 ball tests and
// ~750 sphere tests; on the grid it pays one cell's list, ~28 entries, each a
// 16-byte load and ~10 FP32 / SFU operations, behind two dependent loads
// (the cell's start, then its entries). The Morton order puts 32 shadow
// origins that are neighbours in 3-D, marching toward one light, in a warp:
// its active lanes search few distinct lists a step, so an entry's load is
// mostly a broadcast, and they take about the same number of steps, which
// is what the sort buys here (PERF.md). `lol_rg_shadow_grid_stats` counts
// that (distinct lists per warp step, `GridCountingScene`). The entry loop
// is issue-bound, not load-bound, so the sorted records are
// read through perm and each lane reads its list on its own: reading a
// shared list once and passing it by shuffles, other block sizes, a
// minimum of blocks per SM, records gathered into sorted order, a
// squared-distance cull and batched loads measured no faster (PERF.md).
//
// The TPU's (8, 128) tiles and 16x32 patches, its scratch gathers
// (cfg.shadow_scratch, cfg.scratch_window) and the segment cull
// (cfg.shadow_cull) are not carried over: all are speed only. Bands keep
// `full_height` and the pack's row0, as K5.
//
// `CountingScene` is the diagnostic of `shadow_gather_stats(walk=True)`: the
// shadow loop over the run walk also counts, per ray, its evaluations and
// the runs whose ball reaches within the evaluation's initial gate (the cut
// under a clamp), and per warp step the distinct such runs over the warp's
// active lanes. `GridCountingScene` is the grid's: GridScene's own counts
// (searches, fallbacks, entries read) and per warp step the distinct lists.
//
// This file follows csrc/fused_fwd.cuh, csrc/instanced_scene.cuh and
// csrc/grid_scene.cuh in the source render/cuda_scene.py generates
// (`generate_regroup_source`); the per-pixel and per-record functions also
// compile as host C++.

namespace lol {

// lol_rg_march's work for pixel (x, y) of a launch of n pixels (planes are
// n floats apart); `height` is the image's (full) height.
template <class Cfg, class Scene>
__device__ __forceinline__ void rg_march_pixel(const float* cam, const Scene& scn,
                                               const float* __restrict__ P, int x, int y,
                                               int height, int width,
                                               float* __restrict__ track,
                                               float* __restrict__ hitp,
                                               float* __restrict__ rec, size_t n) {
  const size_t i = (size_t)y * width + x;
  const PixelMarch m = march_pixel<Cfg>(cam, scn, x, y, height, width);
  track[i] = m.t_sh;
  track[n + i] = m.hit ? 1.f : 0.f;
  track[2 * n + i] = (float)m.mat;
  const float px = m.ox + m.t_sh * m.dx, py = m.oy + m.t_sh * m.dy, pz = m.oz + m.t_sh * m.dz;
  hitp[i] = px;
  hitp[n + i] = py;
  hitp[2 * n + i] = pz;
#pragma unroll
  for (int l = 0; l < Scene::kNumLights; ++l) {
    float lx, ly, lz, sox, soy, soz, light_dist;
    light_ray<Cfg, Scene>(P, l, px, py, pz, lx, ly, lz, sox, soy, soz, light_dist);
    float* r = rec + (size_t)7 * n * l + i;
    r[0] = sox;
    r[n] = soy;
    r[2 * n] = soz;
    r[3 * n] = lx;
    r[4 * n] = ly;
    r[5 * n] = lz;
    r[6 * n] = light_dist;
  }
}

// lol_rg_shadow's work for thread i of n: record perm[i] of one light's
// records rec [7, n], its (res, t*) into out [2, n] at the same index.
template <class Cfg, class Scene>
__device__ __forceinline__ void rg_shadow_at(const Scene& scn, const float* __restrict__ rec,
                                             const long long* __restrict__ perm,
                                             float* __restrict__ out, size_t i, size_t n) {
  const size_t p = (size_t)__ldg(perm + i);
  const float* r = rec + p;
  float t_star;
  out[p] = shadow_ray<Cfg>(scn, __ldg(r), __ldg(r + n), __ldg(r + 2 * n), __ldg(r + 3 * n),
                           __ldg(r + 4 * n), __ldg(r + 5 * n), __ldg(r + 6 * n), t_star);
  out[n + p] = t_star;
}

// lol_rg_shade's work for pixel (x, y) of a launch of n pixels: the frozen
// planes track [3, n] and shadow [L, 2, n], the image [n, 3].
template <class Cfg, class Scene>
__device__ __forceinline__ void rg_shade_pixel(const float* cam, const Scene& scn,
                                               const float* __restrict__ P, int x, int y,
                                               int height, int width,
                                               const float* __restrict__ track,
                                               const float* __restrict__ shadow,
                                               float* __restrict__ img, size_t n) {
  const size_t i = (size_t)y * width + x;
  PixelMarch m;
  camera_ray(cam, x, y, height, width, m);
  m.t_sh = __ldg(track + i);
  m.hit = __ldg(track + n + i) > 0.5f;
  m.mat = (int)__ldg(track + 2 * n + i);
  m.alpha = 1.f;
  if (Cfg::antialias && !m.hit) {
    // a miss shades at its closest approach t_sh (march_pixel's tc)
    float f_close;
    scn.sdf_mat(m.ox + m.t_sh * m.dx, m.oy + m.t_sh * m.dy, m.oz + m.t_sh * m.dz, f_close);
    m.alpha = coverage(cam, f_close, m.t_sh);
  }
  const auto shadow_of = [&](int l, float, float, float, float, float, float, float) {
    return __ldg(shadow + (size_t)2 * n * l + i);
  };
  shade_pixel<Cfg>(cam, scn, P, m, img, x, y, width, shadow_of);
}

// The shadow-stats view of an instanced Scene (shadow_gather_stats): its
// shadow_dist, and per call one count of evaluations, the runs whose ball
// reaches within the initial gate (lane), and, on the card, the distinct
// such runs over the active lanes of the warp (warp).
template <class Cfg, class S>
struct CountingScene {
  const S& s;
  mutable float evals = 0.f, runs_lane = 0.f, runs_warp = 0.f;

  __device__ __forceinline__ float shadow_dist(float px, float py, float pz) const {
    const float gate = Cfg::has_shadow_clamp ? s.cut(px, py, pz, Cfg::shadow_clamp)
                                             : s.upper(px, py, pz);
#ifdef __CUDA_ARCH__
    const unsigned active = __activemask();
#endif
    for (int g = 0; g < s.tab.num_groups; ++g) {
      const bool v = s.visit(g, px, py, pz, gate);
      runs_lane += v ? 1.f : 0.f;
#ifdef __CUDA_ARCH__
      runs_warp += __ballot_sync(active, v) ? 1.f : 0.f;
#else
      runs_warp += v ? 1.f : 0.f;
#endif
    }
    evals += 1.f;
    return s.shadow_dist(px, py, pz);
  }
};

// The distinct lists [b, e) over the warp's active lanes; 1 on the host,
// where a warp is one lane.
__device__ __forceinline__ int warp_lists(int b, int e) {
#ifdef __CUDA_ARCH__
  const unsigned active = __activemask();
  const unsigned same =
      __match_any_sync(active, ((unsigned long long)(unsigned)b << 32) | (unsigned)e);
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  // one leader per list: its lowest lane
  return __popc(__ballot_sync(active, (same & lt) == 0u));
#else
  return 1;
#endif
}

// The grid's shadow-stats view (lol_rg_shadow_grid_stats) of a counting
// GridScene G (GridScene<L, C, true>): its shadow_dist, counted by G
// (searches, fallbacks, entries read), and per call the distinct lists
// over the warp's active lanes (lists_warp) and whether there was one
// (one_list).
template <class Cfg, class G>
struct GridCountingScene {
  const G& s;
  mutable float lists_warp = 0.f, one_list = 0.f;

  __device__ __forceinline__ float shadow_dist(float px, float py, float pz) const {
    int b, e;
    s.locate(px, py, pz, s.box_dist(px, py, pz), b, e);
    const int distinct = warp_lists(b, e);
    lists_warp += (float)distinct;
    one_list += distinct == 1 ? 1.f : 0.f;
    return s.shadow_dist(px, py, pz);
  }
};

// What a lol_rg_shadow launch marches through: the Scene itself, or one
// of the counting views above over it.
enum RgShadowView { kRgDirect, kRgWalkCounts, kRgGridCounts };

// Threads per block of lol_rg_shadow: 1-D, so that a warp is 32
// consecutive records.
constexpr int kRgShadowBlock = 128;

#ifdef __CUDACC__
// Index: what the Scene's search takes beyond the tables (GridScene's cell
// grid; nothing for the run walk), as instanced_fwd_kernel's.
template <class Cfg, class Scene, class... Index>
__global__ void __launch_bounds__(kInstBlockX * kInstBlockY)
    rg_march_kernel(const float* __restrict__ cam_in, const float* __restrict__ P,
                    InstancedTables tab, float* __restrict__ track, float* __restrict__ hitp,
                    float* __restrict__ rec, int height, int full_height, int width,
                    Index... index) {
  extern __shared__ float4 s_groups[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * tab.num_groups; i += blockDim.x * blockDim.y)
    s_groups[i] = tab.groups[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float cam[kCamSize];
#pragma unroll
  for (int i = 0; i < kCamSize; ++i) cam[i] = __ldg(cam_in + i);
  const Scene scn(P, tab, s_groups, index...);
  rg_march_pixel<Cfg>(cam, scn, P, x, y, full_height, width, track, hitp, rec,
                      (size_t)height * width);
}

// stats: per-thread count planes in record order, [3, n] for
// kRgWalkCounts (CountingScene's), [5, n] for kRgGridCounts (searches,
// fallbacks, entries read, distinct lists of the warp summed over its
// steps, steps in one list); null otherwise.
template <class Cfg, class Scene, int kView, class... Index>
__global__ void __launch_bounds__(kRgShadowBlock)
    rg_shadow_kernel(const float* __restrict__ P, InstancedTables tab,
                     const float* __restrict__ rec, const long long* __restrict__ perm,
                     float* __restrict__ out, float* __restrict__ stats, long long n,
                     Index... index) {
  extern __shared__ float4 s_groups[];
  for (int i = threadIdx.x; i < 2 * tab.num_groups; i += blockDim.x)
    s_groups[i] = tab.groups[i];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Scene scn(P, tab, s_groups, index...);
  if constexpr (kView == kRgWalkCounts) {
    const CountingScene<Cfg, Scene> counting{scn};
    rg_shadow_at<Cfg>(counting, rec, perm, out, (size_t)i, (size_t)n);
    stats[i] = counting.evals;
    stats[n + i] = counting.runs_lane;
    stats[2 * n + i] = counting.runs_warp;
  } else if constexpr (kView == kRgGridCounts) {
    const GridCountingScene<Cfg, Scene> counting{scn};
    rg_shadow_at<Cfg>(counting, rec, perm, out, (size_t)i, (size_t)n);
    stats[i] = (float)scn.n_search;
    stats[n + i] = (float)scn.n_fallback;
    stats[2 * n + i] = (float)scn.n_read;
    stats[3 * n + i] = counting.lists_warp;
    stats[4 * n + i] = counting.one_list;
  } else {
    rg_shadow_at<Cfg>(scn, rec, perm, out, (size_t)i, (size_t)n);
  }
}

template <class Cfg, class Scene, class... Index>
__global__ void __launch_bounds__(kInstBlockX * kInstBlockY)
    rg_shade_kernel(const float* __restrict__ cam_in, const float* __restrict__ P,
                    InstancedTables tab, const float* __restrict__ track,
                    const float* __restrict__ shadow, float* __restrict__ img, int height,
                    int full_height, int width, Index... index) {
  extern __shared__ float4 s_groups[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * tab.num_groups; i += blockDim.x * blockDim.y)
    s_groups[i] = tab.groups[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float cam[kCamSize];
#pragma unroll
  for (int i = 0; i < kCamSize; ++i) cam[i] = __ldg(cam_in + i);
  const Scene scn(P, tab, s_groups, index...);
  rg_shade_pixel<Cfg>(cam, scn, P, x, y, full_height, width, track, shadow, img,
                      (size_t)height * width);
  if constexpr (Scene::kStats) scn.flush();
}

// The group table in dynamic shared memory, above 48 KB only after opting in.
template <class Kernel>
inline int rg_smem(Kernel kernel, const InstancedTables& tab, int& smem) {
  smem = 2 * tab.num_groups * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return 0;
}

template <class Cfg, class Scene, class... Index>
int launch_rg_march(const float* cam, const float* fields, const InstancedTables& tab,
                    float* track, float* hitp, float* rec, int height, int full_height,
                    int width, cudaStream_t stream, Index... index) {
  int smem;
  if (const int e = rg_smem(rg_march_kernel<Cfg, Scene, Index...>, tab, smem)) return e;
  const dim3 block(kInstBlockX, kInstBlockY);
  const dim3 grid((width + kInstBlockX - 1) / kInstBlockX,
                  (height + kInstBlockY - 1) / kInstBlockY);
  rg_march_kernel<Cfg, Scene, Index...><<<grid, block, smem, stream>>>(
      cam, fields, tab, track, hitp, rec, height, full_height, width, index...);
  return (int)cudaGetLastError();
}

template <class Cfg, class Scene, int kView, class... Index>
int launch_rg_shadow(const float* fields, const InstancedTables& tab, const float* rec,
                     const long long* perm, float* out, float* stats, long long n,
                     cudaStream_t stream, Index... index) {
  const auto kernel = rg_shadow_kernel<Cfg, Scene, kView, Index...>;
  int smem;
  if (const int e = rg_smem(kernel, tab, smem)) return e;
  const long long blocks = (n + kRgShadowBlock - 1) / kRgShadowBlock;
  kernel<<<(unsigned)blocks, kRgShadowBlock, smem, stream>>>(fields, tab, rec, perm, out,
                                                             stats, n, index...);
  return (int)cudaGetLastError();
}

template <class Cfg, class Scene, class... Index>
int launch_rg_shade(const float* cam, const float* fields, const InstancedTables& tab,
                    const float* track, const float* shadow, float* img, int height,
                    int full_height, int width, cudaStream_t stream, Index... index) {
  int smem;
  if (const int e = rg_smem(rg_shade_kernel<Cfg, Scene, Index...>, tab, smem)) return e;
  const dim3 block(kInstBlockX, kInstBlockY);
  const dim3 grid((width + kInstBlockX - 1) / kInstBlockX,
                  (height + kInstBlockY - 1) / kInstBlockY);
  rg_shade_kernel<Cfg, Scene, Index...><<<grid, block, smem, stream>>>(
      cam, fields, tab, track, shadow, img, height, full_height, width, index...);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
