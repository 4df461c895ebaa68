// lol_exact_shadow / lol_exact_shadow_bwd (K4x / K4xb) on Hopper: the
// "exact" soft-shadow estimator of the differentiable renderer, its value
// and its adjoint, one thread a ray, on compiled scenes.
//
// render/shading.py's exact estimator differentiates straight through the
// shadow march (`shadow_march` under autograd, every step checkpointed), as
// the JAX package differentiates its scan. On the card that loop is ~1 000
// small launches a light and as many in its backward, and the card waits
// for the host between them. These two kernels are the same function and
// its reverse pass:
//
// - K4x (`exact_shadow_kernel`): per ray from so along l up to max_dist,
//   K4's march (`shadow_ray`, csrc/fused_fwd.cuh) and its segment cull
//   under Cfg::shadow_cull; res alone, [n]. With --fmad=false it is
//   bitwise the plain loop's res. A culled ray writes res = 1, what the
//   loop gives it: the bound proves each value w d / t above 1, so the
//   loop's running minimum never takes one.
// - K4xb (`exact_shadow_bwd_kernel`): per ray with a nonzero cotangent
//   g_res that the cull does not take (a culled ray's values never reach
//   the minimum, so the loop gives them nothing either), the march again
//   from t = 0, keeping each step's t_k, the running minimum before the
//   step and the step's value w d_k / t_k (3 x shadow_steps floats a
//   thread, in local memory: recomputing costs less than storing residuals,
//   ~1 GB a light at 1080p), then the sweep back from the last live step to
//   step 0 carrying the cotangents of the running minimum and of t:
//   torch.minimum's rule at each step (`min_bwd`: a tie splits), the
//   quotient's two terms (step 0's value, the constant +/-inf of t = 0,
//   takes none), the generated `Scene::dist_bwd` at p_k = so + t_k l for
//   the step's distance (its value term plus the cotangent of t_{k+1} =
//   t_k + d_k), and the point's cotangent to so, to l (times t_k) and to t_k
//   (along l). max_dist only ends the loop and takes none. Each thread writes
//   its ray's g_so and g_l, and adds the geometry's gradient into its column
//   of K2's [slot][thread] accumulators (csrc/fused_bwd.cuh `StridedAcc`);
//   each block sums its threads in a fixed order into one row of partials
//   and `bwd_reduce_kernel`, K2's reduce, sums each column over the blocks
//   in a fixed order. No float atomics: two backward launches give bitwise
//   equal gradients.
//
// Layout: K4x's blocks and warps are K4's (march_grid / march_ray_xy: 8 x 4
// tiles of the caller's [rows, width] batch). A K4xb block is 128 threads
// over 32 x 4 tiles of rays, each warp an 8 x 4 tile of one (a one-row
// batch: 128 consecutive rays). Where the accumulators of the geometry
// prefix (Scene::kNumGeom slots a thread) fit in shared memory
// (`exact_acc_shared`: up to 440 slots, ~110 spheres), a block takes one
// tile, so the hardware balances the rays' uneven marches across the SMs,
// and sums its threads by warp shuffles (`block_partials`). Past that they
// live in a global [blocks][slots][128] array over at most 528 blocks,
// each walking tiles b, b + B, ..., and each block sums its columns by a
// fixed pairwise tree (`exact_column_sums`). The ragged edge is masked; nothing is
// padded.
//
// What bounds them: FP32 and SFU issue in the SDF and its adjoint (K4x one
// evaluation a step; K4xb one in the march again and one forward plus
// reverse in the sweep a step), and the latency of those chains. Bytes are
// small: K4x reads 28 B and writes 4 B a ray, K4xb reads 32 B and writes
// 24 B a ray, plus its local arrays (up to 1.5 KB a ray, mostly in cache).
//
// Not compiled on its own: render/cuda_scene.py `generate_exact_shadow_source`
// emits it after csrc/fused_fwd.cuh, csrc/fused_bwd.cuh and csrc/march.cuh
// and before the generated Cfg and Scene (with `Scene::dist_bwd` and, where
// the structure allows the bound, `Scene::segment_lit`). The per-ray
// functions also compile as host C++ (tests/test_torch_exact_shadow.py).

namespace lol {

// Whether the segment cull takes the shadow ray from so along l over [0, T]
// (Cfg::shadow_cull and a Scene with the bound; else never).
template <class Cfg, class Scene>
__device__ __forceinline__ bool exact_culled(const Scene& scn, float sox, float soy, float soz,
                                             float lx, float ly, float lz, float T) {
  if constexpr (SegmentCull<Cfg, Scene>::value) {
    return scn.segment_lit(sox, soy, soz, lx, ly, lz, T);
  } else {
    return false;
  }
}

// K4x's work for one ray: the penumbra minimum res of the plain loop.
template <class Cfg, class Scene>
__device__ __forceinline__ float exact_shadow_ray(const Scene& scn, float sox, float soy,
                                                  float soz, float lx, float ly, float lz,
                                                  float max_dist) {
  if (exact_culled<Cfg>(scn, sox, soy, soz, lx, ly, lz, max_dist)) return 1.f;
  float t_star;
  return shadow_ray<Cfg>(scn, sox, soy, soz, lx, ly, lz, max_dist, t_star);
}

// K4xb's work for one ray with cotangent g of its res: g_so and g_l set
// (zeros for a culled ray or g == 0), the geometry's gradient added into gP
// (indexed like the packed buffer: a float pointer, or a StridedAcc).
template <class Cfg, class Scene, class G>
__device__ __forceinline__ void exact_shadow_bwd_ray(const Scene& scn, float sox, float soy,
                                                     float soz, float lx, float ly, float lz,
                                                     float max_dist, float g, float (&g_so)[3],
                                                     float (&g_l)[3], G gP) {
  for (int c = 0; c < 3; ++c) g_so[c] = g_l[c] = 0.f;
  if (g == 0.f || exact_culled<Cfg>(scn, sox, soy, soz, lx, ly, lz, max_dist)) return;

  // --- the march again (shadow_ray's loop), keeping each live step -------
  float ts[Cfg::shadow_steps], rs[Cfg::shadow_steps], vs[Cfg::shadow_steps];
  float res = 1.f, t = 0.f;
  int steps = 0;
  while (steps < Cfg::shadow_steps) {
    const float d = scn.shadow_dist(sox + t * lx, soy + t * ly, soz + t * lz);
    const float val = t > 0.f ? Cfg::shadow_w * d / t : (d < 0.f ? -INFINITY : INFINITY);
    ts[steps] = t;
    rs[steps] = res;
    vs[steps] = val;
    ++steps;
    res = jmin(res, val);
    t = t + d;
    if (res < -1.f || t > max_dist) break;
  }

  // --- the sweep back: g_res of the running minimum after step k, g_t of
  // t_{k+1} ---------------------------------------------------------------
  float g_res = g, g_t = 0.f;
  for (int k = steps - 1; k >= 0; --k) {
    const float tk = ts[k], val = vs[k];
    float g_prev, g_val;
    min_bwd(rs[k], val, g_res, g_prev, g_val);
    float g_d = g_t;    // t_{k+1} = t_k + d_k
    float g_tk = g_t;
    if (tk > 0.f) {     // val = (w d_k) / t_k, as torch's div differentiates it
      g_d = g_d + g_val / tk * Cfg::shadow_w;
      g_tk = g_tk + -g_val * (val / tk);
    }
    if (g_d != 0.f) {
      float gx, gy, gz;
      scn.template dist_bwd<true>(sox + tk * lx, soy + tk * ly, soz + tk * lz, g_d, gx, gy,
                                  gz, gP);
      g_so[0] += gx;
      g_so[1] += gy;
      g_so[2] += gz;
      g_l[0] += tk * gx;
      g_l[1] += tk * gy;
      g_l[2] += tk * gz;
      g_tk = g_tk + dot3(gx, gy, gz, lx, ly, lz);
    }
    g_res = g_prev;
    g_t = g_tk;
  }
}

// One launch's rays and cotangents: so, l [n, 3]; max_dist, g_res [n]; the
// per-ray outputs g_so, g_l [n, 3].
struct ExactArgs {
  const float* __restrict__ so;
  const float* __restrict__ l;
  const float* __restrict__ max_dist;
  const float* __restrict__ g_res;
  float* __restrict__ g_so;
  float* __restrict__ g_l;
};

// K4xb's work for ray i, its accumulators acc.
template <class Cfg, class Scene, class G>
__device__ __forceinline__ void exact_bwd_at(const Scene& scn, const ExactArgs& a, size_t i,
                                             G acc) {
  const float* o = a.so + 3 * i;
  const float* d = a.l + 3 * i;
  float g_so[3], g_l[3];
  exact_shadow_bwd_ray<Cfg>(scn, __ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d), __ldg(d + 1),
                            __ldg(d + 2), __ldg(a.max_dist + i), __ldg(a.g_res + i), g_so,
                            g_l, acc);
  for (int c = 0; c < 3; ++c) {
    a.g_so[3 * i + c] = g_so[c];
    a.g_l[3 * i + c] = g_l[c];
  }
}

// K4xb's blocks: 128 threads, a 32 x 4 tile of rays at a time whose warps
// are 8 x 4 tiles; a one-row batch 128 consecutive rays.
constexpr int kExactThreads = 128;
constexpr int kExactTileW = 32;
constexpr int kExactTileH = kExactThreads / kExactTileW;
// The most blocks of a launch whose accumulators live in global memory:
// four a SM of the H100's 132, as K2's.
constexpr int kExactMaxBlocks = 528;
// The shared memory one block may take on the H100 (227 KB).
constexpr size_t kExactSmemMax = 227 * 1024;

// Whether a block's accumulators, N slots of each of its 128 threads, and
// block_partials' [4][N] warp sums fit in the block's shared memory (N up
// to 440: ~110 spheres). Past that they live in a global [blocks][N][128]
// array, each block holding its columns and walking tiles b, b + B, ...
template <int N>
__host__ __device__ constexpr bool exact_acc_shared() {
  return sizeof(float) * (size_t)N * (kExactThreads + kExactThreads / 32) <= kExactSmemMax;
}

__host__ __device__ inline int exact_bwd_tiles(int rows, int width) {
  if (rows == 1) return (width + kExactThreads - 1) / kExactThreads;
  return ((width + kExactTileW - 1) / kExactTileW) * ((rows + kExactTileH - 1) / kExactTileH);
}

// K4xb's grid for N accumulator slots: a block a tile where they fit in
// shared memory, else at most kExactMaxBlocks.
template <int N>
__host__ __device__ inline int exact_bwd_blocks(int rows, int width) {
  const int tiles = exact_bwd_tiles(rows, width);
  return exact_acc_shared<N>() || tiles < kExactMaxBlocks ? tiles : kExactMaxBlocks;
}

// Floats of K4xb's global accumulators for N slots: 0 where they fit in
// shared memory.
template <int N>
__host__ __device__ inline long long exact_bwd_scratch(int rows, int width) {
  return exact_acc_shared<N>() ? 0
                               : (long long)exact_bwd_blocks<N>(rows, width) * N * kExactThreads;
}

// Ray (x, y) of thread tid in K4xb's tile b. The caller masks x >= width,
// y >= rows.
__device__ __forceinline__ void exact_ray_xy(int rows, int width, int b, int tid, int& x,
                                             int& y) {
  if (rows == 1) {
    x = b * kExactThreads + tid;
    y = 0;
    return;
  }
  const int tiles_x = (width + kExactTileW - 1) / kExactTileW;
  const int lane = tid & 31, warp = tid >> 5;
  x = (b % tiles_x) * kExactTileW + warp * 8 + lane % 8;
  y = (b / tiles_x) * kExactTileH + lane / 8;
}

// f(i) for the ray i of thread tid of block b of `blocks` in each of the
// block's tiles b, b + blocks, ..., in order.
template <class F>
__device__ __forceinline__ void exact_thread_rays(int rows, int width, int b, int blocks,
                                                  int tid, F&& f) {
  const int tiles = exact_bwd_tiles(rows, width);
  for (int tile = b; tile < tiles; tile += blocks) {
    int x, y;
    exact_ray_xy(rows, width, tile, tid, x, y);
    if (x < width && y < rows) f((size_t)y * width + x);
  }
}

// The block's sums over its threads of its columns cols [N][kExactThreads]
// (global accumulators), each by a fixed pairwise tree in place (7 levels,
// as accurate as block_partials' shuffles), into its row of partials:
// thread tid sums the slots tid, tid + 128, ...
template <int N>
__device__ __forceinline__ void exact_column_sums(float* cols, float* row, int tid) {
  for (int j = tid; j < N; j += kExactThreads) {
    float* c = cols + (size_t)j * kExactThreads;
    for (int len = kExactThreads / 2; len >= 1; len >>= 1)
      for (int t = 0; t < len; ++t) c[t] = c[2 * t] + c[2 * t + 1];
    row[j] = c[0];
  }
}

#ifdef __CUDACC__
template <class Cfg, class Scene>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    exact_shadow_kernel(const float* __restrict__ P, MarchArgs a, int rows, int width) {
  int x, y;
  march_ray_xy<kMarchTileW>(rows, blockIdx.x, blockIdx.y,
                            threadIdx.y * blockDim.x + threadIdx.x, x, y);
  if (x >= width || y >= rows) return;
  const Scene scn(P);
  const size_t i = (size_t)y * width + x;
  const float* o = a.ro + (size_t)a.ro_stride * i;
  const float* d = a.rd + 3 * i;
  a.out[i] = exact_shadow_ray<Cfg>(scn, __ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d),
                                   __ldg(d + 1), __ldg(d + 2), __ldg(a.max_dist + i));
}

template <class Cfg, class Scene>
int launch_exact_shadow(const float* P, const MarchArgs& a, int rows, int width,
                        cudaStream_t stream) {
  dim3 grid, block;
  march_grid(rows, width, kBlockX, kBlockY, grid, block);
  exact_shadow_kernel<Cfg, Scene><<<grid, block, 0, stream>>>(P, a, rows, width);
  return (int)cudaGetLastError();
}

// gacc: the global accumulators [blocks][N][kExactThreads] where they do
// not fit in shared memory, else unused.
template <class Cfg, class Scene>
__global__ void __launch_bounds__(kExactThreads)
    exact_shadow_bwd_kernel(const float* __restrict__ P, ExactArgs a, float* __restrict__ gacc,
                            float* __restrict__ partials, int rows, int width) {
  constexpr int N = Scene::kNumGeom;
  constexpr bool kShared = exact_acc_shared<N>();
  extern __shared__ float acc_cols[];  // [N][kExactThreads] when kShared
  const int tid = threadIdx.x;
  float* cols = kShared ? acc_cols : gacc + (size_t)blockIdx.x * N * kExactThreads;
  const StridedAcc<kExactThreads> acc{cols + tid};
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  const Scene scn(P);
  exact_thread_rays(rows, width, blockIdx.x, gridDim.x, tid,
                    [&](size_t i) { exact_bwd_at<Cfg>(scn, a, i, acc); });
  if constexpr (kShared) {
    block_partials<N, kExactThreads>(acc, partials);
  } else {
    __syncthreads();
    exact_column_sums<N>(cols, partials + (size_t)blockIdx.x * N, tid);
  }
}

// K4xb, then K2's reduce of its partials [blocks, N] into grads[0, N): the
// gradient of the packed buffer's geometry prefix. gacc holds
// exact_bwd_scratch floats.
template <class Cfg, class Scene>
int launch_exact_shadow_bwd(const float* P, const ExactArgs& a, float* gacc, float* partials,
                            float* grads, int rows, int width, cudaStream_t stream) {
  constexpr int N = Scene::kNumGeom;
  constexpr size_t smem = exact_acc_shared<N>() ? sizeof(float) * N * kExactThreads : 0;
  cudaError_t e = cudaFuncSetAttribute(exact_shadow_bwd_kernel<Cfg, Scene>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = exact_bwd_blocks<N>(rows, width);
  exact_shadow_bwd_kernel<Cfg, Scene><<<blocks, kExactThreads, smem, stream>>>(
      P, a, gacc, partials, rows, width);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_reduce_kernel<<<N, kBwdThreads, 0, stream>>>(partials, blocks, N, grads);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
