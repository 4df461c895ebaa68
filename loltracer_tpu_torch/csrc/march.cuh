// lol_march / lol_shadow_march (compiled scenes) and lol_march_instanced /
// lol_shadow_march_instanced (instanced scenes) on Hopper: the value-only
// march kernels of the differentiable renderer, one thread per ray.
//
// Replace `loltracer_tpu/render/pallas_march.py: _march_kernel` (K3, the
// Pallas calls `lol_march` and `lol_march_instanced`) and `_shadow_kernel`
// (K4, `lol_shadow_march` and `lol_shadow_march_instanced`). The
// differentiable renderer freezes both marches and re-attaches gradients
// outside them (the IFT at the hit, the coverage alpha, Danskin's term at
// t*), so these are pure value functions of (scene, rays):
//
// - K3: per ray from ro (one origin, or one per ray) along rd, the march of
//   csrc/fused_fwd.cuh `march_ray`, always tracking the closest approach
//   (the Pallas kernel passes track_aa=True whatever cfg.antialias is):
//   t, t_query, s_min, t_close as four planes [4, n].
// - K4: per ray from so along ld up to max_dist, `shadow_ray`: res and its
//   first-wins argmin t* as two planes [2, n]. Like the TPU kernel, a ray
//   that the compiled Scene's segment bound proves lit (the generated
//   Scene::segment_lit over [0, max_dist], under Cfg::shadow_cull: the
//   trait SegmentCull of csrc/fused_fwd.cuh) skips its march and writes
//   res = 1, t* = 0, what the march gives it (JAX's init_done lanes,
//   render_pixel's shadow_of). The cull is value-exact and speed only;
//   `RenderConfig(shadow_cull=False)` builds the twin without it, the
//   bitwise check. The instanced entries have no bound and march every ray.
//
// The loops are K1's and K5's own (`march_ray`, `shadow_ray`), so a ray
// marched here and inside render_pixel takes the same steps, and each
// thread's `break` is the plain loops' done-freezing for its ray. Instanced
// scenes run `InstancedScene::dist` (the primary step clamp) in K3 and
// `shadow_dist` (the shadow clamp) in K4.
//
// Layout: ray i of n lies at row i / width, column i % width of the
// caller's [rows, width] batch (the last batch dimension is the width). A
// compiled block is 32 x 8 rays and each warp of it a tile of kTileW x
// (32 / kTileW) of them, K1's mapping (tile_pixel): kMarchTileW = 8, a tile
// of 8 x 4, so a warp's rays and shadow rays stay closer together than a
// row of 32's. A batch of one row takes 1-D blocks of 256 rays
// (march_ray_xy). Instanced blocks are 8 x 16 rays as K5's; the instanced
// entries take a lane-group width: at more than one lane a group of a
// warp's lanes marches each ray (csrc/coop_march.cuh).
// The ragged edge is masked; nothing is padded. The TPU's (8, 128) tiles,
// lane-packed 16x32 patches and edge padding are not carried over.
//
// What bounds them on this card: FP32 and SFU issue in the SDF (five IEEE
// sqrtf an evaluation of scene4), not bytes (K3 reads 12 B and writes 16 B
// per ray, K4 28 B and 8 B). Each thread leaves its loop when its own ray
// is done, so a warp waits only for its own worst ray. On scene4 AA at
// 1920x1080 (PERF.md, an H100 SXM at 700 W) K3 runs at ~27 % of its
// sqrt-weighted bound and K4 at 18 % (light 0) and 30 % (light 1). The cull
// takes half of light 0's lanes, which march few steps anyway, and a
// quarter of light 1's: light 0's device time falls 19 %, light 1's 4 %.
// The 8 x 4 tile lifts the loops' warp efficiency (K3 0.855 -> 0.928) but
// the time by 0-3 % over a row of 32: divergence is not what holds these
// loops back. Instanced blocks keep the run balls in shared memory, loaded
// once per block.
//
// K7, lol_instanced_eval: one evaluation of the instanced scene's distance
// at arbitrary points, under one step clamp whose cut takes the AABB it is
// given. Replaces `loltracer_tpu/render/pallas_march.py: _eval_kernel`
// (built by `make_instanced_eval`, the Pallas call `lol_instanced_eval`),
// whose only caller is the object-sharded renderer
// (loltracer_tpu_torch/parallel/objects.py): each rank evaluates its own
// sphere shard under the AABB combined over the object axis, and the ranks
// all-reduce the minimum. One thread per point of a [n, 3] batch writes
// `GridScene::dist` (csrc/grid_scene.cuh: the rank's cell grid, built once
// per frame, then K5's run walk where the grid cannot certify; Cfg's
// primary clamp) to out[n]; the run walk alone (`InstancedScene::dist`) is
// the check entry; the ragged edge is masked, nothing is padded, and the
// TPU's (3, COL) tiles, windows and pick loop are not carried over. The
// planes' heights are a buffer of their own (the generated eval layout
// reads plane_y at offset 0 of it). Bound: FP32 and SFU issue in the
// search, as K5 (bytes: 12 B in and 4 B out per point). The run balls sit
// in shared memory for the fallback, loaded once per block; a block is 128
// consecutive points, so in the march's pixel order a warp is 32 pixels of
// one row rather than K5's 8 x 4 tile, mostly in one cell.
//
// This file follows csrc/fused_fwd.cuh and csrc/instanced_scene.cuh in
// the sources render/cuda_scene.py generates (`generate_march_source`,
// `generate_eval_source`); the per-ray and per-point functions also compile
// as host C++ (tests/test_torch_march_host.py).

namespace lol {

// One launch's rays. ro is [3] with ro_stride 0 (one origin) or [n, 3]
// with ro_stride 3; rd is [n, 3]; max_dist [n] (K4 only); out [4, n] (K3)
// or [2, n] (K4).
struct MarchArgs {
  const float* __restrict__ ro;
  int ro_stride;
  const float* __restrict__ rd;
  const float* __restrict__ max_dist;
  float* __restrict__ out;
};

// K3's work for ray i of n; the outputs written only with `write` (a lane
// group's first lane, csrc/coop_march.cuh).
template <class Cfg, class Scene>
__device__ __forceinline__ void march_at(const Scene& scn, const MarchArgs& a, size_t i,
                                         size_t n, bool write = true) {
  const float* o = a.ro + (size_t)a.ro_stride * i;
  const float* d = a.rd + 3 * i;
  float t, t_query, s_min, t_close;
  march_ray<Cfg, true>(scn, __ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d), __ldg(d + 1),
                       __ldg(d + 2), t, t_query, s_min, t_close);
  if (!write) return;
  a.out[i] = t;
  a.out[n + i] = t_query;
  a.out[2 * n + i] = s_min;
  a.out[3 * n + i] = t_close;
}

// K4's work for ray i of n, written only with `write`; a ray the segment
// bound proves lit writes res = 1, t* = 0 without its march.
template <class Cfg, class Scene>
__device__ __forceinline__ void shadow_at(const Scene& scn, const MarchArgs& a, size_t i,
                                          size_t n, bool write = true) {
  const float* o = a.ro + (size_t)a.ro_stride * i;
  const float* d = a.rd + 3 * i;
  if constexpr (SegmentCull<Cfg, Scene>::value) {
    if (scn.segment_lit(__ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d), __ldg(d + 1),
                        __ldg(d + 2), __ldg(a.max_dist + i))) {
      if (!write) return;
      a.out[i] = 1.f;
      a.out[n + i] = 0.f;
      return;
    }
  }
  float t_star;
  const float res = shadow_ray<Cfg>(scn, __ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d),
                                    __ldg(d + 1), __ldg(d + 2), __ldg(a.max_dist + i), t_star);
  if (!write) return;
  a.out[i] = res;
  a.out[n + i] = t_star;
}

template <bool kShadow, class Cfg, class Scene>
__device__ __forceinline__ void value_at(const Scene& scn, const MarchArgs& a, size_t i,
                                         size_t n, bool write = true) {
  if constexpr (kShadow) {
    shadow_at<Cfg>(scn, a, i, n, write);
  } else {
    march_at<Cfg>(scn, a, i, n, write);
  }
}

// K7's work for point i: the primary-clamp distance at p[3 i .. 3 i + 2].
template <class Scene>
__device__ __forceinline__ void eval_at(const Scene& scn, const float* __restrict__ p,
                                        float* __restrict__ out, size_t i) {
  const float* q = p + 3 * i;
  out[i] = scn.dist(__ldg(q), __ldg(q + 1), __ldg(q + 2));
}

// The warp tile width of lol_march / lol_shadow_march (8 x 4 rays a warp),
// MARCH_TILE_W in render/cuda_scene.py.
constexpr int kMarchTileW = 8;

// The launch shape of a [rows, width] batch in blocks of bx x by threads: a
// grid of gx x gy blocks of tx x ty threads; a single row in 1-D blocks of
// bx * by threads.
inline void march_shape(int rows, int width, int bx, int by, int& gx, int& gy, int& tx,
                        int& ty) {
  tx = rows == 1 ? bx * by : bx;
  ty = rows == 1 ? 1 : by;
  gx = (width + tx - 1) / tx;
  gy = (rows + ty - 1) / ty;
}

// Ray (x, y) of thread tid of compiled block (bx, by) (march_shape over
// kBlockX x kBlockY): a warp tile of tile_pixel<kTileW>, or in a one-row
// batch ray bx * 256 + tid. The caller masks x >= width, y >= rows.
template <int kTileW>
__device__ __forceinline__ void march_ray_xy(int rows, int bx, int by, int tid, int& x, int& y) {
  if (rows == 1) {
    x = bx * (kBlockX * kBlockY) + tid;
    y = by;
    return;
  }
  tile_pixel<kTileW>(bx, by, tid, x, y);
}

#ifdef __CUDACC__
// march_shape as CUDA launch dimensions.
inline void march_grid(int rows, int width, int bx, int by, dim3& grid, dim3& block) {
  int gx, gy, tx, ty;
  march_shape(rows, width, bx, by, gx, gy, tx, ty);
  block = dim3(tx, ty);
  grid = dim3(gx, gy);
}

template <bool kShadow, class Cfg, class Scene, int kTileW>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    march_kernel(const float* __restrict__ P, MarchArgs a, int rows, int width) {
  int x, y;
  march_ray_xy<kTileW>(rows, blockIdx.x, blockIdx.y, threadIdx.y * blockDim.x + threadIdx.x, x,
                       y);
  if (x >= width || y >= rows) return;
  const Scene scn(P);
  value_at<kShadow, Cfg>(scn, a, (size_t)y * width + x, (size_t)rows * width);
}

template <bool kShadow, class Cfg, class Scene, int kTileW = kMarchTileW>
int launch_march(const float* P, const MarchArgs& a, int rows, int width,
                 cudaStream_t stream) {
  dim3 grid, block;
  march_grid(rows, width, kBlockX, kBlockY, grid, block);
  march_kernel<kShadow, Cfg, Scene, kTileW><<<grid, block, 0, stream>>>(P, a, rows, width);
  return (int)cudaGetLastError();
}

template <bool kShadow, class Cfg, class Scene>
__global__ void __launch_bounds__(kInstBlockX * kInstBlockY)
    march_instanced_kernel(const float* __restrict__ P, InstancedTables tab, MarchArgs a,
                           int rows, int width) {
  extern __shared__ float4 s_groups[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * tab.num_groups; i += blockDim.x * blockDim.y)
    s_groups[i] = tab.groups[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= rows) return;
  const Scene scn(P, tab, s_groups);
  value_at<kShadow, Cfg>(scn, a, (size_t)y * width + x, (size_t)rows * width);
}

template <bool kShadow, class Cfg, class Scene>
int launch_march_instanced(const float* P, const InstancedTables& tab, const MarchArgs& a,
                           int rows, int width, cudaStream_t stream) {
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_instanced_kernel<kShadow, Cfg, Scene>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid, block;
  march_grid(rows, width, kInstBlockX, kInstBlockY, grid, block);
  march_instanced_kernel<kShadow, Cfg, Scene>
      <<<grid, block, smem, stream>>>(P, tab, a, rows, width);
  return (int)cudaGetLastError();
}
constexpr int kEvalBlock = 128;

template <class Scene, class... Index>
__global__ void __launch_bounds__(kEvalBlock)
    instanced_eval_kernel(const float* __restrict__ plane_y, InstancedTables tab,
                          const float* __restrict__ p, float* __restrict__ out, long long n,
                          Index... index) {
  extern __shared__ float4 s_groups[];
  for (int i = threadIdx.x; i < 2 * tab.num_groups; i += blockDim.x) s_groups[i] = tab.groups[i];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Scene scn(plane_y, tab, s_groups, index...);
  eval_at(scn, p, out, (size_t)i);
  if constexpr (Scene::kStats) scn.flush();
}

template <class Scene, class... Index>
int launch_instanced_eval(const float* plane_y, const InstancedTables& tab, const float* p,
                          float* out, long long n, cudaStream_t stream, Index... index) {
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        instanced_eval_kernel<Scene, Index...>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + kEvalBlock - 1) / kEvalBlock;
  instanced_eval_kernel<Scene, Index...><<<(unsigned)blocks, kEvalBlock, smem, stream>>>(
      plane_y, tab, p, out, n, index...);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
