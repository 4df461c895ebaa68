// lol_instanced_bwd on Hopper: the backward of the instanced training
// render, down to the sphere table.
//
// Replaces `loltracer_tpu/render/pallas_train.py: _instanced_bwd_kernel`
// (the Pallas call `lol_instanced_bwd`). It computes the same function,
// not the TPU's passes. Per pixel one thread runs csrc/fused_bwd.cuh's
// `pixel_bwd` on the instanced Scene, whose `dist_bwd` is the gradient of
// the primary-clamp distance (winner normal, frozen cut, planes). That
// gives, at the 1 + 4 + L adjoint sites of a pixel (the coverage / IFT
// numerator, the four normal taps, the Danskin term per light), what the
// TPU kernel's RECORD and REPLAY + VJP passes give: the camera and
// small-field gradients, summed through the per-block partials and the
// fixed-order reduce of lol_train_bwd, and one record per site — the
// winning sphere's sorted row and its (x, y, z, r) gradient — in a buffer
// [1 + 4 + L, pixels].
//
// The search. Each site's `dist_bwd` is one first-wins argmin (`winner`).
// lol_instanced_bwd takes it over csrc/grid_scene.cuh's `GridScene`, the
// cell grid that the step's lol_instanced_fwd searched (one grid a step,
// render/instanced_train.py), with the run walk as its fallback where the
// grid cannot certify: the argmin, hence every record and gradient, is the
// walk's bitwise. `lol_instanced_bwd_walk` (the run walk alone) is its
// check and `lol_instanced_bwd_stats` its counting twin.
//
// The TPU's SCATTER (a pick loop over winner windows on a sequential grid)
// becomes a deterministic scatter of those records. Each sorted row's
// gradient is the sum of its records in increasing record index, added
// one by one from +0 (`rec_add`), so two launches give bitwise equal
// gradients; no float atomics anywhere:
//   1. count: per chunk of kRecChunk records and per row, how many records
//      of the chunk hold the row (integer atomics: the counts do not
//      depend on the order);
//   2. scan, over many blocks: per segment of kScanSeg chunks and per row
//      the segment's records (`part`), per row the exclusive scan over its
//      segments and its total (`count`), the exclusive scan of the totals
//      over rows in one block (`start`, where the row's bucket begins),
//      then per (chunk, row) where the chunk's records of the row go;
//   3. place: one warp per chunk walks its records in order, 32 at a time,
//      and writes each record's index into its row's bucket (the rank among
//      the 32 from __match_any_sync), so every bucket is in increasing
//      record index;
//   4. sum: one warp per row stages its bucket's records in shared memory,
//      kSumBatch at a time (the next batch's loads in flight meanwhile),
//      and adds them in bucket order.
//
// What bounds it on this card: the 1 + 4 + L searches per pixel (each an
// exact search as in lol_instanced_fwd, seeded at the cut under a clamp)
// and K2's reverse arithmetic, with K2's register pressure (16 + fields
// accumulators per thread); then the record bytes (20 B per slot written,
// read twice by the scatter). The sum's floor is its longest row: one
// dependent add per record and component, in order.
//
// Not compiled on its own: render/cuda_scene.py emits it after
// csrc/fused_fwd.cuh, csrc/fused_bwd.cuh, csrc/instanced_scene.cuh and
// csrc/grid_scene.cuh. `rec_add` also compiles as host C++.

namespace lol {

// s + the n records v[0..n), added one by one in order, each component on
// its own: the association of the scatter's sum (a row's records in
// increasing record index, from +0)
__device__ __forceinline__ void rec_add(float4& s, const float4* v, int n) {
  for (int k = 0; k < n; ++k) {
    s.x += v[k].x;
    s.y += v[k].y;
    s.z += v[k].z;
    s.w += v[k].w;
  }
}

#ifdef __CUDACC__
constexpr int kInstBwdThreads = kInstBlockX * kInstBlockY;
constexpr int kRecChunk = 16384;  // records per chunk of the scatter
constexpr int kScanSeg = 32;      // chunks per segment of the column scans
constexpr int kScanThreads = 1024;
constexpr int kColThreads = 256;  // rows per block of the column scans
constexpr int kSumWarps = 8;      // rows per block of the sum, a warp each
constexpr int kSumBatch = 256;    // records a warp stages per step (8 a lane)

__host__ __device__ inline int inst_bwd_num_blocks(int height, int width) {
  return ((width + kInstBlockX - 1) / kInstBlockX) *
         ((height + kInstBlockY - 1) / kInstBlockY);
}

__host__ __device__ inline int rec_num_chunks(long long records) {
  return (int)((records + kRecChunk - 1) / kRecChunk);
}

__host__ __device__ inline int rec_num_segs(int chunks) {
  return (chunks + kScanSeg - 1) / kScanSeg;
}

// rows of the scatter's int work table [rows][ns]: the chunks' counts,
// then the segments' partial sums
__host__ __device__ inline int rec_hist_rows(long long records) {
  const int chunks = rec_num_chunks(records);
  return chunks + rec_num_segs(chunks);
}

// Index: what the Scene's search takes beyond the tables and the record
// sink (GridScene's cell grid; nothing for the run walk).
template <class Cfg, class Scene, class... Index>
__global__ void __launch_bounds__(kInstBwdThreads)
    instanced_bwd_kernel(const float* __restrict__ cam_in,
                         const float* __restrict__ P, InstancedTables tab,
                         const float* __restrict__ res, const float* __restrict__ ct,
                         float* __restrict__ partials, int* __restrict__ rec_rows,
                         float4* __restrict__ rec_vals, int height, int full_height,
                         int width, Index... index) {
  constexpr int N = kCamSize + Scene::kNumFields;
  constexpr int kSites = 1 + 4 + Scene::kNumLights;
  extern __shared__ float4 s_groups[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * tab.num_groups; i += kInstBwdThreads) s_groups[i] = tab.groups[i];
  __syncthreads();

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x < width && y < height) {  // no early return: all threads reduce
    float cam[kCamSize];
#pragma unroll
    for (int i = 0; i < kCamSize; ++i) cam[i] = __ldg(cam_in + i);
    const size_t pixels = (size_t)height * width, pix = (size_t)y * width + x;
    RecordSink sink{rec_rows, rec_vals, pixels, pix, 0};
    const Scene scn(P, tab, s_groups, index..., &sink);
    // rows y of the launch are image rows cam[15] + y of full_height
    pixel_bwd<Cfg, Scene>(cam, scn, P, x, y, full_height, width, res + pix, pixels,
                          ct + 3 * pix, acc);
    sink.close(kSites);
    if constexpr (Scene::kStats) scn.flush();
  }
  block_partials<N, kInstBwdThreads>(acc, partials);
}

// 1. hist[c * ns + row] += records of chunk c that hold row
__global__ void rec_count_kernel(const int* __restrict__ rows, long long n, int ns,
                                 int* __restrict__ hist) {
  const long long begin = (long long)blockIdx.x * kRecChunk;
  const long long end = begin + kRecChunk < n ? begin + kRecChunk : n;
  int* h = hist + (size_t)blockIdx.x * ns;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int row = rows[i];
    if (row >= 0) atomicAdd(h + row, 1);
  }
}

// 2a. part[s * ns + row] = the row's records in the chunks of segment s
// (blockIdx.y), a thread a row
__global__ void __launch_bounds__(kColThreads)
    rec_part_kernel(const int* __restrict__ hist, int chunks, int ns, int* __restrict__ part) {
  const int r = blockIdx.x * kColThreads + threadIdx.x;
  if (r >= ns) return;
  const int c0 = blockIdx.y * kScanSeg;
  const int c1 = c0 + kScanSeg < chunks ? c0 + kScanSeg : chunks;
  int total = 0;
  for (int c = c0; c < c1; ++c) total += __ldg(hist + (size_t)c * ns + r);
  part[(size_t)blockIdx.y * ns + r] = total;
}

// 2b. A thread a row: part[s * ns + row] = the row's records in the
// segments before s, in place; count[row] = all of them.
__global__ void __launch_bounds__(kColThreads)
    rec_row_kernel(int* __restrict__ part, int segs, int ns, int* __restrict__ count) {
  const int r = blockIdx.x * kColThreads + threadIdx.x;
  if (r >= ns) return;
  int run = 0;
  for (int s = 0; s < segs; ++s) {
    int* p = part + (size_t)s * ns + r;
    const int v = *p;
    *p = run;
    run += v;
  }
  count[r] = run;
}

// 2c. One block: start[row] = the exclusive scan of count over rows.
__global__ void __launch_bounds__(kScanThreads)
    rec_start_kernel(const int* __restrict__ count, int ns, int* __restrict__ start) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x;
  // thread tid scans rows [lo, hi): its own sum, then the block's prefix
  const int per = (ns + kScanThreads - 1) / kScanThreads;
  const int lo = tid * per < ns ? tid * per : ns;
  const int hi = lo + per < ns ? lo + per : ns;
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += count[r];
  part[tid] = mine;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive, Hillis-Steele
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - mine;
  for (int r = lo; r < hi; ++r) {
    start[r] = run;
    run += count[r];
  }
}

// 2d. hist[c * ns + row] = where chunk c's records of the row start: the
// row's start, its records in the segments before c's, then in the
// segment's chunks before c; a thread a (row, segment)
__global__ void __launch_bounds__(kColThreads)
    rec_cursor_kernel(int* __restrict__ hist, const int* __restrict__ part,
                      const int* __restrict__ start, int chunks, int ns) {
  const int r = blockIdx.x * kColThreads + threadIdx.x;
  if (r >= ns) return;
  const int c0 = blockIdx.y * kScanSeg;
  const int c1 = c0 + kScanSeg < chunks ? c0 + kScanSeg : chunks;
  int at = __ldg(start + r) + __ldg(part + (size_t)blockIdx.y * ns + r);
  for (int c = c0; c < c1; ++c) {
    int* h = hist + (size_t)c * ns + r;
    const int v = *h;
    *h = at;
    at += v;
  }
}

// 3. One warp per chunk: order[...] = the chunk's record indices, bucketed
// by row, each bucket in increasing record index. cursor is the scanned
// hist.
__global__ void rec_place_kernel(const int* __restrict__ rows, long long n, int ns,
                                 int chunks, int* __restrict__ cursor,
                                 int* __restrict__ order) {
  const int chunk = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (chunk >= chunks) return;  // whole warps: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long begin = (long long)chunk * kRecChunk;
  const long long end = begin + kRecChunk < n ? begin + kRecChunk : n;
  int* cur = cursor + (size_t)chunk * ns;
  for (long long base = begin; base < end; base += 32) {
    const long long i = base + lane;
    const int row = i < end ? rows[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    int at = 0;
    if (row >= 0) at = cur[row] + __popc(peers & below);
    __syncwarp();
    if (row >= 0) {
      order[at] = (int)i;
      if ((peers & below) == 0u) cur[row] += __popc(peers);  // the row's first lane
    }
    __syncwarp();
  }
}

// 4. dsph[row] = the sum of the row's records in increasing record index
// (rec_add's association), a warp a row: each step the warp stages
// kSumBatch records of the bucket in shared memory (8 a lane, gathered
// while the previous batch is added) and every lane adds them in order.
__global__ void __launch_bounds__(32 * kSumWarps)
    rec_sum_kernel(const int* __restrict__ order, const int* __restrict__ start,
                   const int* __restrict__ count, const float4* __restrict__ vals, int ns,
                   float4* __restrict__ dsph) {
  constexpr int kPer = kSumBatch / 32;
  __shared__ float4 stage[kSumWarps][kSumBatch];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSumWarps + w;
  if (r >= ns) return;  // the whole warp
  const int b = __ldg(start + r), e = b + __ldg(count + r);
  float4* st = stage[w];
  float4 next[kPer];
  const auto fetch = [&](int base) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = base + lane + 32 * j;
      if (k < e) next[j] = __ldg(vals + __ldg(order + k));
    }
  };
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  fetch(b);
  for (int base = b; base < e; base += kSumBatch) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (base + lane + 32 * j < e) st[lane + 32 * j] = next[j];
    __syncwarp();
    if (base + kSumBatch < e) fetch(base + kSumBatch);
    rec_add(sum, st, e - base < kSumBatch ? e - base : kSumBatch);
    __syncwarp();
  }
  if (lane == 0) dsph[r] = sum;
}

// The whole backward: the per-pixel kernel, the reduce of the partials into
// grads [16 + fields], and the scatter of the records into dsph [ns] (x y z
// r per sorted row). The work buffers come from the caller; hist is
// [rec_hist_rows(sites * pixels)][ns], start, count [ns], order [sites *
// pixels].
template <class Cfg, class Scene, class... Index>
int launch_instanced_bwd(const float* cam, const float* fields, const InstancedTables& tab,
                         const float* res, const float* ct, float* partials, float* grads,
                         int* rec_rows, float4* rec_vals, int* hist, int* start, int* count,
                         int* order, float4* dsph, int height, int full_height, int width,
                         cudaStream_t stream, Index... index) {
  constexpr int kSites = 1 + 4 + Scene::kNumLights;
  const auto kernel = instanced_bwd_kernel<Cfg, Scene, Index...>;
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  cudaError_t e;
  if (smem > 40 * 1024) {  // beside the kernel's static shared partials
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kInstBlockX, kInstBlockY);
  const dim3 grid((width + kInstBlockX - 1) / kInstBlockX,
                  (height + kInstBlockY - 1) / kInstBlockY);
  kernel<<<grid, block, smem, stream>>>(cam, fields, tab, res, ct, partials, rec_rows,
                                        rec_vals, height, full_height, width, index...);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int rc = launch_bwd_reduce<Scene>(partials, (int)(grid.x * grid.y), grads, stream);
  if (rc != 0) return rc;

  const long long n = (long long)kSites * height * width;
  const int ns = tab.num_spheres, chunks = rec_num_chunks(n), segs = rec_num_segs(chunks);
  int* part = hist + (size_t)chunks * ns;
  e = cudaMemsetAsync(hist, 0, (size_t)chunks * ns * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 cols((ns + kColThreads - 1) / kColThreads, segs);
  rec_count_kernel<<<chunks, 256, 0, stream>>>(rec_rows, n, ns, hist);
  rec_part_kernel<<<cols, kColThreads, 0, stream>>>(hist, chunks, ns, part);
  rec_row_kernel<<<cols.x, kColThreads, 0, stream>>>(part, segs, ns, count);
  rec_start_kernel<<<1, kScanThreads, 0, stream>>>(count, ns, start);
  rec_cursor_kernel<<<cols, kColThreads, 0, stream>>>(hist, part, start, chunks, ns);
  rec_place_kernel<<<(chunks + 7) / 8, 256, 0, stream>>>(rec_rows, n, ns, chunks, hist, order);
  rec_sum_kernel<<<(ns + kSumWarps - 1) / kSumWarps, 32 * kSumWarps, 0, stream>>>(
      order, start, count, rec_vals, ns, dsph);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
