// lol_instanced_bwd on Hopper: the backward of the instanced training
// render, down to the sphere table.
//
// Replaces `loltracer_tpu/render/pallas_train.py: _instanced_bwd_kernel`
// (the Pallas call `lol_instanced_bwd`). It computes the same function,
// not the TPU's passes. Per pixel one thread runs csrc/fused_bwd.cuh's
// `pixel_bwd` on the InstancedScene of csrc/instanced_scene.cuh, whose
// `dist_bwd` is the gradient of the primary-clamp distance (winner normal,
// frozen cut, planes). That gives, at the 1 + 4 + L adjoint sites of a
// pixel (the coverage / IFT numerator, the four normal taps, the Danskin
// term per light), what the TPU kernel's RECORD and REPLAY + VJP passes
// give: the camera and small-field gradients, summed through the
// per-block partials and the fixed-order reduce of lol_train_bwd, and
// one record per site — the winning sphere's sorted row and its (x, y, z,
// r) gradient — in a buffer [1 + 4 + L, pixels].
//
// The TPU's SCATTER (a pick loop over winner windows on a sequential grid)
// becomes a deterministic scatter of those records. Each sorted row's
// gradient is the sum of its records in increasing record index, so two
// launches give bitwise equal gradients; no float atomics anywhere:
//   1. count: per chunk of kRecChunk records and per row, how many records
//      of the chunk hold the row (integer atomics: the counts do not
//      depend on the order);
//   2. scan: per row its total and the exclusive scan over rows (where the
//      row's bucket starts), then per (chunk, row) where the chunk's
//      records of the row go, in chunk order;
//   3. place: one warp per chunk walks its records in order, 32 at a time,
//      and writes each record's index into its row's bucket (the rank among
//      the 32 from __match_any_sync), so every bucket is in increasing
//      record index;
//   4. sum: one thread per row adds its bucket's records in that order.
//
// What bounds it on this card: the 1 + 4 + L traversals per pixel (each
// an exact search as in lol_instanced_fwd, seeded at the cut under a
// clamp) and K2's reverse arithmetic, with K2's register pressure (16 +
// fields accumulators per thread); then the record bytes (20 B per slot
// written, read twice by the scatter).
//
// Not compiled on its own: render/cuda_scene.py emits it after
// csrc/fused_fwd.cuh, csrc/fused_bwd.cuh and csrc/instanced_scene.cuh.

namespace lol {

#ifdef __CUDACC__
constexpr int kInstBwdThreads = kInstBlockX * kInstBlockY;
constexpr int kRecChunk = 16384;  // records per chunk of the scatter
constexpr int kScanThreads = 1024;

__host__ __device__ inline int inst_bwd_num_blocks(int height, int width) {
  return ((width + kInstBlockX - 1) / kInstBlockX) *
         ((height + kInstBlockY - 1) / kInstBlockY);
}

__host__ __device__ inline int rec_num_chunks(long long records) {
  return (int)((records + kRecChunk - 1) / kRecChunk);
}

template <class Cfg, class Scene>
__global__ void __launch_bounds__(kInstBwdThreads)
    instanced_bwd_kernel(const float* __restrict__ cam_in,
                         const float* __restrict__ P, InstancedTables tab,
                         const float* __restrict__ res, const float* __restrict__ ct,
                         float* __restrict__ partials, int* __restrict__ rec_rows,
                         float4* __restrict__ rec_vals, int height, int full_height,
                         int width) {
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
    const Scene scn(P, tab, s_groups, &sink);
    // rows y of the launch are image rows cam[15] + y of full_height
    pixel_bwd<Cfg, Scene>(cam, scn, P, x, y, full_height, width, res + pix, pixels,
                          ct + 3 * pix, acc);
    sink.close(kSites);
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

// 2. One block: count[row] = the row's records, start[row] = the exclusive
// scan of count over rows, then hist[c * ns + row] = where chunk c's
// records of the row start, in place.
__global__ void __launch_bounds__(kScanThreads)
    rec_scan_kernel(int* __restrict__ hist, int chunks, int ns, int* __restrict__ start,
                    int* __restrict__ count) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x;
  for (int r = tid; r < ns; r += kScanThreads) {
    int total = 0;
    for (int c = 0; c < chunks; ++c) total += hist[(size_t)c * ns + r];
    count[r] = total;
  }
  __syncthreads();
  // thread tid scans rows [lo, hi): its own sum, then the block's prefix
  const int per = (ns + kScanThreads - 1) / kScanThreads;
  const int lo = tid * per < ns ? tid * per : ns;
  const int hi = lo + per < ns ? lo + per : ns;
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += count[r];
  part[tid] = mine;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int t = 0; t < kScanThreads; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
  }
  __syncthreads();
  int run = part[tid];
  for (int r = lo; r < hi; ++r) {
    start[r] = run;
    run += count[r];
  }
  __syncthreads();
  for (int r = tid; r < ns; r += kScanThreads) {
    int at = start[r];
    for (int c = 0; c < chunks; ++c) {
      int* h = hist + (size_t)c * ns + r;
      const int v = *h;
      *h = at;
      at += v;
    }
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
__global__ void rec_sum_kernel(const int* __restrict__ order, const int* __restrict__ start,
                               const int* __restrict__ count,
                               const float4* __restrict__ vals, int ns,
                               float4* __restrict__ dsph) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= ns) return;
  float sx = 0.f, sy = 0.f, sz = 0.f, sr = 0.f;
  const int b = start[r], e = b + count[r];
  for (int k = b; k < e; ++k) {
    const float4 v = vals[order[k]];
    sx += v.x;
    sy += v.y;
    sz += v.z;
    sr += v.w;
  }
  float4 out;
  out.x = sx;
  out.y = sy;
  out.z = sz;
  out.w = sr;
  dsph[r] = out;
}

// The whole backward: the per-pixel kernel, the reduce of the partials into
// grads [16 + fields], and the scatter of the records into dsph [ns] (x y z
// r per sorted row). The work buffers come from the caller; hist is
// [rec_num_chunks(sites * pixels)][ns], start, count [ns], order [sites *
// pixels].
template <class Cfg, class Scene>
int launch_instanced_bwd(const float* cam, const float* fields, const InstancedTables& tab,
                         const float* res, const float* ct, float* partials, float* grads,
                         int* rec_rows, float4* rec_vals, int* hist, int* start, int* count,
                         int* order, float4* dsph, int height, int full_height, int width,
                         cudaStream_t stream) {
  constexpr int kSites = 1 + 4 + Scene::kNumLights;
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  cudaError_t e;
  if (smem > 40 * 1024) {  // beside the kernel's static shared partials
    e = cudaFuncSetAttribute(instanced_bwd_kernel<Cfg, Scene>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kInstBlockX, kInstBlockY);
  const dim3 grid((width + kInstBlockX - 1) / kInstBlockX,
                  (height + kInstBlockY - 1) / kInstBlockY);
  instanced_bwd_kernel<Cfg, Scene><<<grid, block, smem, stream>>>(
      cam, fields, tab, res, ct, partials, rec_rows, rec_vals, height, full_height, width);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int rc = launch_bwd_reduce<Scene>(partials, (int)(grid.x * grid.y), grads, stream);
  if (rc != 0) return rc;

  const long long n = (long long)kSites * height * width;
  const int ns = tab.num_spheres, chunks = rec_num_chunks(n);
  e = cudaMemsetAsync(hist, 0, (size_t)chunks * ns * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  rec_count_kernel<<<chunks, 256, 0, stream>>>(rec_rows, n, ns, hist);
  rec_scan_kernel<<<1, kScanThreads, 0, stream>>>(hist, chunks, ns, start, count);
  rec_place_kernel<<<(chunks + 7) / 8, 256, 0, stream>>>(rec_rows, n, ns, chunks, hist, order);
  rec_sum_kernel<<<(ns + 255) / 256, 256, 0, stream>>>(order, start, count, rec_vals, ns, dsph);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
