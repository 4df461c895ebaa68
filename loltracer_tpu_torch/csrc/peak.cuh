// lol_peak_fma / lol_peak_sqrt on Hopper: the measured FP32 ceiling that
// the bounds of the port's kernels divide by.
//
// Replaces `loltracer_tpu/utils/peak.py: _build_kernel`'s inner `kernel`
// (the Pallas calls `lol_peak_fma` and `lol_peak_sqrt`): every lane runs
// `iters` iterations of 16 chained steps, either a = a * c + d (c =
// 0.9999999, d = a0 * 1e-7, so a stays bounded) or a = sqrtf(a + 1), and
// writes its final a; the host sums the lanes (the TPU kernel's one
// scalar). The chain cannot fold: a0 is the input.
//
// The TPU ran one (512, 128) block on one core. On this card the lanes are
// spread over a grid of several waves of 256-thread blocks over the 132
// SMs, each thread running kChains independent chains (lanes i, i + T, ...,
// T the threads of the grid), so that the four-cycle FP32 latency is hidden
// by independent work and not only by other warps. The FMA chain comes in
// two variants (lol_peak_fma's `fused`):
//
// - kKind 1: __fmaf_rn(a, c, d), one FFMA per step: the card's ceiling
//   (2 flops per instruction);
// - kKind 0: a * c + d as written, which under the port's --fmad=false
//   build is a separately rounded FMUL and FADD: what the port's kernels
//   issue, bitwise two torch ops.
//
// sqrtf compiles with the port's flags (IEEE sqrt, no fast math), as the
// kernels compile it. What bounds them is the FP32 (or SFU) issue rate
// itself; bytes are 8 per lane.

namespace lol {

constexpr int kPeakBlock = 256;
constexpr int kPeakChains = 4;
constexpr int kPeakSteps = 16;  // steps per iteration (utils/peak.py _FMA_PER_ITER)

// One step of the chain of kind kKind: 0 = a * c + d, 1 = __fmaf_rn, 2 = sqrt.
template <int kKind>
__device__ __forceinline__ float peak_step(float a, float c, float d) {
  if constexpr (kKind == 0) {
    return a * c + d;
  } else if constexpr (kKind == 1) {
#ifdef __CUDA_ARCH__
    return __fmaf_rn(a, c, d);
#else
    return fmaf(a, c, d);
#endif
  } else {
    return sqrtf(a + 1.f);
  }
}

// Thread t of T's chains: lanes t + k T for k < kPeakChains of x / out.
template <int kKind>
__device__ __forceinline__ void peak_thread(const float* __restrict__ x, float* __restrict__ out,
                                            long long t, long long threads, int iters) {
  float a[kPeakChains], d[kPeakChains];
  const float c = 0.9999999f;
#pragma unroll
  for (int k = 0; k < kPeakChains; ++k) {
    a[k] = x[t + k * threads];
    d[k] = a[k] * 1e-7f;
  }
  // The FMA chains: eight iterations per trip of the loop, so that its
  // counter, compare and branch are under 1 % of the issued instructions.
  // The sqrt chain: one, as 64 inlined IEEE sqrtf (each with its branch to
  // the slow path) already dwarf the loop, and eight times that code
  // thrashes the instruction cache (29 % slower on the H100).
#pragma unroll (kKind == 2 ? 1 : 8)
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kPeakSteps; ++s) {
#pragma unroll
      for (int k = 0; k < kPeakChains; ++k) a[k] = peak_step<kKind>(a[k], c, d[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPeakChains; ++k) out[t + k * threads] = a[k];
}

#ifdef __CUDACC__
template <int kKind>
__global__ void __launch_bounds__(kPeakBlock)
    peak_kernel(const float* __restrict__ x, float* __restrict__ out, int iters) {
  const long long threads = (long long)gridDim.x * blockDim.x;
  peak_thread<kKind>(x, out, (long long)blockIdx.x * blockDim.x + threadIdx.x, threads, iters);
}

// n lanes, a multiple of kPeakBlock * kPeakChains.
template <int kKind>
int launch_peak(const float* x, float* out, long long n, int iters, cudaStream_t stream) {
  const long long blocks = n / ((long long)kPeakBlock * kPeakChains);
  peak_kernel<kKind><<<(unsigned)blocks, kPeakBlock, 0, stream>>>(x, out, iters);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol

#ifdef __CUDACC__
extern "C" int lol_peak_fma(const void* x, void* out, long long n, int iters, int fused,
                            void* stream) {
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return fused ? lol::launch_peak<1>(xf, of, n, iters, s)
               : lol::launch_peak<0>(xf, of, n, iters, s);
}

extern "C" int lol_peak_sqrt(const void* x, void* out, long long n, int iters, void* stream) {
  return lol::launch_peak<2>(static_cast<const float*>(x), static_cast<float*>(out), n, iters,
                             static_cast<cudaStream_t>(stream));
}
#endif  // __CUDACC__
