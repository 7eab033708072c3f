// Fused soft-argmin disparity and peak-probability confidence.
//
// Replaces the Pallas kernel soft_argmin_pallas
// (hobot_stereonet_tpu/ops/pallas/correlation.py:124, body
// _softargmin_kernel at :101); the JAX package serves the same function
// with soft_argmin and disparity_confidence
// (hobot_stereonet_tpu/models/fast_stereonet.py:86-89).  The kernel takes
// the aggregation's logits and folds in cost = -logits and the scale:
//
//   p_d  = softmax_d(logits)                       (f32)
//   disp = scale * sum_d d * p_d,   conf = max_d p_d = 1 / sum_d exp(l_d - max l)
//
// logits: [N, D] contiguous (N = B*H*W pixels), bf16 or f32;
// disp, conf: [N] f32.
//
// Bound on the H100: memory.  At the main path's shapes (B=8, 90x160
// pixels, D=24, bf16 logits) it must read 5.5 MB and write 0.9 MB: 6.4 MB,
// 1.9 us at 3.35 TB/s (25.8 MB, 7.7 us at B=32); its 24 exponentials a
// pixel are far below the card's rate.
//
// Design, bf16 with D=24 and 16-byte aligned rows (the main path): one
// thread a pixel.  It loads its pixel's 48-byte row as three 16-byte
// loads; a warp's three loads cover its 32 pixels' 1,536 contiguous bytes,
// so every byte fetched is used, the second and third from L1.  The D
// logits stay in registers, packed two to a register, so one pass over
// them takes the maximum (bf16x2 max, exact), then exp2((l - max) * log2 e),
// their sum and their disparity-weighted sum in f32.  Each thread stores
// its two outputs, coalesced.  Staging a warp's rows through shared memory
// with fully coalesced loads, several 32-pixel groups a warp with cp.async,
// a persistent grid, and two pixels a thread were tried on the H100 and
// were no faster; PERF.md compares the kernel's rate with the ingest
// kernel's.
//
// Generic (other D, f32 logits, rows not 16-byte aligned): one thread a
// pixel, scalar loads; a first pass finds the maximum, a second (served
// from L1) sums the exponentials.
//
// D-leading variant (hst_soft_argmin_dlead): the CLASSIC StereoNet's cost,
// [B, D, H, W] contiguous, as its 3-D aggregation leaves it
// (hobot_stereonet_tpu/models/stereonet.py:143-150 computes soft_argmin(cost)
// * k and disparity_confidence(cost) over axis 1).  It takes the cost with
// its sign (logits = -cost, exact in bf16) and reads it where it lies: one
// thread a pixel, its D values H*W apart, so a warp's 32 adjacent pixels
// load 64 (bf16) or 128 (f32) contiguous bytes per candidate, coalesced.  At D = 24 the values stay in registers and memory
// is read once; other D take two passes (the second from L1).  The
// arithmetic is the one-pass kernel's.  Bound at the CLASSIC path's shapes
// (B=8, 24 x 90 x 160 bf16): 5.53 MB read, 0.92 MB written, 1.93 us at
// 3.35 TB/s (7.7 us at B=32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorD = 24;
constexpr float kLog2e = 1.4426950408889634f;

// Softmax statistics of one pixel's D bf16 logits, packed two to a register.
template <int D>
__device__ __forceinline__ void pixel_stats(const uint4 (&row)[D / 8], float scale,
                                            float* disp, float* conf) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(row);
  __nv_bfloat162 mx = h[0];
#pragma unroll
  for (int j = 1; j < D / 2; ++j) mx = __hmax2(mx, h[j]);
  const float m = fmaxf(__low2float(mx), __high2float(mx));
  float sum = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    const float e0 = exp2f((f.x - m) * kLog2e);
    const float e1 = exp2f((f.y - m) * kLog2e);
    sum += e0;
    sum += e1;
    wsum = fmaf(static_cast<float>(2 * j), e0, wsum);
    wsum = fmaf(static_cast<float>(2 * j + 1), e1, wsum);
  }
  *disp = (wsum / sum) * scale;
  *conf = 1.0f / sum;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_vector_kernel(const __nv_bfloat16* __restrict__ logits,
                          float* __restrict__ disp, float* __restrict__ conf,
                          long long N, float scale) {
  static_assert(D % 8 == 0, "a row must be whole 16-byte units");
  constexpr int kUnits = D / 8;                    // 16-byte loads a pixel
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const uint4* src = reinterpret_cast<const uint4*>(logits) + n * kUnits;
  uint4 row[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) row[u] = __ldg(src + u);
  pixel_stats<D>(row, scale, disp + n, conf + n);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void soft_argmin_generic_kernel(const T* __restrict__ logits,
                                           float* __restrict__ disp,
                                           float* __restrict__ conf,
                                           long long N, int D, float scale) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const T* l = logits + n * D;
  float m = to_f32(l[0]);
  for (int d = 1; d < D; ++d) m = fmaxf(m, to_f32(l[d]));
  float sum = 0.0f, wsum = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float e = expf(to_f32(l[d]) - m);
    sum += e;
    wsum = fmaf(static_cast<float>(d), e, wsum);
  }
  disp[n] = (wsum / sum) * scale;
  conf[n] = 1.0f / sum;
}

template <typename T>
__device__ __forceinline__ float logit(const T* cost) {
  return -to_f32(__ldg(cost));
}

// One pixel's softmax statistics over D candidates `plane` elements apart.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_dlead_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                         float* __restrict__ conf, long long N, long long plane, int d_rt,
                         float scale) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long b = n / plane;
  const int nd = D > 0 ? D : d_rt;
  const T* c = cost + b * nd * plane + (n - b * plane);
  float sum = 0.0f, wsum = 0.0f;
  if constexpr (D > 0) {
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = logit(c + d * plane);
    float m = v[0];
#pragma unroll
    for (int d = 1; d < D; ++d) m = fmaxf(m, v[d]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float e = exp2f((v[d] - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
  } else {
    float m = logit(c);
    for (int d = 1; d < nd; ++d) m = fmaxf(m, logit(c + d * plane));
    for (int d = 0; d < nd; ++d) {
      const float e = exp2f((logit(c + d * plane) - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
  }
  disp[n] = (wsum / sum) * scale;
  conf[n] = 1.0f / sum;
}

template <typename T>
int launch_dlead(const void* cost, void* disp, void* conf, long long n, long long plane, int D,
                 float scale, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const T* c = static_cast<const T*>(cost);
  float* dp = static_cast<float*>(disp);
  float* cf = static_cast<float*>(conf);
  if (D == kVectorD) {
    soft_argmin_dlead_kernel<T, kVectorD><<<blocks, kThreads, 0, s>>>(c, dp, cf, n, plane, D,
                                                                       scale);
  } else {
    soft_argmin_dlead_kernel<T, 0><<<blocks, kThreads, 0, s>>>(c, dp, cf, n, plane, D, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost [B, D, H, W] contiguous (plane = H*W), lower is better; disp, conf
// [B, H, W] f32.
extern "C" int hst_soft_argmin_dlead(const void* cost, void* disp, void* conf, int B, int D,
                                     int plane, float scale, int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || plane <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * plane;
  return is_bf16 ? launch_dlead<__nv_bfloat16>(cost, disp, conf, n, plane, D, scale, s)
                 : launch_dlead<float>(cost, disp, conf, n, plane, D, scale, s);
}

// vector != 0 selects the D=24 bf16 kernel, which needs 16-byte aligned
// logits; the wrapper decides, and this returns cudaErrorInvalidValue if
// the logits do not fit it.
extern "C" int hst_soft_argmin(const void* logits, void* disp, void* conf, int N,
                               int D, float scale, int is_bf16, int vector, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = N;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (vector) {
    if (!is_bf16 || D != kVectorD || (reinterpret_cast<uintptr_t>(logits) & 15)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    soft_argmin_vector_kernel<kVectorD><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    soft_argmin_generic_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, D, scale);
  } else {
    soft_argmin_generic_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, D, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
