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
// pixels, D=24, bf16 logits) it must read 5.5 MB and write 0.9 MB, 1.9 us
// at 3.35 TB/s; its 24 exponentials a pixel are far below the card's rate.
//
// Design: one thread per pixel, all arithmetic in f32 registers.  A first
// pass over the pixel's D logits finds the maximum; a second pass (served
// from L1) sums the exponentials and their disparity-weighted sum.  Nothing
// but the two outputs is written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void soft_argmin_kernel(const T* __restrict__ logits,
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

}  // namespace

extern "C" int hst_soft_argmin(const void* logits, void* disp, void* conf, int N,
                               int D, float scale, int is_bf16, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(N) + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    soft_argmin_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), N, D, scale);
  } else {
    soft_argmin_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), N, D, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
