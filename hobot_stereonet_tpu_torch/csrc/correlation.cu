// Dot-product correlation volume of two feature maps.
//
// Replaces the Pallas kernel correlation_volume_pallas
// (hobot_stereonet_tpu/ops/pallas/correlation.py:66, body _corr_kernel at
// :40); the JAX package serves the same function through XLA
// (hobot_stereonet_tpu/ops/cost_volume.py:63-93).
//
//   out[b,y,x,d] = sum_c fl[b,y,x,c] * fr[b,y,x-d,c] / sqrt(C),  0 where x < d
//
// fl, fr: [B,H,W,C] and out: [B,H,W,D], all contiguous, bf16 or f32.
// Products accumulate in f32; the sum is scaled and rounded once to the
// output type.
//
// Bound on the H100: memory.  At the main path's shapes (B=8, H=90, W=160,
// C=32, D=24, bf16) the kernel must read 14.7 MB and write 5.5 MB, 6.1 us at
// 3.35 TB/s, against 0.18 GFLOP of f32 multiply-adds, 2.6 us at the 67
// TFLOP/s f32 rate.
//
// Design: one block per (row, 32-column tile).  The block stages fl for its
// 32 columns and fr for the 32 + D - 1 columns they can match in shared
// memory, as f32 with one float of padding per row so that threads reading
// different rows hit different banks.  Each thread then computes (x, d)
// dot products, walking the tile in the order of the output, so a warp's
// stores are contiguous.  Every feature is read from device memory about
// (32 + D - 1) / 32 times instead of D times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileX = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void correlation_kernel(const T* __restrict__ fl,
                                   const T* __restrict__ fr,
                                   T* __restrict__ out,
                                   int H, int W, int C, int D) {
  extern __shared__ float smem[];
  const int stride = C + 1;                 // padded row: fewer bank conflicts
  const int fr_rows = kTileX + D - 1;
  float* fl_s = smem;                       // [kTileX][stride]
  float* fr_s = smem + kTileX * stride;     // [fr_rows][stride]

  const int x0 = blockIdx.x * kTileX;
  const long long row = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const T* fl_row = fl + row * W * C;
  const T* fr_row = fr + row * W * C;

  // Stage fl[x0 .. x0+kTileX) and fr[x0-D+1 .. x0+kTileX), zero outside [0, W).
  for (int i = threadIdx.x; i < kTileX * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int x = x0 + r;
    fl_s[r * stride + c] = x < W ? to_f32(fl_row[static_cast<long long>(x) * C + c]) : 0.0f;
  }
  for (int i = threadIdx.x; i < fr_rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int x = x0 - (D - 1) + r;
    fr_s[r * stride + c] =
        (x >= 0 && x < W) ? to_f32(fr_row[static_cast<long long>(x) * C + c]) : 0.0f;
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf(static_cast<float>(C));
  T* out_row = out + row * W * D;
  for (int i = threadIdx.x; i < kTileX * D; i += blockDim.x) {
    const int xi = i / D, d = i - xi * D;
    const int x = x0 + xi;
    if (x >= W) break;                      // i only grows: the rest are past W too
    float acc = 0.0f;
    if (x >= d) {
      const float* a = fl_s + xi * stride;
      const float* bvec = fr_s + (xi - d + D - 1) * stride;
      for (int c = 0; c < C; ++c) acc = fmaf(a[c], bvec[c], acc);
    }
    store(out_row + static_cast<long long>(x) * D + d, acc * scale);
  }
}

template <typename T>
int launch(const void* fl, const void* fr, void* out, int B, int H, int W, int C,
           int D, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * kTileX + D - 1) * (C + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(correlation_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + kTileX - 1) / kTileX, H, B);
  correlation_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(fl), static_cast<const T*>(fr), static_cast<T*>(out),
      H, W, C, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hst_correlation(const void* fl, const void* fr, void* out, int B,
                               int H, int W, int C, int D, int is_bf16,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(fl, fr, out, B, H, W, C, D, s)
                 : launch<float>(fl, fr, out, B, H, W, C, D, s);
}
