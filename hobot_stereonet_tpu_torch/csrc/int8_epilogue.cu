// The dequant epilogue of the int8 library route (ops/int8_gemm.py).
//
// The JAX package computes every int8 conv as an XLA convolution with an
// int32 result and then y = acc * (s_x[n] * s_k[c]) + bias[c] in float32
// (hobot_stereonet_tpu/ops/quant.py:92-108), which XLA compiles into one
// fused multiply-add.  The port's int8 kernel (int8_conv.cu) fuses that
// epilogue and takes every conv of both networks; a conv it does not take
// runs as im2col and torch._int_mm (the route chip_smoke.py also times as
// the yardstick of the 3-D and dilated convs), whose int32 product this
// kernel turns into the conv's output:
//
//   y[m, c] = out_dtype(fmaf(float(acc[m, c]), s_x[n] * s_k[c], bias[c])),
//   n = m / rows_per_sample
//
// with the same intrinsics as int8_conv.cu's epilogue, so each value
// equals ops/kernels/int8_conv.py::epilogue bit for bit.
//
// acc: int32 [rows, ld] row-major (torch._int_mm's output, its columns
// padded past Cout); s_x: one float32 a sample, or one for all; s_k, bias:
// float32 [Cout]; y: [rows, Cout] contiguous, bf16 or float32 (the conv's
// channels-last output).
//
// Bound on the H100: memory.  It reads 4 bytes and writes 2 (bf16) an
// output value; one thread a value, consecutive threads on consecutive
// values, so loads and stores coalesce along a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    int8_epilogue_kernel(const int32_t* __restrict__ acc, long long ld, long long total, int cout,
                         long long rows_per_sample, const float* __restrict__ sx, int per_sample,
                         const float* __restrict__ s_k, const float* __restrict__ bias,
                         Tout* __restrict__ y) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += step) {
    const long long m = i / cout;
    const int c = static_cast<int>(i - m * cout);
    const float s = sx[per_sample ? m / rows_per_sample : 0];
    const float v = __fmaf_rn(__int2float_rn(acc[m * ld + c]), __fmul_rn(s, s_k[c]), bias[c]);
    if constexpr (sizeof(Tout) == 2) {
      y[i] = __float2bfloat16_rn(v);
    } else {
      y[i] = v;
    }
  }
}

}  // namespace

extern "C" int hst_int8_epilogue(const void* acc, long long ld, long long rows, int cout,
                                 long long rows_per_sample, const void* sx, int per_sample,
                                 const void* s_k, const void* bias, void* y, int y_bf16,
                                 void* stream) {
  if (rows <= 0 || cout <= 0 || ld < cout || rows_per_sample <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = rows * cout;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1LL * sms * kBlocksPerSm
                                                    ? want : 1LL * sms * kBlocksPerSm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(acc);
  const float *x = static_cast<const float*>(sx), *k = static_cast<const float*>(s_k),
              *b = static_cast<const float*>(bias);
  if (y_bf16) {
    int8_epilogue_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, ld, total, cout, rows_per_sample, x, per_sample, k, b,
        static_cast<__nv_bfloat16*>(y));
  } else {
    int8_epilogue_kernel<float><<<blocks, kThreads, 0, s>>>(
        a, ld, total, cout, rows_per_sample, x, per_sample, k, b, static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}
