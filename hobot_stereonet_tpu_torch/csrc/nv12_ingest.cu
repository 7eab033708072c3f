// Side-by-side NV12 camera frames -> normalized model input (YUV444 or RGB).
//
// Replaces the Pallas kernel nv12_sbs_preprocess_pallas
// (hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py:74, body
// _preproc_kernel at :39) and the epilogues that nv12_ingest puts after it
// (hobot_stereonet_tpu/ops/preprocess.py:92-133): YUV -> RGB and the
// input's int8 quantize-dequantize.
//
// in : src [B, 3*H*W] uint8, each frame a side-by-side NV12 buffer of width
//      2W: Y plane [H, 2W], then the interleaved UV plane [H/2, 2W]
//      (left eye in columns [0, W), right eye in [W, 2W)).
// out: dst [B, H, W, 6], chroma upsampled 2x by nearest neighbour:
//      YUV: bfloat16 (k - 128) / 128 of [Yl,Ul,Vl,Yr,Ur,Vr].  Every value
//           is k/128 - 1 with k in [0, 255], which bf16 holds exactly.
//      RGB: float32 (x - 128) / 128 of [Rl,Gl,Bl,Rr,Gr,Br], x the JAX
//           package's clip(yuv_to_rgb(y, u, v), 0, 255) as XLA compiles it:
//           b = fma(u-128, 1/0.492, y), r = fma(v-128, 1/0.877, y),
//           g = fma(-0.114, b, fma(-0.299, r, y)) * (1/0.587), each
//           reciprocal rounded to float32.  The fused multiply-adds are
//           written with intrinsics, so nvcc's contraction cannot change
//           them; ops/kernels/preprocess_kernel.py computes the same.
//      quantize: out = clip(floor(out * 128 + 0.5), -128, 127) / 128.
//
// Bound on the H100: memory.  Per frame the kernel must read 3HW bytes
// and write 12HW bytes in YUV, 24HW bytes in RGB (2.76 MB + 11.06 MB or
// 22.1 MB at 1280x720), so at 3.35 TB/s a frame takes at least 4.1 us
// (7.4 us in RGB); its arithmetic, at most 8 operations an output value,
// is far below the card's rate.
//
// Design: one thread per pair of horizontally adjacent output pixels, which
// share one chroma sample.  The thread reads the two Y bytes and the UV pair
// of each eye (neighbouring threads read neighbouring bytes) and writes its
// 12 outputs contiguously (24 bytes as six bf16x2 stores, or 48 bytes as
// three 16-byte stores), so a warp writes 768 or 1536 contiguous bytes.
// Every input byte is read once and every output byte written once; no
// shared memory is needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float norm(float x) {
  return __fmul_rn(__fsub_rn(x, 128.0f), 1.0f / 128.0f);
}

template <bool QUANT>
__device__ __forceinline__ float finish(float x) {
  float o = norm(x);
  if (QUANT) {
    o = fminf(fmaxf(floorf(__fmaf_rn(o, 128.0f, 0.5f)), -128.0f), 127.0f);
    o = __fmul_rn(o, 1.0f / 128.0f);
  }
  return o;
}

// clip(yuv_to_rgb(y, u, v), 0, 255) into rgb[0..2].
__device__ __forceinline__ void yuv_to_rgb(float y, float u, float v, float* rgb) {
  const float inv_u = 1.0f / 0.492f, inv_v = 1.0f / 0.877f, inv_kg = 1.0f / 0.587f;
  const float b = __fmaf_rn(__fsub_rn(u, 128.0f), inv_u, y);
  const float r = __fmaf_rn(__fsub_rn(v, 128.0f), inv_v, y);
  const float g = __fmul_rn(__fmaf_rn(-0.114f, b, __fmaf_rn(-0.299f, r, y)), inv_kg);
  rgb[0] = fminf(fmaxf(r, 0.0f), 255.0f);
  rgb[1] = fminf(fmaxf(g, 0.0f), 255.0f);
  rgb[2] = fminf(fmaxf(b, 0.0f), 255.0f);
}

template <bool RGB, bool QUANT>
__global__ void nv12_ingest_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst,
                                   int H, int W) {
  const int pairs_per_row = W / 2;
  const long long pairs = static_cast<long long>(H) * pairs_per_row;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int b = blockIdx.y;
  const int y = static_cast<int>(p / pairs_per_row);
  const int xp = static_cast<int>(p - static_cast<long long>(y) * pairs_per_row);

  const long long fw = 2LL * W;                       // frame width in bytes
  const uint8_t* frame = src + static_cast<long long>(b) * 3LL * H * W;
  const uint8_t* yrow = frame + y * fw;
  const uint8_t* uvrow = frame + H * fw + (y >> 1) * fw;
  const int x = 2 * xp;

  // v[pixel][channel]: [Yl Ul Vl Yr Ur Vr] as bytes, for pixels x and x+1.
  float v[2][6];
  for (int i = 0; i < 2; ++i) {
    v[i][0] = yrow[x + i];
    v[i][1] = uvrow[x];
    v[i][2] = uvrow[x + 1];
    v[i][3] = yrow[W + x + i];
    v[i][4] = uvrow[W + x];
    v[i][5] = uvrow[W + x + 1];
  }
  const long long o = ((static_cast<long long>(b) * H + y) * W + x) * 6;
  if (RGB) {
    float out[12];
    for (int i = 0; i < 2; ++i) {
      yuv_to_rgb(v[i][0], v[i][1], v[i][2], out + 6 * i);
      yuv_to_rgb(v[i][3], v[i][4], v[i][5], out + 6 * i + 3);
    }
    float4* d = reinterpret_cast<float4*>(static_cast<float*>(dst) + o);
    for (int i = 0; i < 3; ++i)
      d[i] = make_float4(finish<QUANT>(out[4 * i]), finish<QUANT>(out[4 * i + 1]),
                         finish<QUANT>(out[4 * i + 2]), finish<QUANT>(out[4 * i + 3]));
  } else {
    const float* f = &v[0][0];
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dst) + o);
    for (int i = 0; i < 6; ++i)
      d[i] = __floats2bfloat162_rn(finish<QUANT>(f[2 * i]), finish<QUANT>(f[2 * i + 1]));
  }
}

template <bool RGB, bool QUANT>
void launch(const void* src, void* dst, int B, int H, int W, cudaStream_t stream) {
  const int threads = 256;
  const long long pairs = static_cast<long long>(H) * (W / 2);
  dim3 grid(static_cast<unsigned>((pairs + threads - 1) / threads), static_cast<unsigned>(B));
  nv12_ingest_kernel<RGB, QUANT><<<grid, threads, 0, stream>>>(
      static_cast<const uint8_t*>(src), dst, H, W);
}

}  // namespace

extern "C" int hst_nv12_ingest(const void* src, void* dst, int B, int H, int W, int rgb,
                               int quantize, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1) || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rgb)
    quantize ? launch<true, true>(src, dst, B, H, W, s) : launch<true, false>(src, dst, B, H, W, s);
  else
    quantize ? launch<false, true>(src, dst, B, H, W, s) : launch<false, false>(src, dst, B, H, W, s);
  return static_cast<int>(cudaGetLastError());
}
