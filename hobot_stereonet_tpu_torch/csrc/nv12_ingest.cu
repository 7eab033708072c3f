// Side-by-side NV12 camera frames -> normalized YUV444 model input.
//
// Replaces the Pallas kernel nv12_sbs_preprocess_pallas
// (hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py:74, body
// _preproc_kernel at :39).
//
// in : src [B, 3*H*W] uint8, each frame a side-by-side NV12 buffer of width
//      2W: Y plane [H, 2W], then the interleaved UV plane [H/2, 2W]
//      (left eye in columns [0, W), right eye in [W, 2W)).
// out: dst [B, H, W, 6] bfloat16 = (k - 128) / 128 of [Yl,Ul,Vl,Yr,Ur,Vr];
//      chroma is upsampled 2x by nearest neighbour on both axes.  Every
//      value is k/128 - 1 with k in [0, 255], which bf16 holds exactly.
//
// Bound on the H100: memory.  Per frame the kernel must read 3HW bytes
// and write 12HW bytes (2.76 MB + 11.06 MB at 1280x720) and does one
// multiply-add per output value, so at 3.35 TB/s a frame takes at least
// 4.1 us; its arithmetic is negligible.
//
// Design: one thread per pair of horizontally adjacent output pixels, which
// share one chroma sample.  The thread reads the two Y bytes and the UV pair
// of each eye (neighbouring threads read neighbouring bytes) and writes its
// 12 outputs as six bf16x2 stores, 24 contiguous bytes, so a warp writes
// 768 contiguous bytes.  Every input byte is read once and every output
// byte written once; no shared memory is needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float norm_byte(uint8_t k) {
  return (static_cast<float>(k) - 128.0f) * (1.0f / 128.0f);
}

__global__ void nv12_ingest_kernel(const uint8_t* __restrict__ src,
                                   __nv_bfloat162* __restrict__ dst,
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

  const float yl0 = norm_byte(yrow[x]);
  const float yl1 = norm_byte(yrow[x + 1]);
  const float yr0 = norm_byte(yrow[W + x]);
  const float yr1 = norm_byte(yrow[W + x + 1]);
  const float ul = norm_byte(uvrow[x]);
  const float vl = norm_byte(uvrow[x + 1]);
  const float ur = norm_byte(uvrow[W + x]);
  const float vr = norm_byte(uvrow[W + x + 1]);

  // 12 outputs = 6 bf16x2: [Yl0 Ul][Vl Yr0][Ur Vr][Yl1 Ul][Vl Yr1][Ur Vr].
  __nv_bfloat162* o = dst + ((static_cast<long long>(b) * H + y) * W + x) * 3;
  o[0] = __floats2bfloat162_rn(yl0, ul);
  o[1] = __floats2bfloat162_rn(vl, yr0);
  o[2] = __floats2bfloat162_rn(ur, vr);
  o[3] = __floats2bfloat162_rn(yl1, ul);
  o[4] = __floats2bfloat162_rn(vl, yr1);
  o[5] = __floats2bfloat162_rn(ur, vr);
}

}  // namespace

extern "C" int hst_nv12_ingest(const void* src, void* dst, int B, int H, int W,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1) || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const long long pairs = static_cast<long long>(H) * (W / 2);
  dim3 grid(static_cast<unsigned>((pairs + threads - 1) / threads),
            static_cast<unsigned>(B));
  nv12_ingest_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<__nv_bfloat162*>(dst), H, W);
  return static_cast<int>(cudaGetLastError());
}
