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
// Design (a block per tile of TW pixels of row_pairs() row pairs, both eyes):
//   * the two luma rows and their shared chroma row, of both eyes, are read
//     once each with 16-byte loads (each chroma sample is read once, not
//     once per luma row), the next row pair's while this one is converted,
//     and staged in shared memory;
//   * each thread converts one pixel pair of one eye in both rows (four
//     pixels sharing one chroma sample) and writes its 12 values per row
//     pair into the output tile in shared memory, in the interleaved
//     [pixel][Yl Ul Vl Yr Ur Vr] order;
//   * the tile's two output rows, each one contiguous range of memory, go
//     out with consecutive lanes on consecutive 16-byte words (512 bytes a
//     warp instruction), as streaming stores (__stcs): at B >= 8 the output
//     (22.1 MB a frame in RGB) overflows the 50 MB L2 and is read by the
//     next kernel from device memory anyway.
// Widths whose rows are not 16-byte aligned (W % 16 != 0) take the same
// tiles with byte loads and element stores; the last tile of a row may be
// narrower than TW.

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

constexpr int TW = 256;                 // pixels of one eye a tile
constexpr int THREADS = TW;             // one thread per (eye, pixel pair)
// Row pairs a block, the next one's loads in flight while one converts;
// an RGB pair writes twice a YUV pair's bytes, so it takes half as many.
template <bool RGB> __host__ __device__ constexpr int row_pairs() { return RGB ? 2 : 4; }

template <bool RGB> struct OutType { using type = __nv_bfloat16; };
template <> struct OutType<true> { using type = float; };

__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <bool RGB, bool QUANT, bool VEC>
__global__ void __launch_bounds__(THREADS)
nv12_ingest_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst, int H, int W) {
  using Out = typename OutType<RGB>::type;
  __shared__ __align__(16) uint8_t in[3][2][TW];        // [Y row 0, Y row 1, UV][eye][byte]
  __shared__ __align__(16) unsigned char out_raw[2 * TW * 6 * sizeof(Out)];
  Out* out = reinterpret_cast<Out*>(out_raw);           // [row][pixel * 6 + channel]
  const int x0 = blockIdx.x * TW, b = blockIdx.z;
  const int tw = min(TW, W - x0);                       // even: W is
  constexpr int ROW_PAIRS = row_pairs<RGB>();
  const int y2_end = min(H / 2, static_cast<int>(blockIdx.y + 1) * ROW_PAIRS);
  const long long fw = 2LL * W;                         // frame width in bytes
  const uint8_t* frame = src + static_cast<long long>(b) * 3LL * H * W;
  // Input row r of row pair y2: luma rows 2 y2 and 2 y2 + 1, then their chroma row.
  auto row = [&](int y2, int r) { return frame + (r < 2 ? 2LL * y2 + r : H + y2) * fw; };
  // VEC: thread i < 6 * per holds the 16-byte word (r, e, k) of the next row pair.
  const int per = VEC ? tw / 16 : 1;
  const int i = threadIdx.x, r = i / (2 * per), e = (i / per) & 1, k = i % per;
  auto word = [&](int y2) {
    return __ldcs(reinterpret_cast<const uint4*>(row(y2, r) + e * W + x0) + k);
  };
  uint4 next = make_uint4(0, 0, 0, 0);
  if (VEC && i < 6 * per) next = word(blockIdx.y * ROW_PAIRS);

  for (int y2 = blockIdx.y * ROW_PAIRS; y2 < y2_end; ++y2) {
    if (VEC) {                                          // tw % 16 == 0, rows 16-byte aligned
      if (i < 6 * per) {
        reinterpret_cast<uint4*>(in[r][e])[k] = next;
        if (y2 + 1 < y2_end) next = word(y2 + 1);       // in flight while this pair converts
      }
    } else {
      for (int j = threadIdx.x; j < 6 * tw; j += THREADS) {
        const int rj = j / (2 * tw), ej = (j / tw) & 1, kj = j % tw;
        in[rj][ej][kj] = row(y2, rj)[ej * W + x0 + kj];
      }
    }
    __syncthreads();

    const int eye = threadIdx.x / (TW / 2), x = 2 * (threadIdx.x % (TW / 2));
    if (x < tw) {
      const float u = in[2][eye][x], v = in[2][eye][x + 1];
      for (int rr = 0; rr < 2; ++rr) {
        for (int j = 0; j < 2; ++j) {
          float c[3] = {static_cast<float>(in[rr][eye][x + j]), u, v};
          if (RGB) yuv_to_rgb(c[0], u, v, c);
          Out* o = out + (rr * TW + x + j) * 6 + 3 * eye;
          for (int ch = 0; ch < 3; ++ch) store(finish<QUANT>(c[ch]), o + ch);
        }
      }
    }
    __syncthreads();

    Out* d = static_cast<Out*>(dst) + ((static_cast<long long>(b) * H + 2 * y2) * W + x0) * 6;
    const long long row_stride = 6LL * W;               // elements between the two rows
    const int n = tw * 6;                               // elements of one output row
    if (VEC) {
      const int words = n * static_cast<int>(sizeof(Out)) / 16;
      for (int j = threadIdx.x; j < 2 * words; j += THREADS) {
        const int rr = j / words, kk = j - rr * words;
        __stcs(reinterpret_cast<uint4*>(d + rr * row_stride) + kk,
               reinterpret_cast<const uint4*>(out + rr * TW * 6)[kk]);
      }
    } else {
      for (int j = threadIdx.x; j < 2 * n; j += THREADS) {
        const int rr = j / n, kk = j - rr * n;
        d[rr * row_stride + kk] = out[rr * TW * 6 + kk];
      }
    }
    __syncthreads();                                    // the tiles are free for the next pair
  }
}

template <bool RGB, bool QUANT>
void launch(const void* src, void* dst, int B, int H, int W, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((W + TW - 1) / TW),
            static_cast<unsigned>((H / 2 + row_pairs<RGB>() - 1) / row_pairs<RGB>()),
            static_cast<unsigned>(B));
  const bool vec = W % 16 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                    reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec)
    nv12_ingest_kernel<RGB, QUANT, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(src), dst, H, W);
  else
    nv12_ingest_kernel<RGB, QUANT, false><<<grid, THREADS, 0, stream>>>(
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
