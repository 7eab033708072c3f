// w8a8 convolution: implicit GEMM, s8 x s8 -> s32 on the tensor cores, with
// the input quantized on load and the dequant epilogue fused.
//
// Replaces the int8 convolution of the JAX package, an XLA conv with an
// int32 result (hobot_stereonet_tpu/ops/quant.py, _int8_conv at :76 and
// _int8_conv_static at :219); PyTorch offers no s8 x s8 -> s32 conv.
//
// in : x   [N, H, W, Cin]   float32 or bfloat16 (an NCHW tensor in
//                            channels-last memory), unquantized;
//      w   [Cout, K_pad]    int8: [Cout, kh, kw, Cp] flattened and zero
//                            padded to a multiple of 32, Cp = Cin rounded
//                            up to 32 when Cin % 8 == 0, else Cp = Cin;
//      s_k, bias [Cout] float32; sx, qs [N] or [1] float32.
// out: y   [N, Ho, Wo, Cout] float32 or bfloat16, flax "SAME" padding:
//      q   = clip(rint(x / qs[n]), +-127)   (divide = 1, dynamic scales)
//            clip(rint(x * qs), +-127)      (divide = 0, static 1/s_x)
//      y   = fma(float(sum q * w), sx[n] * s_k[c], bias[c]), one rounding.
// The multiply-add and the reciprocal are what XLA compiles the JAX code
// into; they are written with intrinsics so that nvcc's contraction and
// flags do not change them.  Zero padding is exact: q(0) = 0.
//
// GEMM: M = N*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin.  Bound on the
// H100 at the flagship's widths: memory.  A 3x3 32 -> 32 conv does 576
// int8 operations per output value and moves 4 bytes (bf16 in and out),
// 144 operations a byte, below the 590 at which 1979 TOPS and 3.35 TB/s
// balance.  The first conv (Cin = 3, float32 in) reads 12 bytes and
// writes 64 per output pixel.
//
// Design (a first kernel, right and simple): a block of 4 warps computes
// an output tile of 8 rows x 16 columns of one image (each warp two rows),
// for BN (32 or 64) output channels.  For each 32-channel slice of the
// input (all of it when Cin % 8 != 0), the block quantizes the input tile
// the output tile needs (its halo: (8-1)*stride + kh rows by
// (16-1)*stride + kw columns) into shared memory once, beside the weights
// of every tap for that slice; then each warp runs BN/8
// mma.sync.m16n8k32 per row, tap and slice, reading its A fragments
// straight from the quantized tile (the implicit GEMM: no im2col copy) and
// each tap's B fragments once for both rows.  Columns of the tile are
// stored by their remainder modulo the stride, so a warp's 16 pixels of
// one tap lie side by side for stride 2 as for stride 1, and pixels are 48
// bytes apart: the fragment loads are free of bank conflicts.  Cin % 8 == 0
// loads 8 channels at a time; otherwise (the first conv, Cin = 3) the
// reduction runs over (tap, channel) packed densely, K = 75 in 3 steps of
// 32, its fragments gathered byte by byte from the tile.  The epilogue
// stages each warp's 16 x BN outputs of a row in shared memory and writes
// them as 16-byte vectors.  Each input value is quantized once per block
// that reads it (the halo: 1.4x for a 3x3 conv, 5.2x for the 5x5 stride-2
// convs, and once per block of output channels); no int8 copy of the
// activation exists in device memory.  Two rows a warp against one: 14 %
// less time over the flagship's 28 convs on the H100 (bit-equal both).
// Later work: wgmma with TMA, and a pipeline of slices.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int RPW = 2;        // output rows per warp: 8 x 16 pixels a block
constexpr int TW = 16;        // output columns per block: one m16 tile
constexpr int CH = 32;        // input channels per slice (one mma's depth)
constexpr int PITCH = 48;     // bytes between pixels (A) and rows (B) in shared memory
constexpr int THREADS = 32 * WARPS;

struct ConvParams {
  const void* x;
  const int8_t* w;
  const float* s_k;
  const float* bias;
  const float* sx;
  const float* qs;
  void* y;
  int N, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad_t, pad_l, cpt, k_pad;
  int per_sample, divide;
  int IH, IW, IWh, AW, cp4, tiles_h, tiles_w;   // input tile geometry, grid tiling
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t quant_byte(float v, float s, int divide) {
  float t = divide ? __fdiv_rn(v, s) : __fmul_rn(v, s);
  t = fminf(fmaxf(rintf(t), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(t)) & 0xffu;
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s, int divide) {
  return quant_byte(v[0], s, divide) | (quant_byte(v[1], s, divide) << 8) |
         (quant_byte(v[2], s, divide) << 16) | (quant_byte(v[3], s, divide) << 24);
}

__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The block's place: image n, output tile origin (ho0, wo0), channels from n0.
struct Tile {
  int n, ho0, wo0, hi0, wi0, n0;
};

__device__ __forceinline__ Tile tile_of(const ConvParams& p, int bn) {
  Tile t;
  int bx = blockIdx.x;
  const int tw = bx % p.tiles_w;
  bx /= p.tiles_w;
  const int th = bx % p.tiles_h;
  t.n = bx / p.tiles_h;
  t.ho0 = th * WARPS * RPW;
  t.wo0 = tw * TW;
  t.hi0 = t.ho0 * p.stride - p.pad_t;
  t.wi0 = t.wo0 * p.stride - p.pad_l;
  t.n0 = blockIdx.y * bn;
  return t;
}

// Position of tile column col in shared memory: grouped by col % stride.
__device__ __forceinline__ int col_pos(const ConvParams& p, int col) {
  return (col % p.stride) * p.IWh + col / p.stride;
}

// Epilogue: y = fma(float(acc), sx * s_k, bias), rounded once to Tout, staged
// through shared memory (stage: this warp's 16 x BN outputs) and written as
// 16-byte vectors along each pixel's channels.
template <typename Tout, int BN>
__device__ __forceinline__ void epilogue(const ConvParams& p, const Tile& tl, int row,
                                         int acc[][4], Tout* stage) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sxv = p.sx[p.per_sample ? tl.n : 0];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * t, c = tl.n0 + cl;
    if (c >= p.Cout) continue;
    const float m0 = __fmul_rn(sxv, p.s_k[c]), m1 = __fmul_rn(sxv, p.s_k[c + 1]);
    const float b0 = p.bias[c], b1 = p.bias[c + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      Tout* d = stage + (g + 8 * half) * BN + cl;
      d[0] = to_out(__fmaf_rn(__int2float_rn(acc[j][2 * half]), m0, b0), Tout());
      d[1] = to_out(__fmaf_rn(__int2float_rn(acc[j][2 * half + 1]), m1, b1), Tout());
    }
  }
  __syncwarp();
  const int ho = tl.ho0 + row;
  const int nvalid = min(BN, p.Cout - tl.n0);
  constexpr int PER = 16 / sizeof(Tout);             // values per 16-byte vector
  const int vecs = nvalid / PER;
  if (ho >= p.Ho) return;
  for (int u = lane; u < TW * vecs; u += 32) {
    const int px = u / vecs, v = u - px * vecs;
    const int wo = tl.wo0 + px;
    if (wo >= p.Wo) continue;
    const long long m = (static_cast<long long>(tl.n) * p.Ho + ho) * p.Wo + wo;
    *reinterpret_cast<uint4*>(static_cast<Tout*>(p.y) + m * p.Cout + tl.n0 + v * PER) =
        *reinterpret_cast<const uint4*>(stage + px * BN + v * PER);
  }
  __syncwarp();
}

// Cin % 8 == 0: 32-channel slices, 8-channel vector loads.  Each warp
// computes RPW output rows.
template <typename Tin, typename Tout, int BN>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const ConvParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int taps = p.KH * p.KW;
  uint8_t* As = smem;                                   // [IH][AW][PITCH]
  uint8_t* Bs = smem + p.IH * p.AW * PITCH;             // [taps][BN][PITCH]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Tile tl = tile_of(p, BN);
  const float qscale = p.qs[p.per_sample ? tl.n : 0];
  const Tin* xn = static_cast<const Tin*>(p.x) + static_cast<long long>(tl.n) * p.H * p.W * p.Cin;

  int acc[RPW][BN / 8][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[rr][j][0] = acc[rr][j][1] = acc[rr][j][2] = acc[rr][j][3] = 0;

  for (int c0 = 0; c0 < p.cpt; c0 += CH) {
    // The quantized input tile of this slice, 8 channels a unit.
    const int units = p.IH * p.IW * (CH / 8);
    for (int u = tid; u < units; u += THREADS) {
      const int cu = u & 3, pix = u >> 2;
      const int r = pix / p.IW, col = pix - r * p.IW;
      const int hi = tl.hi0 + r, wi = tl.wi0 + col, c = c0 + 8 * cu;
      uint2 q = make_uint2(0u, 0u);
      if (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W && c < p.Cin) {
        float v[8];
        load8(xn + (static_cast<long long>(hi) * p.W + wi) * p.Cin + c, v);
        q = make_uint2(quant4(v, qscale, p.divide), quant4(v + 4, qscale, p.divide));
      }
      *reinterpret_cast<uint2*>(As + (r * p.AW + col_pos(p, col)) * PITCH + 8 * cu) = q;
    }
    // The weights of every tap for this slice: [tap][n][32 bytes].
    for (int u = tid; u < taps * BN * 2; u += THREADS) {
      const int half = u & 1, rn = (u >> 1) % BN, tap = (u >> 1) / BN;
      uint4 b = make_uint4(0u, 0u, 0u, 0u);
      if (tl.n0 + rn < p.Cout)
        b = *reinterpret_cast<const uint4*>(p.w + static_cast<long long>(tl.n0 + rn) * p.k_pad +
                                            tap * p.cpt + c0 + 16 * half);
      *reinterpret_cast<uint4*>(Bs + (tap * BN + rn) * PITCH + 16 * half) = b;
    }
    __syncthreads();
    for (int tap = 0; tap < taps; ++tap) {
      const int r = tap / p.KW, s = tap - r * p.KW;
      const uint8_t* b = Bs + (tap * BN + g) * PITCH + 4 * t;
      uint32_t bf[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        bf[j][0] = lds32(b + 8 * j * PITCH);
        bf[j][1] = lds32(b + 8 * j * PITCH + 16);
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const uint8_t* a = As + (((warp * RPW + rr) * p.stride + r) * p.AW + col_pos(p, s) + g) *
                                    PITCH + 4 * t;
        const uint32_t a0 = lds32(a), a1 = lds32(a + 8 * PITCH);
        const uint32_t a2 = lds32(a + 16), a3 = lds32(a + 8 * PITCH + 16);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) mma_s8(acc[rr][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
    epilogue<Tout, BN>(p, tl, warp * RPW + rr, acc[rr],
                       reinterpret_cast<Tout*>(smem) + warp * TW * BN);
}

// Cin % 8 != 0: all channels in one tile, K = (tap, channel) packed densely.
template <typename Tin, typename Tout, int BN>
__global__ void __launch_bounds__(THREADS) int8_conv_dense_kernel(const ConvParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bpitch = p.k_pad + 16;
  uint8_t* As = smem;                                   // [IH][AW][cp4]
  uint8_t* Bs = smem + ((p.IH * p.AW * p.cp4 + 15) & ~15);   // [BN][k_pad + 16]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Tile tl = tile_of(p, BN);
  const float qscale = p.qs[p.per_sample ? tl.n : 0];
  const Tin* xn = static_cast<const Tin*>(p.x) + static_cast<long long>(tl.n) * p.H * p.W * p.Cin;
  const int K = p.KH * p.KW * p.Cin;

  for (int u = tid; u < p.IH * p.IW * p.Cin; u += THREADS) {
    const int pix = u / p.Cin, c = u - pix * p.Cin;
    const int r = pix / p.IW, col = pix - r * p.IW;
    const int hi = tl.hi0 + r, wi = tl.wi0 + col;
    uint32_t q = 0u;
    if (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W)
      q = quant_byte(to_float(xn[(static_cast<long long>(hi) * p.W + wi) * p.Cin + c]), qscale,
                     p.divide);
    As[(r * p.AW + col_pos(p, col)) * p.cp4 + c] = static_cast<uint8_t>(q);
  }
  for (int u = tid; u < BN * (p.k_pad / 16); u += THREADS) {
    const int rn = u / (p.k_pad / 16), part = u - rn * (p.k_pad / 16);
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    if (tl.n0 + rn < p.Cout)
      b = *reinterpret_cast<const uint4*>(p.w + static_cast<long long>(tl.n0 + rn) * p.k_pad +
                                          16 * part);
    *reinterpret_cast<uint4*>(Bs + rn * bpitch + 16 * part) = b;
  }
  __syncthreads();

  int acc[RPW][BN / 8][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[rr][j][0] = acc[rr][j][1] = acc[rr][j][2] = acc[rr][j][3] = 0;
  for (int k0 = 0; k0 < p.k_pad; k0 += 32) {
    int off[2][4];                              // k0 + 16*hk + 4t + e
    bool ok[2][4];
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 16 * hk + 4 * t + e;
        const int tap = k / p.Cin, c = k - tap * p.Cin;
        const int r = tap / p.KW, s = tap - r * p.KW;
        ok[hk][e] = k < K;
        off[hk][e] = ((r * p.AW) + col_pos(p, s)) * p.cp4 + c;
      }
    const uint8_t* b = Bs + g * bpitch + k0 + 4 * t;
    uint32_t bf[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      bf[j][0] = lds32(b + 8 * j * bpitch);
      bf[j][1] = lds32(b + 8 * j * bpitch + 16);
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const uint8_t* arow = As + ((warp * RPW + rr) * p.stride * p.AW + g) * p.cp4;
      uint32_t a[4];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {       // pixel g, then g + 8
          const uint8_t* base = arow + 8 * hr * p.cp4;
          uint32_t v = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ok[hk][e]) v |= static_cast<uint32_t>(base[off[hk][e]]) << (8 * e);
          a[2 * hk + hr] = v;
        }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mma_s8(acc[rr][j], a[0], a[1], a[2], a[3], bf[j][0], bf[j][1]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
    epilogue<Tout, BN>(p, tl, warp * RPW + rr, acc[rr],
                       reinterpret_cast<Tout*>(smem) + warp * TW * BN);
}

template <typename Tout, int BN>
size_t smem_bytes(const ConvParams& p) {
  const size_t stage = static_cast<size_t>(WARPS) * TW * BN * sizeof(Tout);
  size_t tiles;
  if (p.Cin % 8 == 0)
    tiles = static_cast<size_t>(p.IH) * p.AW * PITCH + static_cast<size_t>(p.KH) * p.KW * BN * PITCH;
  else
    tiles = ((static_cast<size_t>(p.IH) * p.AW * p.cp4 + 15) & ~static_cast<size_t>(15)) +
            static_cast<size_t>(BN) * (p.k_pad + 16);
  return tiles > stage ? tiles : stage;
}

template <typename Tin, typename Tout, int BN>
int launch(ConvParams p, cudaStream_t stream) {
  constexpr int TH = WARPS * RPW;                       // output rows per block
  p.IH = (TH - 1) * p.stride + p.KH;
  p.IW = (TW - 1) * p.stride + p.KW;
  p.IWh = (p.IW + p.stride - 1) / p.stride;
  p.AW = p.stride * p.IWh;
  p.tiles_h = (p.Ho + TH - 1) / TH;
  p.tiles_w = (p.Wo + TW - 1) / TW;
  const size_t bytes = smem_bytes<Tout, BN>(p);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(p.N) * p.tiles_h * p.tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((p.Cout + BN - 1) / BN));
  auto kernel = p.Cin % 8 == 0 ? int8_conv_kernel<Tin, Tout, BN>
                               : int8_conv_dense_kernel<Tin, Tout, BN>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_bn(const ConvParams& p, cudaStream_t stream) {
  return p.Cout <= 32 ? launch<Tin, Tout, 32>(p, stream) : launch<Tin, Tout, 64>(p, stream);
}

}  // namespace

extern "C" int hst_int8_conv(const void* x, const void* w, const void* s_k, const void* bias,
                             const void* sx, const void* qs, void* y, int N, int H, int W,
                             int Cin, int Ho, int Wo, int Cout, int KH, int KW, int stride,
                             int pad_t, int pad_l, int cpt, int k_pad, int per_sample,
                             int divide, int x_bf16, int y_bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || (Cout & 7) || KH <= 0 ||
      KW <= 0 || stride <= 0 || k_pad % CH || k_pad < KH * KW * cpt ||
      (Cin % 8 == 0 && cpt % CH) || (Cin % 8 != 0 && cpt != Cin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvParams p{x, static_cast<const int8_t*>(w), static_cast<const float*>(s_k),
                     static_cast<const float*>(bias), static_cast<const float*>(sx),
                     static_cast<const float*>(qs), y, N, H, W, Cin, Ho, Wo, Cout, KH, KW,
                     stride, pad_t, pad_l, cpt, k_pad, per_sample, divide,
                     0, 0, 0, 0, (Cin + 3) & ~3, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return y_bf16 ? launch_bn<__nv_bfloat16, __nv_bfloat16>(p, s)
                  : launch_bn<__nv_bfloat16, float>(p, s);
  return y_bf16 ? launch_bn<float, __nv_bfloat16>(p, s) : launch_bn<float, float>(p, s);
}
