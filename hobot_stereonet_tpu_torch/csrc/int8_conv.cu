// w8a8 convolution: implicit GEMM, s8 x s8 -> s32 on Hopper's warpgroup
// tensor-core instructions (wgmma), with the input quantized on load and the
// dequant epilogue fused.
//
// Replaces the int8 convolution of the JAX package, an XLA conv with an
// int32 result (hobot_stereonet_tpu/ops/quant.py, _int8_conv at :76 and
// _int8_conv_static at :219); PyTorch offers no s8 x s8 -> s32 conv.
//
// in : x   [N, H, W, Cin]   float32 or bfloat16 (an NCHW tensor in
//                            channels-last memory), unquantized; or
//           [N, D, H, W, Cin] (NCDHW in channels_last_3d) for a 3-D conv;
//      w   pack_weight's layout (ops/kernels/int8_conv.py): for each slice of
//          BN output channels, for each step of 32 along the reduction
//          k = tap * Cp + channel, the wgmma core matrices of a K-major B
//          operand without swizzle;
//      s_k, bias [Cout] float32; sx, qs [N] or [1] float32;
//      plan: struct PlanArgs, the launch plan int8_conv.plan() chose.
// out: y   [N, Ho, Wo, Cout] ([N, D, Ho, Wo, Cout]) float32 or bfloat16, flax
//      "SAME" padding, taps `dil` pixels apart:
//      q   = clip(rint(x / qs[n]), +-127)   (divide = 1, dynamic scales)
//            clip(rint(x * qs), +-127)      (divide = 0, static 1/s_x)
//      y   = fma(float(sum q * w), sx[n] * s_k[c], bias[c]), one rounding.
// The multiply-add and the reciprocal are what XLA compiles the JAX code
// into; they are written with intrinsics so that nvcc's contraction and
// flags do not change them.  Zero padding is exact: q(0) = 0.  Integer sums
// are exact in any order, so the result is bit-equal to the plain version.
//
// GEMM: M = N*(D*)Ho*Wo output pixels, N = Cout, K = (kd*)kh*kw*Cin.  Bound on the
// H100 at the flagship's widths: memory (a 3x3 32 -> 32 conv does 576 int8
// operations per output value against 4 bytes moved, under the 590 at which
// 1979 TOP/s and 3.35 TB/s balance), except the 576-channel mask head, where
// operations and bytes are within 15 % of each other.
//
// Design.  Persistent blocks: the grid holds as many blocks as the SMs keep
// resident; each block owns one slice of BN output channels (all of Cout up
// to 64, the mask head's 576 as 3 x 192) and walks the output tiles of every
// image with a static stride.  The slice's weights go to shared memory once
// per block (pack_weight's block for the slice, copied as it is), with the
// slice's s_k and bias and a table of each tap's offset into the int8 tile.
// A tile is 4 rows x 16 columns: M = 64 pixels, one warpgroup's wgmma; each
// warp owns one row of 16 pixels.
//
// Cin % 8 == 0 (int8_conv_wgmma_kernel): a producer warp loads the input
// halo of each (tile, 32-channel slice) with TMA into a ring of stages, each
// with a full and an empty mbarrier.  The tensor map is 4-D (C, W, H, N)
// over the channels-last input, so its out-of-bounds zero fill gives the
// SAME padding at each image's edge (not the next image's rows) and the zero
// channels past Cin (56 -> 64); both are exact since q(0) = 0.  Two consumer
// warpgroups take alternate tiles and run independently (each its own ring,
// int8 tile and named barrier), so that one's quantize overlaps the other's
// wgmma and epilogue.  The producer fills the two rings in the walk's order;
// a warpgroup waits on every phase of its own ring's barriers in order, so
// the parity it waits for names exactly its item, whatever order the copies
// complete in.  A warpgroup quantizes the stage that has arrived into its
// int8 tile, columns regrouped by their remainder modulo the stride so that
// a warp's 16 pixels of one tap lie side by side, 48 bytes a pixel
// (conflict-free 32-bit fragment loads), releases the stage, then runs
// wgmma.mma_async m64nNk32 s8.s8 -> s32 per tap: A from registers, gathered
// from the int8 tile as mma.sync's m16n8k32 A fragment (each warp's quarter
// of the 64 rows), B, the resident weights, from shared memory through a
// matrix descriptor; taps in groups of 3, two groups in flight.  A stays in
// registers because the implicit GEMM shifts the A window by a tap: four
// output rows of 16 pixels are not the uniform 8-row core-matrix strides
// that a shared-memory A operand needs.  The epilogue stages a warp's 16
// pixels x 64 channels in shared memory and stores 16-byte vectors, while
// the producer already loads the next tiles.
//
// Dilation and 3-D taps (CLASSIC's refinement and cost aggregation; the
// JAX package's rhs_dilation and NDHWC convs) change only what a stage
// holds and where a tap lies in it.  A dilated conv's halo is (th - 1) +
// 2 dil + 1 rows by 15 + 2 dil + 1 columns and tap (r, s) starts r * dil
// rows and s * dil columns in (the offset table); its tiles are 8 rows (two
// wgmma tiles a warp, M = 2) at the slices built for it, so that the wider
// halo is loaded and quantized once for twice the outputs.  A 3-D conv's
// tile is 4 x 16 pixels of one output plane d; its stage is one 5-D TMA
// box (C, W, H, D, N) holding the planes d - 1, d, d + 1, whose zero fill
// past the depth edges is the SAME padding there (q(0) = 0); the int8
// tile stacks the three planes' halos and the table holds 27 taps, so
// the reduction runs 27 steps of 32.  Each (n, d) plane is a separate tile
// of the walk; its tiles stay 4 rows (an 8-row stage of three planes fits
// one block an SM, and measured slower: scripts/torch_int8_tile_rows.py).
// So no im2col and no int32 product reaches device memory, and the
// epilogue stays in the accumulators' registers.
//
// Cin % 8 != 0 (int8_conv_dense_kernel, the first conv, Cin = 3; blocks of
// one warpgroup): the halo rows (6 or 12 bytes a pixel, not a box TMA
// always takes) are copied with 16-byte cp.async along each row, aligned
// down, into a ring of stages filled ahead.  The int8 tile pads each pixel
// to 4 channels and the reduction runs over (tap, 4 channels): 25 x 4 = 100
// -> 128 for 5x5, in 4 wgmma steps, each thread's 4 bytes of an A fragment
// one 32-bit load; the pad channel and the pad taps hold zero weights.
//
// The quantizer rounds with an added 1.5 * 2^23 and divides (dynamic scales)
// by multiplying with RN(1/s), exact but for values near a half-integer,
// which take an exact path after the loop (quantize_n, quotient_code).
// Measured on an H100 (PERF.md): every phase (quantize, wgmma, epilogue)
// costs about as much as the TMA stream itself, and no smem-occupancy or
// ring depth setting moves the time; the warps' instruction latency bounds
// it, at 25-35 % of the byte bound.
//
// The grid holds, per slice, as many blocks as the card keeps resident (the
// runtime's occupancy, asked once per kernel and shared-memory size), at
// most the tiles.  A launch that the card refuses returns its error;
// nothing falls back.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int CONSUMERS = 256;               // TMA path: two consumer warpgroups
constexpr int WG_THREADS = 128;              // a warpgroup; the dense path's block
constexpr int PRODUCER_THREADS = 32;         // one producer warp (TMA path)
constexpr int PITCH = 48;                    // bytes a pixel in the int8 tile, TMA path
constexpr int MAX_STAGES = 3;                // stages of one ring
constexpr int RINGS = 2;                     // TMA path: one ring per consumer warpgroup
constexpr int TILE_ROWS = 4, TILE_COLS = 16; // one wgmma tile (M = 64)
constexpr int PLAN_VERSION = 3;              // int8_conv.PLAN_VERSION
constexpr int EPI_CH = 64;                   // channels of one epilogue pass
constexpr int SMEM_MAX = 232448;
constexpr int BULK_CHUNK = 32768;

// The launch plan: a version and this struct's size (int8_conv.PlanArgs,
// checked by hst_int8_conv), then the fields of int8_conv.Plan in order.
struct PlanArgs {
  int version, size;
  int N, H, W, Cin, Ho, Wo, Cout, KS, stride, pad_t, pad_l, x_bf16, y_bf16, dense, bn,
      n_slices, cpt, slices, k_blocks, taps, th, tw, ih, iw, iwh, aw, bc, rings, stages,
      stage_bytes, row_bytes, aq_pitch, aq_bytes, epi_pitch, w_bytes, off_stage, off_aq,
      off_epi, off_par, off_tab, off_bar, smem, tiles_h, tiles_w, tiles, dil, D, KD, pad_f;
};

struct ConvParams {
  PlanArgs g;
  const void* x;
  const int8_t* w;
  const float* s_k;
  const float* bias;
  const float* sx;
  const float* qs;
  void* y;
  long long x_bytes;
  int per_sample, divide;
};

// ---- shared memory, barriers, copies -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {   // pending < MAX_STAGES
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS) : "memory");
}

// ---- wgmma -----------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma and its wait.
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, the two 16-byte halves of k 128 bytes apart (leading
// byte offset), groups of 8 rows 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n8(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n24(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n48(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// m64nBNk32 on one warpgroup: one instruction for BN <= 64, BN / 64 of N = 64
// on consecutive 64-row blocks of the weights otherwise; d holds their B
// descriptors (descs<BN>).
template <int BN>
constexpr int ND = BN > 64 ? BN / 64 : 1;

template <int BN>
__device__ __forceinline__ void descs(uint32_t b, uint64_t (&d)[ND<BN>]) {
#pragma unroll
  for (int i = 0; i < ND<BN>; ++i) d[i] = b_desc(b + i * 64 * 32);
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int* acc, const uint32_t* a, const uint64_t (&d)[ND<BN>]) {
  if constexpr (BN == 8) wgmma_n8(acc, a, d[0]);
  else if constexpr (BN == 16) wgmma_n16(acc, a, d[0]);
  else if constexpr (BN == 24) wgmma_n24(acc, a, d[0]);
  else if constexpr (BN == 32) wgmma_n32(acc, a, d[0]);
  else if constexpr (BN == 48) wgmma_n48(acc, a, d[0]);
  else {
    static_assert(BN % 64 == 0, "BN is 8, 16, 24, 32, 48 or a multiple of 64");
#pragma unroll
    for (int i = 0; i < BN / 64; ++i) wgmma_n64(acc + 32 * i, a, d[i]);
  }
}

// ---- quantization ------------------------------------------------------------------

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

// The scale of a tile: s = qs[n] and, for the dynamic scheme, r = RN(1 / s).
struct QScale {
  float s, r;
};

__device__ __forceinline__ QScale qscale_of(const ConvParams& p, int n) {
  const float s = p.qs[p.per_sample ? n : 0];
  return QScale{s, p.divide ? __frcp_rn(s) : s};
}

// Codes clip(rint(v / s), +-127) (dynamic) or clip(rint(v * s), +-127)
// (static), without the conversion pipe (FRND, F2I: a sixteenth of the FP32
// rate): c + MAGIC rounds c to an integer, to nearest even, and leaves it in
// the low byte.  The division is exact without dividing for most values:
// y = v * RN(1/s) lies within 3.0000005 * 2^-24 * |y| (under 2.3e-5 for
// |y| <= 127) of the correctly rounded quotient D, so unless c = clip(y,
// +-127) lies within 4e-5 of a half-integer, rint(c) = rint(D) (a clipped c
// needs nothing: D then clips to the same +-127).  Near a half-integer h
// (about one value in 10^4), D is placed against h exactly in double
// precision (quotient_code).  This replaces __fdiv_rn, ten instructions and
// a call per value, with the same codes.  Infinities clip; NaN codes as
// -127, as -inf does (fmaxf drops it), where the plain version keeps NaN.
// Exact for scales s in [2^-125, 2^125], where RN(1/s) is a normal float;
// the dynamic scales are max|x| / 127, at least 1e-12.
constexpr float MAGIC = 12582912.0f;          // 1.5 * 2^23

// rint(RN(v / s)) where v / s lies within 4e-5 of the half-integer nearest c.
// h * s is exact in double (48 bits), and v - h * s too (the two are within
// a factor of 2), so the comparison with h's half-ulp neighbourhoods is
// exact; a tie at half an ulp rounds to h, whose mantissa is even.  No
// division, so no call to the division's slow path.
__device__ __forceinline__ float quotient_code(float v, float s, float c) {
  const float h = floorf(c) + 0.5f, ah = fabsf(h);
  const float away = __fsub_rn(__int_as_float(__float_as_int(ah) + 1), ah);
  const float toward = __fsub_rn(ah, __int_as_float(__float_as_int(ah) - 1));
  const double d = static_cast<double>(v) - static_cast<double>(h) * static_cast<double>(s);
  const double up = 0.5 * static_cast<double>(h > 0.0f ? away : toward) * s;
  const double dn = 0.5 * static_cast<double>(h > 0.0f ? toward : away) * s;
  if (d > up) return __fadd_rn(h, 0.5f);
  if (d < -dn) return __fsub_rn(h, 0.5f);
  return rintf(h);
}

// N values (a multiple of 4) -> N / 4 words of packed codes, branch-free:
// c = clip(t, +-127), b = c + MAGIC, the low byte of b's bits the code.
// Returns whether a value of the dynamic scheme lies near a half-integer;
// the caller then recomputes its values with code_exact after its loop, so
// that the rare path neither interleaves with nor adds registers to this one.
template <int N, bool DIVIDE>
__device__ __forceinline__ bool quantize_n(const float* v, const QScale& q, uint32_t* out) {
  uint32_t b[N];
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float c = fminf(fmaxf(__fmul_rn(v[i], DIVIDE ? q.r : q.s), -127.0f), 127.0f);
    const float bc = __fadd_rn(c, MAGIC);
    if (DIVIDE) near |= fabsf(__fsub_rn(c, __fsub_rn(bc, MAGIC))) > 0.49996f;
    b[i] = __float_as_uint(bc);
  }
#pragma unroll
  for (int w = 0; w < N / 4; ++w)
    out[w] = __byte_perm(__byte_perm(b[4 * w], b[4 * w + 1], 0x0040),
                         __byte_perm(b[4 * w + 2], b[4 * w + 3], 0x0040), 0x5410);
  return near;
}

// One code of the dynamic scheme, exactly (the rare path of quantize_n).
__device__ __forceinline__ uint32_t code_exact(float v, const QScale& q) {
  float c = fminf(fmaxf(__fmul_rn(v, q.r), -127.0f), 127.0f);
  if (fabsf(__fsub_rn(c, __fsub_rn(__fadd_rn(c, MAGIC), MAGIC))) > 0.49996f)
    c = fminf(fmaxf(quotient_code(v, q.s, c), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, MAGIC)) & 0xffu;
}

__device__ __forceinline__ uint32_t codes4_exact(const float* v, const QScale& q) {
  return code_exact(v[0], q) | (code_exact(v[1], q) << 8) | (code_exact(v[2], q) << 16) |
         (code_exact(v[3], q) << 24);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- tiles -------------------------------------------------------------------------

// Tile t of the walk: plane nd = n * D + d (sample n, output plane d; nd =
// n in 2-D), output origin (ho0, wo0), input origin (di0, hi0, wi0).
struct Tile {
  int n, nd, ho0, wo0, di0, hi0, wi0;
};

__device__ __forceinline__ Tile tile_of(const PlanArgs& g, int t) {
  Tile tl;
  const int tw = t % g.tiles_w;
  t /= g.tiles_w;
  const int th = t % g.tiles_h;
  tl.nd = t / g.tiles_h;
  tl.n = tl.nd / g.D;
  tl.di0 = tl.nd - tl.n * g.D - g.pad_f;
  tl.ho0 = th * g.th;
  tl.wo0 = tw * g.tw;
  tl.hi0 = tl.ho0 * g.stride - g.pad_t;
  tl.wi0 = tl.wo0 * g.stride - g.pad_l;
  return tl;
}

// Position of halo column col in the int8 tile: grouped by col % stride
// (stride 1 or 2).
__device__ __forceinline__ int col_pos(const PlanArgs& g, int col) {
  const int sh = g.stride - 1;
  return (col & sh) * g.iwh + (col >> sh);
}

// Shared memory set up once per block: the slice's s_k and bias, and the
// offset into the int8 tile of each tap (kd, r, s) (TMA path: plane kd's
// halo starts kd * ih rows in, taps dil pixels apart) or of each k-step unit
// 8 * kb + 4 * half + t4 (dense path: unit u is tap u / (cpt / 4), channel
// group u % (cpt / 4); units past the taps read tap 0, whose weights there
// are zero).
__device__ __forceinline__ void block_setup(const ConvParams& p, int n0, uint8_t* smem) {
  const PlanArgs& g = p.g;
  float* par = reinterpret_cast<float*>(smem + g.off_par);
  int* tab = reinterpret_cast<int*>(smem + g.off_tab);
  for (int c = threadIdx.x; c < g.bn; c += blockDim.x) {
    const bool ok = n0 + c < g.Cout;
    par[c] = ok ? p.s_k[n0 + c] : 0.0f;
    par[g.bn + c] = ok ? p.bias[n0 + c] : 0.0f;
  }
  if (g.dense) {
    const int cpg = g.cpt / 4;
    for (int u = threadIdx.x; u < 8 * g.k_blocks; u += blockDim.x) {
      int tap = u / cpg;
      const int grp = u - tap * cpg;
      if (tap >= g.taps) tap = 0;
      const int r = tap / g.KS, s = tap - r * g.KS;
      tab[u] = (r * g.aw + col_pos(g, s)) * g.cpt + 4 * grp;
    }
  } else {
    const int plane = g.KS * g.KS;
    for (int tap = threadIdx.x; tap < g.taps; tap += blockDim.x) {
      const int kd = tap / plane, rs = tap - kd * plane, r = rs / g.KS, s = rs - r * g.KS;
      tab[tap] = ((kd * g.ih + r * g.dil) * g.aw + col_pos(g, s * g.dil)) * PITCH;
    }
  }
}

// Epilogue of one warp: its 16 pixels (output row ho0 + orow, columns wo0 ..
// wo0 + 15) x BN channels from n0.  y = fma(float(acc), sx * s_k, bias),
// rounded once, staged EPI_CH channels at a time in shared memory (stage:
// this warp's 16 x epi_pitch bytes) and stored as 16-byte vectors.
template <typename Tout>
__device__ __forceinline__ void store_rows(const ConvParams& p, const Tile& tl, int ho, int c0,
                                           const uint8_t* stage, int vecs) {
  const PlanArgs& g = p.g;
  constexpr int PER = 16 / sizeof(Tout);
  const int lane = threadIdx.x & 31;
  if (ho >= g.Ho) return;
  for (int u = lane; u < 16 * vecs; u += 32) {
    const int px = u / vecs, v = u - px * vecs;
    const int wo = tl.wo0 + px;
    if (wo >= g.Wo) continue;
    const long long m = (static_cast<long long>(tl.nd) * g.Ho + ho) * g.Wo + wo;
    *reinterpret_cast<uint4*>(static_cast<Tout*>(p.y) + m * g.Cout + c0 + v * PER) =
        *reinterpret_cast<const uint4*>(stage + px * g.epi_pitch + v * 16);
  }
}

template <int BN, typename Tout>
__device__ __forceinline__ void epilogue_t(const ConvParams& p, const Tile& tl, int n0, int orow,
                                           const int* acc, uint8_t* stage, const float* par) {
  const PlanArgs& g = p.g;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sxv = p.sx[p.per_sample ? tl.n : 0];
  const int ho = tl.ho0 + orow;
  constexpr int EC = BN < EPI_CH ? BN : EPI_CH;
  constexpr int PER = 16 / sizeof(Tout);
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += EC) {
    const int nvalid = min(EC, g.Cout - n0 - c0);
    if (nvalid <= 0) break;
#pragma unroll
    for (int jj = 0; jj < EC / 8; ++jj) {
      const int j = c0 / 8 + jj, cl = 8 * jj + 2 * t4;
      const float2 sk = *reinterpret_cast<const float2*>(par + c0 + cl);
      const float2 bi = *reinterpret_cast<const float2*>(par + BN + c0 + cl);
      const float m0 = __fmul_rn(sxv, sk.x), m1 = __fmul_rn(sxv, sk.y);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = __fmaf_rn(__int2float_rn(acc[4 * j + 2 * half]), m0, bi.x);
        const float v1 = __fmaf_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), m1, bi.y);
        Tout* d = reinterpret_cast<Tout*>(stage + (g8 + 8 * half) * g.epi_pitch) + cl;
        if constexpr (sizeof(Tout) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(d) =
              __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        } else {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        }
      }
    }
    __syncwarp();
    if (nvalid == EC)
      store_rows<Tout>(p, tl, ho, n0 + c0, stage, EC / PER);
    else
      store_rows<Tout>(p, tl, ho, n0 + c0, stage, nvalid / PER);
    __syncwarp();
  }
}

template <int BN>
__device__ __forceinline__ void epilogue(const ConvParams& p, const Tile& tl, int n0, int orow,
                                         const int* acc, uint8_t* stage, const float* par) {
  if (p.g.y_bf16)
    epilogue_t<BN, __nv_bfloat16>(p, tl, n0, orow, acc, stage, par);
  else
    epilogue_t<BN, float>(p, tl, n0, orow, acc, stage, par);
}

// ---- Cin % 8 == 0: TMA ring, producer warp, two consumer warpgroups ----------

// One stage (KD * ih x iw pixels x bc channels of Tin) -> the int8 tile (KD *
// ih x aw pixels x PITCH bytes, 32 channels, zero past bc), by one warpgroup: thread
// t quantizes the 8 channels 8 * (t % 4) of every 32nd pixel from t / 4, two
// pixels a step.
template <typename Tin, bool DIVIDE>
__device__ __forceinline__ void quantize_stage(const PlanArgs& g, const uint8_t* stage,
                                               uint8_t* aq, const QScale& qs) {
  constexpr int STEP = WG_THREADS / 4;
  const int tid = threadIdx.x % WG_THREADS;
  const Tin* st = reinterpret_cast<const Tin*>(stage) + 8 * (tid & 3);
  uint8_t* dst = aq + 8 * (tid & 3);
  const bool live = 8 * (tid & 3) < g.bc;
  const int dr = STEP / g.iw, dc = STEP - dr * g.iw;
  const int npix = g.KD * g.ih * g.iw;
  int pix = tid >> 2;
  int row = pix / g.iw, col = pix - row * g.iw;
  uint64_t redo = 0;                      // bit j: this thread's j-th pixel needs code_exact
  for (int j = 0; pix < npix; pix += 2 * STEP, j += 2) {
    int row1 = row + dr, col1 = col + dc;
    if (col1 >= g.iw) {
      col1 -= g.iw;
      ++row1;
    }
    const bool two = pix + STEP < npix;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
    if (live) {
      float v[16];
      load8(st + pix * g.bc, v);
      if (two) {
        load8(st + (pix + STEP) * g.bc, v + 8);
      } else {
#pragma unroll
        for (int i = 8; i < 16; ++i) v[i] = 0.0f;
      }
      if (quantize_n<8, DIVIDE>(v, qs, q)) redo |= 1ull << j;
      if (quantize_n<8, DIVIDE>(v + 8, qs, q + 2)) redo |= 2ull << j;
    }
    *reinterpret_cast<uint2*>(dst + (row * g.aw + col_pos(g, col)) * PITCH) =
        make_uint2(q[0], q[1]);
    if (two)
      *reinterpret_cast<uint2*>(dst + (row1 * g.aw + col_pos(g, col1)) * PITCH) =
          make_uint2(q[2], q[3]);
    row = row1 + dr;
    col = col1 + dc;
    if (col >= g.iw) {
      col -= g.iw;
      ++row;
    }
  }
  for (; DIVIDE && redo; redo &= redo - 1) {
    const int px = (tid >> 2) + (__ffsll(static_cast<long long>(redo)) - 1) * STEP;
    const int r = px / g.iw, cl = px - r * g.iw;
    float v[8];
    load8(st + px * g.bc, v);
    *reinterpret_cast<uint2*>(dst + (r * g.aw + col_pos(g, cl)) * PITCH) =
        make_uint2(codes4_exact(v, qs), codes4_exact(v + 4, qs));
  }
}

// A warp's output rows on the dense path: two (orow and orow + 4: two
// M = 64 tiles, whose wgmma chains run side by side) for slices of up to 32
// channels, else one; on the TMA path one (two there cost more in the halo
// of a 5x5 stride-2 conv than they gain), or two for a dilated conv at the
// slices TALL names.  wgmma steps per commit group (two groups in flight):
// fewer with two tiles, for the registers.
template <int BN>
constexpr int DENSE_MT = BN <= 32 ? 2 : 1;
template <int BN>
constexpr bool TALL = BN == 8 || BN == 16 || BN == 32;   // int8_conv.TALL_BN
template <int M>
constexpr int GROUP = M == 2 ? 2 : 3;

template <int G, int M>
__device__ __forceinline__ void keep_live(uint32_t (&a)[G][M][4]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][m][j]));
}

template <int BN, int M>
__device__ __forceinline__ void fence_all(int (&acc)[M][BN / 2]) {
#pragma unroll
  for (int m = 0; m < M; ++m) fence_acc<BN / 2>(acc[m]);
}

// The wgmma of `steps` steps of 32 along k on this warpgroup's M tiles of
// 64 pixels, in groups of GROUP: step(j, r) loads step j's A fragment of
// each tile into r and returns the shared address of its B block.  Two
// groups are in flight: a group's A registers are loaded again only after
// wgmma.wait_group 1 has retired it, and kept live until then so that the
// two groups' registers stay apart.
template <int BN, int M, typename Step>
__device__ __forceinline__ void mma_steps(int steps, const Step& step, int (&acc)[M][BN / 2]) {
  constexpr int G = GROUP<M>;
  uint32_t a0[G][M][4], a1[G][M][4];
  uint64_t d0[G][ND<BN>], d1[G][ND<BN>];
  for (int s0 = 0; s0 < steps; s0 += 2 * G) {
    if (s0 > 0) {
      wg_wait_one();
      keep_live(a0);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) descs<BN>(step(min(s0 + i, steps - 1), a0[i]), d0[i]);
    fence_all<BN, M>(acc);
    wg_fence();
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (s0 + i < steps)
#pragma unroll
        for (int m = 0; m < M; ++m) wgmma_bn<BN>(acc[m], a0[i][m], d0[i]);
    wg_commit();
    if (s0 + G < steps) {
      if (s0 > 0) {
        wg_wait_one();
        keep_live(a1);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) descs<BN>(step(min(s0 + G + i, steps - 1), a1[i]), d1[i]);
      fence_all<BN, M>(acc);
      wg_fence();
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (s0 + G + i < steps)
#pragma unroll
          for (int m = 0; m < M; ++m) wgmma_bn<BN>(acc[m], a1[i][m], d1[i]);
      wg_commit();
    }
  }
  wg_wait_all();
  fence_all<BN, M>(acc);
  keep_live(a0);
  keep_live(a1);
}

template <int BN, int M>
__global__ void __launch_bounds__(CONSUMERS + PRODUCER_THREADS, BN <= 64 ? 2 : 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap, const ConvParams p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const PlanArgs& g = p.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = blockIdx.x % g.n_slices, blk = blockIdx.x / g.n_slices;
  const int nblk = gridDim.x / g.n_slices;
  // Stage wg * stages + i % stages holds item i of warpgroup wg's ring.
  const int nstage = RINGS * g.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.off_bar);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + nstage);
  const uint32_t wbar = smem_u32(bars + 2 * nstage);
  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG_THREADS / 32);   // the warps of the ring's warpgroup
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  block_setup(p, ns * BN, smem);
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // Producer: the slice's weights once, then the halo of every (tile,
    // slice), the walk's j-th tile into the ring of warpgroup j % 2 as its
    // items (j / 2) * slices + c; a 3-D conv's KD planes as one 5-D box.
    if (lane == 0) {
      mbar_expect_tx(wbar, g.w_bytes);
      const int8_t* src = p.w + static_cast<long long>(ns) * g.w_bytes;
      for (int off = 0; off < g.w_bytes; off += BULK_CHUNK)
        bulk_load(smem_u32(smem) + off, src + off, min(BULK_CHUNK, g.w_bytes - off), wbar);
      const uint32_t box = g.KD * g.ih * g.iw * g.bc * (g.x_bf16 ? 2 : 4);
      const bool planes = g.D > 1 || g.KD > 1;
      for (int j = 0, t = blk; t < g.tiles; t += nblk, ++j) {
        const Tile tl = tile_of(g, t);
        for (int c = 0; c < g.slices; ++c) {
          const int i = (j >> 1) * g.slices + c, s = (j & 1) * g.stages + i % g.stages;
          const uint32_t dst = smem_u32(smem + g.off_stage + s * g.stage_bytes);
          mbar_wait(empty0 + 8 * s, ((i / g.stages) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, box);
          if (planes)
            tma_load_5d(dst, &tmap, full0 + 8 * s, 32 * c, tl.wi0, tl.hi0, tl.di0, tl.n);
          else
            tma_load_4d(dst, &tmap, full0 + 8 * s, 32 * c, tl.wi0, tl.hi0, tl.n);
        }
      }
    }
    return;
  }

  // Consumers: the two warpgroups take alternate tiles of the walk and run
  // independently (each its own ring, int8 tile and barrier), so that one's
  // quantize overlaps the other's wgmma and epilogue.  Per tile and slice:
  // quantize the stage, wgmma per tap; per tile: the epilogue.
  const int wg = warp >> 2, orow = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  uint8_t* epi = smem + g.off_epi + warp * 16 * g.epi_pitch;
  uint8_t* aq = smem + g.off_aq + wg * g.aq_bytes;
  const float* par = reinterpret_cast<const float*>(smem + g.off_par);
  const int* tab = reinterpret_cast<const int*>(smem + g.off_tab);
  const uint32_t bs = smem_u32(smem);
  // A of tap t for the warp's m-th wgmma tile: its 16 pixels, row (orow +
  // 4 m) * stride + r, columns col_pos(s) onward (tab[t]); B: k-block
  // t * slices + c.
  const uint8_t* arow = aq + (orow * g.stride * g.aw + g8) * PITCH + 4 * t4;
  const int mrow = TILE_ROWS * g.stride * g.aw * PITCH;
  const int ntile = (g.tiles - blk + nblk - 1) / nblk;
  int acc[M][BN / 2];
  mbar_wait(wbar, 0);
  for (int j = wg; j < ntile; j += 2) {
    const Tile tl = tile_of(g, blk + j * nblk);
    const QScale qs = qscale_of(p, tl.n);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;
    for (int c = 0; c < g.slices; ++c) {
      const int i = (j >> 1) * g.slices + c, s = wg * g.stages + i % g.stages;
      const uint8_t* stage = smem + g.off_stage + s * g.stage_bytes;
      mbar_wait(full0 + 8 * s, (i / g.stages) & 1);
      if (g.x_bf16)
        p.divide ? quantize_stage<__nv_bfloat16, true>(g, stage, aq, qs)
                 : quantize_stage<__nv_bfloat16, false>(g, stage, aq, qs);
      else
        p.divide ? quantize_stage<float, true>(g, stage, aq, qs)
                 : quantize_stage<float, false>(g, stage, aq, qs);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      warpgroup_sync(wg);
      mma_steps<BN, M>(g.taps, [&](int tap, uint32_t (&r)[M][4]) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const uint8_t* ap = arow + m * mrow + tab[tap];
          r[m][0] = lds32(ap);
          r[m][1] = lds32(ap + 8 * PITCH);
          r[m][2] = lds32(ap + 16);
          r[m][3] = lds32(ap + 8 * PITCH + 16);
        }
        return bs + (tap * g.slices + c) * (BN * 32);
      }, acc);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      epilogue<BN>(p, tl, ns * BN, orow + TILE_ROWS * m, acc[m], epi, par);
  }
}

// ---- Cin % 8 != 0: the dense first conv ------------------------------------------

// The halo rows of tile tl into a stage: 16-byte cp.async along each row's
// valid span, aligned down to 16 bytes (chunk j of row r at r * row_bytes +
// 16 j); a chunk that would reach outside the input tensor is copied byte by
// byte.
__device__ __forceinline__ void load_rows(const ConvParams& p, const Tile& tl, uint8_t* stage) {
  const PlanArgs& g = p.g;
  const int xb = g.x_bf16 ? 2 : 4;
  const int lo = max(tl.wi0, 0), hi = min(tl.wi0 + g.iw, g.W);
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t end = base + p.x_bytes;
  if (lo >= hi) return;
  const int cpr = g.row_bytes / 16;
  const int dr = WG_THREADS / cpr, dc = WG_THREADS - dr * cpr;
  int r = threadIdx.x / cpr, j = threadIdx.x - r * cpr;
  for (; r < g.ih; r += dr, j += dc) {
    if (j >= cpr) {
      j -= cpr;
      if (++r >= g.ih) break;
    }
    const int h = tl.hi0 + r;
    if (h < 0 || h >= g.H) continue;
    const long long row = (static_cast<long long>(tl.n) * g.H + h) * g.W;
    const uintptr_t a = base + static_cast<uintptr_t>((row + lo) * g.Cin * xb);
    const uintptr_t b = base + static_cast<uintptr_t>((row + hi) * g.Cin * xb);
    const uintptr_t chunk = (a & ~static_cast<uintptr_t>(15)) + 16 * j;
    if (chunk >= b) continue;
    uint8_t* dst = stage + r * g.row_bytes + 16 * j;
    if (chunk >= base && chunk + 16 <= end) {
      cp_async16(smem_u32(dst), reinterpret_cast<const void*>(chunk));
    } else {
      for (int e = 0; e < 16; ++e)
        if (chunk + e >= base && chunk + e < end)
          dst[e] = *reinterpret_cast<const uint8_t*>(chunk + e);
    }
  }
}

// A stage -> the int8 tile: ih x aw pixels of cpt bytes (channels padded to
// a multiple of 4 with zeros), one pixel a thread and step.
template <typename Tin, bool DIVIDE>
__device__ __forceinline__ void quantize_rows(const ConvParams& p, const Tile& tl,
                                              const uint8_t* stage, uint8_t* aq,
                                              const QScale& qs) {
  const PlanArgs& g = p.g;
  const int cpg = g.cpt / 4;
  const int lo = max(tl.wi0, 0), hi = min(tl.wi0 + g.iw, g.W);
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.x);
  const int npix = g.ih * g.iw;
  const int dr = WG_THREADS / g.iw, dc = WG_THREADS - dr * g.iw;
  int pix = threadIdx.x;
  int r = pix / g.iw, col = pix - r * g.iw;
  for (; pix < npix; pix += WG_THREADS) {
    const int h = tl.hi0 + r, w = tl.wi0 + col;
    uint8_t* dst = aq + (r * g.aw + col_pos(g, col)) * g.cpt;
    if (h >= 0 && h < g.H && w >= lo && w < hi) {
      // The row's first valid byte modulo 16 (load_rows aligned it down);
      // 32-bit products keep the low bits.
      const uint32_t a = static_cast<uint32_t>(base) +
          ((static_cast<uint32_t>(tl.n) * g.H + h) * g.W + lo) * g.Cin * sizeof(Tin);
      const Tin* src = reinterpret_cast<const Tin*>(stage + r * g.row_bytes + (a & 15)) +
                       (w - lo) * g.Cin;
      for (int grp = 0; grp < cpg; ++grp) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = 4 * grp + e < g.Cin ? to_float(src[4 * grp + e]) : 0.0f;
        if (quantize_n<4, DIVIDE>(v, qs, reinterpret_cast<uint32_t*>(dst + 4 * grp)))
          *reinterpret_cast<uint32_t*>(dst + 4 * grp) = codes4_exact(v, qs);
      }
    } else {
      for (int grp = 0; grp < cpg; ++grp) *reinterpret_cast<uint32_t*>(dst + 4 * grp) = 0u;
    }
    r += dr;
    col += dc;
    if (col >= g.iw) {
      col -= g.iw;
      ++r;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS) int8_conv_dense_kernel(const ConvParams p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const PlanArgs& g = p.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = blockIdx.x % g.n_slices, blk = blockIdx.x / g.n_slices;
  const int nblk = gridDim.x / g.n_slices;
  const uint4* src = reinterpret_cast<const uint4*>(p.w + static_cast<long long>(ns) * g.w_bytes);
  for (int u = tid; u < g.w_bytes / 16; u += WG_THREADS) reinterpret_cast<uint4*>(smem)[u] = src[u];
  block_setup(p, ns * BN, smem);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma
  __syncthreads();

  const int orow = warp;
  const int g8 = lane >> 2, t4 = lane & 3;
  uint8_t* epi = smem + g.off_epi + warp * 16 * g.epi_pitch;
  const float* par = reinterpret_cast<const float*>(smem + g.off_par);
  const int* tab = reinterpret_cast<const int*>(smem + g.off_tab);
  const uint32_t bs = smem_u32(smem);
  constexpr int M = DENSE_MT<BN>;
  const int mrow = 4 * g.stride * g.aw * g.cpt;
  int acc[M][BN / 2];
  for (int i = 0; i + 1 < g.stages; ++i) {
    const int t = blk + i * nblk;
    if (t < g.tiles) load_rows(p, tile_of(g, t), smem + g.off_stage + i * g.stage_bytes);
    cp_async_commit();
  }
  int i = 0;
  for (int t = blk; t < g.tiles; t += nblk, ++i) {
    const int tn = t + (g.stages - 1) * nblk;
    if (tn < g.tiles)
      load_rows(p, tile_of(g, tn),
                smem + g.off_stage + ((i + g.stages - 1) % g.stages) * g.stage_bytes);
    cp_async_commit();
    cp_async_wait(g.stages - 1);
    __syncthreads();
    const Tile tl = tile_of(g, t);
    const QScale qs = qscale_of(p, tl.n);
    uint8_t* aq = smem + g.off_aq + (i & 1) * g.aq_bytes;
    const uint8_t* stage = smem + g.off_stage + (i % g.stages) * g.stage_bytes;
    if (g.x_bf16)
      p.divide ? quantize_rows<__nv_bfloat16, true>(p, tl, stage, aq, qs)
               : quantize_rows<__nv_bfloat16, false>(p, tl, stage, aq, qs);
    else
      p.divide ? quantize_rows<float, true>(p, tl, stage, aq, qs)
               : quantize_rows<float, false>(p, tl, stage, aq, qs);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[m][j] = 0;
    // Step kb: each thread's 4 bytes are unit 8 kb + 4 h + t4 of k (tab).
    const uint8_t* arow = aq + (orow * g.stride * g.aw + g8) * g.cpt;
    mma_steps<BN, M>(g.k_blocks, [&](int kb, uint32_t (&r)[M][4]) {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* ap = arow + m * mrow + tab[8 * kb + 4 * h + t4];
          r[m][2 * h] = lds32(ap);
          r[m][2 * h + 1] = lds32(ap + 8 * g.cpt);
        }
      return bs + kb * (BN * 32);
    }, acc);
#pragma unroll
    for (int m = 0; m < M; ++m) epilogue<BN>(p, tl, ns * BN, orow + 4 * m, acc[m], epi, par);
  }
}

// ---- host --------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The blocks of a kernel that the card keeps resident at smem bytes of
// shared memory, asked of the runtime once per (device, kernel, smem).
struct Resident {
  int dev;
  const void* fn;
  int smem, blocks;
};
std::mutex resident_lock;
std::vector<Resident> resident_known;

int resident_blocks(const void* fn, int threads, int smem, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> hold(resident_lock);
  for (const Resident& r : resident_known)
    if (r.dev == dev && r.fn == fn && r.smem == smem) {
      *blocks = r.blocks;
      return 0;
    }
  int sms = 0, occ = 0;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)) !=
          cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem)) !=
          cudaSuccess)
    return static_cast<int>(e);
  if (occ <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  resident_known.push_back(Resident{dev, fn, smem, sms * occ});
  *blocks = sms * occ;
  return 0;
}

// Blocks per slice: as many as the card keeps resident, at most the tiles.
int grid_of(const void* fn, const PlanArgs& g, int threads, int* grid) {
  int resident = 0;
  const int err = resident_blocks(fn, threads, g.smem, &resident);
  if (err != 0) return err;
  *grid = min(g.tiles, max(1, resident / g.n_slices)) * g.n_slices;
  return 0;
}

template <int BN, int M>
int launch_tma(const ConvParams& p, const CUtensorMap& map, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(int8_conv_wgmma_kernel<BN, M>);
  int grid = 0;
  const int err = grid_of(fn, p.g, CONSUMERS + PRODUCER_THREADS, &grid);
  if (err != 0) return err;
  int8_conv_wgmma_kernel<BN, M><<<grid, CONSUMERS + PRODUCER_THREADS, p.g.smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch(const ConvParams& p, cudaStream_t stream) {
  const PlanArgs& g = p.g;
  int grid = 0, err = 0;
  if (g.dense) {
    // The tile the kernel's warps are laid out for.
    if (g.th != TILE_ROWS * DENSE_MT<BN> || g.tw != TILE_COLS)
      return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = reinterpret_cast<const void*>(int8_conv_dense_kernel<BN>);
    if ((err = grid_of(fn, g, WG_THREADS, &grid)) != 0) return err;
    int8_conv_dense_kernel<BN><<<grid, WG_THREADS, g.smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (g.tw != TILE_COLS || (g.th != TILE_ROWS && !(TALL<BN> && g.th == 2 * TILE_ROWS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // (C, W, H, N), or (C, W, H, D, N) when a stage spans input planes.
  const cuuint32_t rank = g.D > 1 || g.KD > 1 ? 5 : 4;
  const cuuint64_t xb = g.x_bf16 ? 2 : 4;
  cuuint64_t dims[5] = {static_cast<cuuint64_t>(g.Cin), static_cast<cuuint64_t>(g.W),
                        static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.N), 1};
  cuuint32_t box[5] = {static_cast<cuuint32_t>(g.bc), static_cast<cuuint32_t>(g.iw),
                       static_cast<cuuint32_t>(g.ih), 1u, 1u};
  if (rank == 5) {
    dims[3] = static_cast<cuuint64_t>(g.D);
    dims[4] = static_cast<cuuint64_t>(g.N);
    box[3] = static_cast<cuuint32_t>(g.KD);
  }
  cuuint64_t strides[4];
  strides[0] = dims[0] * xb;
  for (cuuint32_t i = 1; i + 1 < rank; ++i) strides[i] = strides[i - 1] * dims[i];
  const cuuint32_t ones[5] = {1u, 1u, 1u, 1u, 1u};
  CUtensorMap map;
  const CUresult r = encode(&map, g.x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            rank, const_cast<void*>(p.x), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (TALL<BN>) {
    if (g.th == 2 * TILE_ROWS) return launch_tma<BN, 2>(p, map, stream);
  }
  return launch_tma<BN, 1>(p, map, stream);
}

}  // namespace

extern "C" int hst_int8_conv(const void* x, const void* w, const void* s_k, const void* bias,
                             const void* sx, const void* qs, void* y, const void* plan,
                             int per_sample, int divide, void* stream) {
  const PlanArgs& g = *static_cast<const PlanArgs*>(plan);
  // What a plan from another version, or a wrong one, would break: the
  // struct's layout, the shapes, the shared memory, the stages the barriers
  // and cp.async groups count, the rings of the two warpgroups, the box
  // and int8 tile of the TMA path (the quantizer's per-thread mask holds 64
  // pixels a thread) and its taps, the dense path's aligned rows (2-D,
  // undilated).
  if (g.version != PLAN_VERSION || g.size != static_cast<int>(sizeof(PlanArgs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = !g.dense;
  if (g.N <= 0 || g.H <= 0 || g.W <= 0 || g.Cin <= 0 || g.Cout <= 0 || (g.Cout & 7) ||
      g.KS <= 0 || g.stride <= 0 || g.smem > SMEM_MAX || g.stages < 1 ||
      g.stages > MAX_STAGES || g.rings != (tma ? RINGS : 1) || g.n_slices * g.bn < g.Cout ||
      g.tiles <= 0 || g.w_bytes % 16 || g.dil < 1 || g.D < 1 || g.KD < 1 || g.pad_f < 0 ||
      (tma && (g.Cin % 8 || g.bc <= 0 || g.bc > 32 || g.aq_pitch != PITCH ||
               g.KD * g.ih * g.iw > 64 * (WG_THREADS / 4) || g.taps != g.KD * g.KS * g.KS ||
               reinterpret_cast<uintptr_t>(x) % 16)) ||
      (!tma && (g.cpt % 4 || g.aq_pitch != g.cpt || g.row_bytes % 16 || g.dil != 1 ||
                g.D != 1 || g.KD != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvParams p;
  p.g = g;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.s_k = static_cast<const float*>(s_k);
  p.bias = static_cast<const float*>(bias);
  p.sx = static_cast<const float*>(sx);
  p.qs = static_cast<const float*>(qs);
  p.y = y;
  p.x_bytes = static_cast<long long>(g.N) * g.D * g.H * g.W * g.Cin * (g.x_bf16 ? 2 : 4);
  p.per_sample = per_sample;
  p.divide = divide;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.bn) {
    case 8: return launch<8>(p, s);
    case 16: return launch<16>(p, s);
    case 24: return launch<24>(p, s);
    case 32: return launch<32>(p, s);
    case 48: return launch<48>(p, s);
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 192: return launch<192>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
