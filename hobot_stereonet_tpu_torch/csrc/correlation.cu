// Dot-product correlation volume of two feature maps.
//
// Replaces the Pallas kernel correlation_volume_pallas
// (hobot_stereonet_tpu/ops/pallas/correlation.py:66, body _corr_kernel at
// :40); the JAX package serves the same function through XLA
// (hobot_stereonet_tpu/ops/cost_volume.py:63-93).
//
//   G[b,y,x,j]   = sum_c fl[b,y,x,c] * fr[b,y,j,c]            (f32 sum)
//   out[b,y,x,d] = T( T(G[b,y,x,x-d]) / divisor ),  0 where x < d
//
// T rounds to the features' type and divisor is sqrt(C) rounded to it (the
// wrapper passes it), so the volume is rounded where the reference rounds
// it: the Gram matrix is materialised in the features' type, then divided
// by a divisor of that type.
//
// fl, fr: [B,H,W,C] and out: [B,H,W,D], all contiguous, bf16 or f32.
//
// bf16 (the main path): tensor cores.
//   Bound on the H100: memory.  At B=8, H=90, W=160, C=32, D=24 the kernel
//   must read 14.7 MB and write 5.5 MB: 20.2 MB, 6.0 us at 3.35 TB/s
//   (81.1 MB, 24.2 us at B=32).  The band's 0.16 GFLOP (B=8) is nothing at
//   the tensor cores' 989 TFLOP/s.
//   Design: one warp per 16 output columns x0..x0+15 of one (b, y) row,
//   four warps to a block, and no barrier between warps, so that one
//   warp's loads overlap another's products and stores (a block per row,
//   with a block-wide barrier between its load, product and store phases,
//   was slower at B=8 on the H100).  The warp copies its 16 fl columns and the fr
//   columns they match, x0-D+1..x0+15 (39 at D=24, staged as five n8
//   tiles: 40 rows), into shared memory with 16-byte cp.async; zeros stand
//   for columns outside [0, W).  Neighbouring warps read overlapping fr
//   columns, which L2 serves.  Rows are padded by 16 bytes, an odd number
//   of 16-byte units, so that ldmatrix reads 8 rows from 8 distinct groups
//   of banks.  The warp computes its 16x40 Gram tile with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), C/16 k-steps, both
//   operands by ldmatrix: fl rows are A row-major and fr rows are B
//   "col"-major as they lie, channel-last, so nothing is transposed.  It
//   walks the n8 tiles one at a time, 4 accumulators live.  The products
//   outside the band cost nothing that shows at the tensor cores' rate.
//   The epilogue takes the band G[x, x-d] from the accumulator fragments,
//   rounds, divides, rounds, stages the [16, D] result in shared memory
//   and writes it as 768 contiguous bytes with 16-byte stores.  It divides
//   by multiplying with the correctly rounded reciprocal of the bf16
//   divisor: once rounded to bf16 the result equals the true division's
//   for every finite bf16 Gram value and every C up to 512 (checked
//   exhaustively in tests/test_torch_kernels.py): a quotient of two 8-bit
//   significands never lies within 2**-17 (relative) of a bf16 rounding
//   boundary, and the product is within 2**-23 of the quotient.
//   Not wgmma: its 64-row tiles do not divide W=160 and the kernel is bound
//   by bytes, not by tensor-core operations.
//
// f32 (the reference phase only): SIMT, full f32 (no TF32).  One block per
//   (row, 32-column tile); fl for the tile and fr with its D-1 columns of
//   halo are staged in shared memory as f32 rows padded by one float, and
//   each thread computes (x, d) dot products in the order of the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16, tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), f32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kWarpsPerBlock = 4;

// A warp's shared memory: fl rows x0..x0+15, fr rows x0-D+1..x0-D+8*n_tiles
// (pitch 2C + 16 bytes each), then the [16][D] output stage.
__host__ __device__ inline int warp_smem_bytes(int C, int D, int n_tiles) {
  return (16 + n_tiles * 8) * (2 * C + 16) + ((16 * D * 2 + 15) / 16) * 16;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
correlation_bf16_kernel(const __nv_bfloat16* __restrict__ fl,
                        const __nv_bfloat16* __restrict__ fr,
                        __nv_bfloat16* __restrict__ out,
                        int H, int W, int C, int D, int n_tiles, float divisor,
                        long long tiles_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = 2 * C + 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* fl_s = smem + warp * warp_smem_bytes(C, D, n_tiles);
  unsigned char* fr_s = fl_s + 16 * pitch;
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(fr_s + n_tiles * 8 * pitch);

  const long long tile = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (tile >= tiles_total) return;
  const int tiles_x = (W + 15) / 16;
  const long long row = tile / tiles_x;
  const int x0 = static_cast<int>(tile - row * tiles_x) * 16;
  const __nv_bfloat16* fl_row = fl + row * W * C;
  const __nv_bfloat16* fr_row = fr + row * W * C;

  const int units = C / 8;
  const int rows_per_pass = 32 / units;
  const int r0 = lane / units, u = lane - r0 * units;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (r0 < rows_per_pass) {
    for (int r = r0; r < 16; r += rows_per_pass) {
      void* dst = fl_s + r * pitch + u * 16;
      const int x = x0 + r;
      if (x < W) cp_async16(dst, fl_row + static_cast<long long>(x) * C + u * 8);
      else *static_cast<uint4*>(dst) = zero;
    }
    for (int r = r0; r < n_tiles * 8; r += rows_per_pass) {
      void* dst = fr_s + r * pitch + u * 16;
      const int x = x0 - (D - 1) + r;
      if (x >= 0 && x < W) cp_async16(dst, fr_row + static_cast<long long>(x) * C + u * 8);
      else *static_cast<uint4*>(dst) = zero;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const float inv_divisor = __frcp_rn(divisor);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const unsigned char* a_row = fl_s + (lane & 15) * pitch + (lane >> 4) * 16;
  const unsigned char* b_row = fr_s + (lane & 7) * pitch + ((lane >> 3) & 1) * 16;
  for (int nt = 0; nt < n_tiles; ++nt) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < C; k += 16) {
      uint32_t a[4], b[2];
      ldmatrix_x4(a, a_row + k * 2);
      ldmatrix_x2(b, b_row + nt * 8 * pitch + k * 2);
      mma_bf16_16816(acc, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i >> 1) * 8;
      const int d = r + D - 1 - (nt * 8 + t2 + (i & 1));
      if (static_cast<unsigned>(d) >= static_cast<unsigned>(D)) continue;
      const float v = __bfloat162float(__float2bfloat16_rn(acc[i])) * inv_divisor;
      out_s[r * D + d] = __float2bfloat16_rn(x0 + r >= d ? v : 0.0f);
    }
  }
  __syncwarp();
  const int cols = min(16, W - x0);
  __nv_bfloat16* dst = out + (row * W + x0) * D;
  const int n = cols * D;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 7) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(out_s);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < n / 8; i += 32) dst4[i] = src4[i];
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = out_s[i];
  }
}

int launch_bf16(const void* fl, const void* fr, void* out, int B, int H, int W, int C,
                int D, float divisor, cudaStream_t stream) {
  const int n_tiles = (15 + D + 7) / 8;          // n8 tiles over x0-D+1 .. x0+15
  if (C % 16 != 0 || C > 256 ||
      (reinterpret_cast<uintptr_t>(fl) & 15) || (reinterpret_cast<uintptr_t>(fr) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * warp_smem_bytes(C, D, n_tiles);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(correlation_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>(B) * H * ((W + 15) / 16);
  const long long blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  correlation_bf16_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(fl), static_cast<const __nv_bfloat16*>(fr),
      static_cast<__nv_bfloat16*>(out), H, W, C, D, n_tiles, divisor, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32, SIMT

constexpr int kTileX = 32;
constexpr int kThreads = 256;

__global__ void correlation_f32_kernel(const float* __restrict__ fl,
                                       const float* __restrict__ fr,
                                       float* __restrict__ out,
                                       int H, int W, int C, int D, float divisor) {
  extern __shared__ float smem_f[];
  const int stride = C + 1;                 // padded row: fewer bank conflicts
  const int fr_rows = kTileX + D - 1;
  float* fl_s = smem_f;                     // [kTileX][stride]
  float* fr_s = smem_f + kTileX * stride;   // [fr_rows][stride]

  const int x0 = blockIdx.x * kTileX;
  const long long row = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const float* fl_row = fl + row * W * C;
  const float* fr_row = fr + row * W * C;

  // Stage fl[x0 .. x0+kTileX) and fr[x0-D+1 .. x0+kTileX), zero outside [0, W).
  for (int i = threadIdx.x; i < kTileX * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int x = x0 + r;
    fl_s[r * stride + c] = x < W ? fl_row[static_cast<long long>(x) * C + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < fr_rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int x = x0 - (D - 1) + r;
    fr_s[r * stride + c] = (x >= 0 && x < W) ? fr_row[static_cast<long long>(x) * C + c] : 0.0f;
  }
  __syncthreads();

  float* out_row = out + row * W * D;
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
    out_row[static_cast<long long>(x) * D + d] = __fdiv_rn(acc, divisor);
  }
}

int launch_f32(const void* fl, const void* fr, void* out, int B, int H, int W, int C,
               int D, float divisor, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * kTileX + D - 1) * (C + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(correlation_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + kTileX - 1) / kTileX, H, B);
  correlation_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(fl), static_cast<const float*>(fr), static_cast<float*>(out),
      H, W, C, D, divisor);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward

// The vector-Jacobian product of the volume (hst_correlation_backward), as
// jax.vjp differentiates build_correlation_volume
// (hobot_stereonet_tpu/ops/cost_volume.py:83-93):
//
//   g[x,d]    = T( dcorr[x,d] * f32(1 / divisor) ),  0 where x < d
//   dfl[x,c]  = T( sum_d g[x,d]   * fr[x-d,c] )                  (f32 sum)
//   dfr[x',c] = T( sum_d g[x'+d,d] * fl[x'+d,c] ),  x'+d < W
//
// XLA divides the cotangent by the constant divisor as a multiply by its
// float32 reciprocal, rounded to the features' type T; the Gram matrix's
// transpose then sums bf16 products in f32 and rounds once.
//
// Bound on the H100: memory.  At B=8, H=90, W=160, C=32, D=24 (bf16) it
// must read dcorr, fl and fr and write dfl and dfr, B*H*W*(D + 4C)*2 bytes
// = 35.0 MB, 10.4 us at 3.35 TB/s; its 4*B*H*W*D*C = 0.35 GFLOP are nothing
// at the tensor cores' rate.
//
// bf16 where it fits (the main path; C % 16 == 0, C <= 256, D <= 49, fl, fr,
// dfl and dfr 16-byte aligned; the wrapper's correlation_backward_route
// decides and passes mma = 1): tensor cores.  Both gradients are banded products over
// one image row, dfl = A fr and dfr = A^T fl with A[x, x'] = g[x, x - x'] for
// 0 <= x - x' < D.  The forward's structure: one warp per 16 output columns
// x0..x0+15 of one (b, y) row, and no barrier between warps.  The warp copies
// with 16-byte cp.async the dcorr rows x0 .. x0+D+14 (one contiguous span;
// 2-byte loads where D % 8 != 0 or dcorr is not 16-byte aligned), the fr rows
// x0-D+1 .. x0+15 that dfl needs and the fl rows x0 .. x0+D+14 that dfr
// needs, as bf16 rows padded for ldmatrix, zeros outside [0, W) and past the
// D+15 band columns (K is padded to 16 * ceil((D+15)/16): 48 at D = 24).
// The warp rounds the staged dcorr to g in place, as the SIMT kernel rounds it
// (f32 multiply by the reciprocal, one rounding, 0 where x < d), and each
// lane builds its A fragments of the two skewed band tiles from it:
//   dfl's tile: A1[r][k] = g[x0+r, r+D-1-k]   (K column k is fr column x0-D+1+k)
//   dfr's tile: A2[r][k] = g[x0+k, k-r]       (K column k is fl column x0+k)
// and runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) over 32 channels at a
// time: M = 16 columns, K = the padded band, N = 32; the B operands come by
// ldmatrix.trans, since fr and fl lie channel-last (K-major).  It rounds
// once to bf16, stages the [16, 32] tiles of dfl and dfr in shared memory
// and writes them with 16-byte stores, 512 contiguous bytes each at C = 32.
// No atomics: each output is one warp's, its sum in a fixed order, so two
// runs give the same bits.  The tensor cores sum in another order than the
// plain version's d order, and truncate; where the terms cancel that put a
// value 8 bf16 steps off on the H100.  So two more mma.sync a pair take
// |A| |B|, the sum of the terms' magnitudes, and each lane recomputes the
// values whose sum is under 2^-9 of it from shared
// memory in d order, one f32 rounding a term as the plain version rounds:
// its bits.  Neighbouring warps re-read 2 x (D-1) columns of halo, which L2
// serves.  Not wgmma: its 64-row tiles do not divide W = 32 or 160.  On the
// H100 the kernel runs at about a third of its byte bound (PERF.md): a warp's
// phases run one after another, and a warp per gradient, with twice the warps
// in flight, was slower.
//
// f32 (the reference phase only), and bf16 shapes the tensor-core kernel
// does not take: SIMT.  One block per (b, y, 64 columns).  It stages g for
// the columns x0 .. x0+63+D-1 (its own and the D-1 after them, which dfr
// needs), fl for the same columns and fr for x0-D+1 .. x0+63, as f32 rows in
// shared memory, zero outside [0, W) and where x < d.  Each thread then owns
// (x, c) outputs: a warp's 32 lanes read 32 consecutive channels of one row
// (no bank conflict) and one g value (a broadcast), and sums D products in
// f32 for dfl and for dfr.

constexpr int kBwdTile = 64;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline size_t bwd_smem_bytes(int C, int D) {
  const int rows = kBwdTile + D - 1;
  return static_cast<size_t>(rows) * (D + 2 * C) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
correlation_backward_kernel(const T* __restrict__ dcorr, const T* __restrict__ fl,
                            const T* __restrict__ fr, T* __restrict__ dfl,
                            T* __restrict__ dfr, int H, int W, int C, int D,
                            float inv_divisor) {
  extern __shared__ float smem_b[];
  const int rows = kBwdTile + D - 1;
  float* g_s = smem_b;                     // [rows][D]: g of columns x0 .. x0+rows-1
  float* fl_s = g_s + rows * D;            // [rows][C]: fl of columns x0 .. x0+rows-1
  float* fr_s = fl_s + rows * C;           // [rows][C]: fr of columns x0-D+1 .. x0+kBwdTile-1

  const int x0 = blockIdx.x * kBwdTile;
  const long long row = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  const T* g_row = dcorr + row * W * D;
  const T* fl_row = fl + row * W * C;
  const T* fr_row = fr + row * W * C;

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int x = x0 + r;
    float v = 0.0f;
    if (x < W && x >= d) {
      v = round_to(__fmul_rn(load_f32(g_row + static_cast<long long>(x) * D + d), inv_divisor),
                   g_row);
    }
    g_s[i] = v;
  }
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int xl = x0 + r;
    const int xr = x0 - (D - 1) + r;
    fl_s[i] = xl < W ? load_f32(fl_row + static_cast<long long>(xl) * C + c) : 0.0f;
    fr_s[i] = (xr >= 0 && xr < W) ? load_f32(fr_row + static_cast<long long>(xr) * C + c) : 0.0f;
  }
  __syncthreads();

  T* dfl_row = dfl + row * W * C;
  T* dfr_row = dfr + row * W * C;
  for (int i = threadIdx.x; i < kBwdTile * C; i += blockDim.x) {
    const int xi = i / C, c = i - xi * C;
    const int x = x0 + xi;
    if (x >= W) break;                       // i only grows: the rest are past W too
    float a = 0.0f, b = 0.0f;
    for (int d = 0; d < D; ++d) {
      // dfl: fr column x-d sits at fr_s row xi-d+D-1 (zero where x-d < 0, g too).
      a = __fmaf_rn(g_s[xi * D + d], fr_s[(xi - d + D - 1) * C + c], a);
      // dfr: g and fl of column x+d (zero past W).
      b = __fmaf_rn(g_s[(xi + d) * D + d], fl_s[(xi + d) * C + c], b);
    }
    store(dfl_row + static_cast<long long>(x) * C + c, a);
    store(dfr_row + static_cast<long long>(x) * C + c, b);
  }
}

template <typename T>
int launch_backward(const void* dcorr, const void* fl, const void* fr, void* dfl, void* dfr,
                    int B, int H, int W, int C, int D, float inv_divisor, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(C, D);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(correlation_backward_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + kBwdTile - 1) / kBwdTile, H, B);
  correlation_backward_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(dcorr), static_cast<const T*>(fl), static_cast<const T*>(fr),
      static_cast<T*>(dfl), static_cast<T*>(dfr), H, W, C, D, inv_divisor);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward, bf16 tensor cores

constexpr int kBwdMaxKSteps = 4;       // band columns D + 15 <= 64
constexpr int kBwdChunk = 32;          // channels a pass (N)
constexpr int kBwdOutPitch = kBwdChunk + 8;   // bf16 a staged output row
// Sums under 2^-9 of their terms' magnitudes are recomputed in d order.
constexpr float kCancel = 0.001953125f;

__host__ __device__ inline int bwd_ksteps(int D) { return (D + 15 + 15) / 16; }

__host__ __device__ inline int bwd_g_bytes(int D) { return ((D + 15) * D * 2 + 15) / 16 * 16; }

// A warp's shared memory: the dcorr rows x0 .. x0+D+14 as they lie, then
// 16 * ksteps rows of fr (dfl's B) and of fl (dfr's B), pitch 2C + 16 bytes,
// then the [16][kBwdOutPitch] output stages of dfl and dfr.
__host__ __device__ inline int bwd_mma_warp_smem_bytes(int C, int D) {
  return bwd_g_bytes(D) + 2 * 16 * bwd_ksteps(D) * (2 * C + 16) + 2 * 16 * kBwdOutPitch * 2;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The bits of g[x0 + j, d] from the staged g rows; 0 outside the band.
__device__ __forceinline__ uint32_t band_g(const uint16_t* g_s, int j, int d, int D) {
  return d >= 0 && d < D ? g_s[j * D + d] : 0u;
}

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Channel ch of staged row k, as f32.
__device__ __forceinline__ float bf16_at(const unsigned char* rows, int k, int pitch, int ch) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows + k * pitch)[ch]);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
correlation_backward_mma_kernel(const __nv_bfloat16* __restrict__ dcorr,
                                const __nv_bfloat16* __restrict__ fl,
                                const __nv_bfloat16* __restrict__ fr,
                                __nv_bfloat16* __restrict__ dfl, __nv_bfloat16* __restrict__ dfr,
                                int W, int C, int D, float inv_divisor, int g_vector,
                                long long tiles_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ksteps = bwd_ksteps(D), krows = 16 * ksteps, band = D + 15;
  const int pitch = 2 * C + 16;
  unsigned char* base = smem + warp * bwd_mma_warp_smem_bytes(C, D);
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(base);
  unsigned char* fr_s = base + bwd_g_bytes(D);
  unsigned char* fl_s = fr_s + krows * pitch;
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(fl_s + krows * pitch);

  const long long tile = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (tile >= tiles_total) return;
  const int tiles_x = (W + 15) / 16;
  const long long row = tile / tiles_x;
  const int x0 = static_cast<int>(tile - row * tiles_x) * 16;
  const __nv_bfloat16* fl_row = fl + row * W * C;
  const __nv_bfloat16* fr_row = fr + row * W * C;
  const __nv_bfloat16* g_src = dcorr + (row * W + x0) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Stage dcorr's rows x0 .. x0+D+14 (contiguous; zeros past W).
  const int g_valid = min(band, W - x0) * D, g_total = band * D;
  if (g_vector) {
    for (int i = lane; i < g_total / 8; i += 32) {
      if (i * 8 < g_valid) cp_async16(g_s + i * 8, g_src + i * 8);
      else *reinterpret_cast<uint4*>(g_s + i * 8) = zero;
    }
  } else {
    for (int i = lane; i < g_total; i += 32) {
      g_s[i] = i < g_valid ? g_src[i] : __float2bfloat16_rn(0.0f);
    }
  }
  // Stage the B rows: K row k is fr column x0-D+1+k (dfl) and fl column x0+k
  // (dfr); zeros outside [0, W) and past the band.
  const int units = C / 8;
  const int rows_per_pass = 32 / units;
  const int r0 = lane / units, u = lane - r0 * units;
  if (r0 < rows_per_pass) {
    for (int k = r0; k < krows; k += rows_per_pass) {
      void* dr = fr_s + k * pitch + u * 16;
      void* dl = fl_s + k * pitch + u * 16;
      const int xr = x0 - (D - 1) + k, xl = x0 + k;
      if (k < band && xr >= 0 && xr < W) cp_async16(dr, fr_row + xr * C + u * 8);
      else *static_cast<uint4*>(dr) = zero;
      if (k < band && xl < W) cp_async16(dl, fl_row + xl * C + u * 8);
      else *static_cast<uint4*>(dl) = zero;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  // g = T(dcorr * f32(1 / divisor)), 0 where x < d, as the SIMT kernel rounds
  // it, in place: element i = j * D + d is g[x0 + j, d].
  {
    int j = lane / D, d = lane - (lane / D) * D;
    const int dj = 32 / D, dd = 32 - (32 / D) * D;
#pragma unroll 4
    for (int i = lane; i < g_total; i += 32) {
      const float v = __fmul_rn(__bfloat162float(g_s[i]), inv_divisor);
      g_s[i] = __float2bfloat16_rn(x0 + j >= d ? v : 0.0f);
      j += dj;
      d += dd;
      if (d >= D) d -= D, ++j;
    }
  }
  __syncwarp();
  const uint16_t* g_b = reinterpret_cast<const uint16_t*>(g_s);

  // This lane's A fragments of both band tiles: register q of k-step ks holds
  // rows r = gid + 8 (q & 1), columns k, k+1 with k = 16 ks + t2 + 8 (q >> 1).
  const int gid = lane >> 2, t2 = (lane & 3) * 2;
  uint32_t a1[kBwdMaxKSteps][4], a2[kBwdMaxKSteps][4];
  constexpr uint32_t kAbs = 0x7fff7fffu;         // clears both bf16 sign bits
#pragma unroll
  for (int ks = 0; ks < kBwdMaxKSteps; ++ks) {
    if (ks >= ksteps) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = gid + (q & 1) * 8;
      const int k = ks * 16 + t2 + (q >> 1) * 8;
      a1[ks][q] = band_g(g_b, r, r + D - 1 - k, D) | band_g(g_b, r, r + D - 2 - k, D) << 16;
      a2[ks][q] = band_g(g_b, k, k - r, D) | band_g(g_b, k + 1, k + 1 - r, D) << 16;
    }
  }

  // ldmatrix.x4.trans: lanes 0-7 / 8-15 address K rows 0-7 / 8-15 of channels
  // n0..n0+7, lanes 16-31 the same rows of n0+8..n0+15: the B fragments of two
  // n8 tiles.
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;
  __nv_bfloat16* out_l = out_s;
  __nv_bfloat16* out_r = out_s + 16 * kBwdOutPitch;
  __nv_bfloat16* dfl_row = dfl + (row * W + x0) * C;
  __nv_bfloat16* dfr_row = dfr + (row * W + x0) * C;
  const int rows_out = min(16, W - x0);
  for (int nc = 0; nc < C; nc += kBwdChunk) {
    const int pairs = min(kBwdChunk, C - nc) / 16;      // n8 tile pairs: 1 or 2
    // The sums, and the sums of the terms' magnitudes (|A| |B|, the same products).
    float acc1[4][4], acc2[4][4], mag1[4][4], mag2[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[t][i] = acc2[t][i] = mag1[t][i] = mag2[t][i] = 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < kBwdMaxKSteps; ++ks) {
      if (ks >= ksteps) break;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (np >= pairs) break;
        const int off = (ks * 16 + b_row) * pitch + (nc + np * 16 + b_col) * 2;
        const uint32_t m1[4] = {a1[ks][0] & kAbs, a1[ks][1] & kAbs, a1[ks][2] & kAbs,
                                a1[ks][3] & kAbs};
        const uint32_t m2[4] = {a2[ks][0] & kAbs, a2[ks][1] & kAbs, a2[ks][2] & kAbs,
                                a2[ks][3] & kAbs};
        uint32_t b[4];
        ldmatrix_x4_trans(b, fr_s + off);
        const uint32_t r_lo[2] = {b[0], b[1]}, r_hi[2] = {b[2], b[3]};
        const uint32_t r_lo_m[2] = {b[0] & kAbs, b[1] & kAbs};
        const uint32_t r_hi_m[2] = {b[2] & kAbs, b[3] & kAbs};
        mma_bf16_16816(acc1[2 * np], a1[ks], r_lo);
        mma_bf16_16816(acc1[2 * np + 1], a1[ks], r_hi);
        mma_bf16_16816(mag1[2 * np], m1, r_lo_m);
        mma_bf16_16816(mag1[2 * np + 1], m1, r_hi_m);
        ldmatrix_x4_trans(b, fl_s + off);
        const uint32_t l_lo[2] = {b[0], b[1]}, l_hi[2] = {b[2], b[3]};
        const uint32_t l_lo_m[2] = {b[0] & kAbs, b[1] & kAbs};
        const uint32_t l_hi_m[2] = {b[2] & kAbs, b[3] & kAbs};
        mma_bf16_16816(acc2[2 * np], a2[ks], l_lo);
        mma_bf16_16816(acc2[2 * np + 1], a2[ks], l_hi);
        mma_bf16_16816(mag2[2 * np], m2, l_lo_m);
        mma_bf16_16816(mag2[2 * np + 1], m2, l_hi_m);
      }
    }
    // Round once and stage.  Where the terms cancel, the tensor cores'
    // truncating sum can land several bf16 steps from the plain version's: a
    // sum under kCancel of its terms' magnitudes is flagged, and each lane
    // then recomputes its flagged values from shared memory in the plain
    // version's order (d = 0 .. D-1, one f32 rounding a term: products of
    // bf16 are exact in f32), which gives its bits.  Elsewhere the tensor
    // cores' error, a few f32 steps of the magnitudes, is far under a bf16
    // step of the sum.
    uint32_t flagged = 0;                 // bit 16 * grad + 4 * t + i
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t >= 2 * pairs) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (fabsf(acc1[t][i]) < kCancel * mag1[t][i]) flagged |= 1u << (4 * t + i);
        if (fabsf(acc2[t][i]) < kCancel * mag2[t][i]) flagged |= 1u << (16 + 4 * t + i);
      }
      uint32_t* lo_l = reinterpret_cast<uint32_t*>(out_l + gid * kBwdOutPitch + t * 8 + t2);
      uint32_t* lo_r = reinterpret_cast<uint32_t*>(out_r + gid * kBwdOutPitch + t * 8 + t2);
      lo_l[0] = pack_f32(acc1[t][0], acc1[t][1]);
      lo_l[4 * kBwdOutPitch] = pack_f32(acc1[t][2], acc1[t][3]);     // row gid + 8
      lo_r[0] = pack_f32(acc2[t][0], acc2[t][1]);
      lo_r[4 * kBwdOutPitch] = pack_f32(acc2[t][2], acc2[t][3]);
    }
    __syncwarp();
    while (flagged) {
      const int bit = __ffs(flagged) - 1;
      flagged &= flagged - 1;
      const int t = (bit >> 2) & 3, i = bit & 3;
      const int r = gid + (i >> 1) * 8, col = t * 8 + t2 + (i & 1), ch = nc + col;
      float v = 0.0f;
      if (bit & 16) {         // dfr[x0+r] = sum_d g[x0+r+d, d] fl[x0+r+d]
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          v = __fmaf_rn(bf16_bits_to_f32(g_b[(r + d) * D + d]), bf16_at(fl_s, r + d, pitch, ch), v);
        }
        out_r[r * kBwdOutPitch + col] = __float2bfloat16_rn(v);
      } else {                // dfl[x0+r] = sum_d g[x0+r, d] fr[x0+r-d]
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          v = __fmaf_rn(bf16_bits_to_f32(g_b[r * D + d]), bf16_at(fr_s, r + D - 1 - d, pitch, ch),
                        v);
        }
        out_l[r * kBwdOutPitch + col] = __float2bfloat16_rn(v);
      }
    }
    __syncwarp();
    const int shift = pairs == 2 ? 2 : 1;               // 16-byte units a row: 4 or 2
    for (int i = lane; i < (32 << shift); i += 32) {
      const int grad = i >> (4 + shift), r = (i >> shift) & 15, v = i & ((1 << shift) - 1);
      if (r >= rows_out) continue;
      const __nv_bfloat16* src = (grad ? out_r : out_l) + r * kBwdOutPitch + v * 8;
      *reinterpret_cast<uint4*>((grad ? dfr_row : dfl_row) + r * C + nc + v * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncwarp();
  }
}

// Whether the tensor-core kernel takes these bf16 tensors: the guard of a
// launch the wrapper's correlation_backward_route asked for.
bool backward_mma_fits(const void* fl, const void* fr, const void* dfl, const void* dfr, int C,
                       int D) {
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(fl) | reinterpret_cast<uintptr_t>(fr) |
                               reinterpret_cast<uintptr_t>(dfl) | reinterpret_cast<uintptr_t>(dfr);
  return C % 16 == 0 && C <= 256 && D + 15 <= 16 * kBwdMaxKSteps && (misaligned & 15) == 0;
}

int launch_backward_mma(const void* dcorr, const void* fl, const void* fr, void* dfl, void* dfr,
                        int B, int H, int W, int C, int D, float inv_divisor,
                        cudaStream_t stream) {
  static int sms[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>(B) * H * ((W + 15) / 16);
  // Four warps a block where that leaves at least four blocks an SM; one
  // otherwise (the training shape's 256 tiles), so that every SM gets work;
  // fewer where four warps' shared memory would not fit (C > 128).
  int warps = tiles >= 16LL * sms[device] ? kWarpsPerBlock : 1;
  while (warps > 1 && warps * bwd_mma_warp_smem_bytes(C, D) > 227 * 1024) warps /= 2;
  const size_t smem = static_cast<size_t>(warps) * bwd_mma_warp_smem_bytes(C, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(correlation_backward_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int g_vector = D % 8 == 0 && (reinterpret_cast<uintptr_t>(dcorr) & 15) == 0;
  const long long blocks = (tiles + warps - 1) / warps;
  correlation_backward_mma_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dcorr), static_cast<const __nv_bfloat16*>(fl),
      static_cast<const __nv_bfloat16*>(fr), static_cast<__nv_bfloat16*>(dfl),
      static_cast<__nv_bfloat16*>(dfr), W, C, D, inv_divisor, g_vector, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dcorr [B,H,W,D] and fl, fr [B,H,W,C] -> dfl, dfr [B,H,W,C], all contiguous and of one
// type; inv_divisor is float32(1 / divisor) (the wrapper passes it).  mma != 0 runs
// bf16 on the tensor cores and returns cudaErrorInvalidValue where that does not fit
// (float32, or not backward_mma_fits: C % 16 == 0, C <= 256, D <= 49, the four feature
// tensors 16-byte aligned); mma == 0 runs the SIMT kernel.
extern "C" int hst_correlation_backward(const void* dcorr, const void* fl, const void* fr,
                                        void* dfl, void* dfr, int B, int H, int W, int C,
                                        int D, float inv_divisor, int is_bf16, int mma,
                                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!is_bf16 || !backward_mma_fits(fl, fr, dfl, dfr, C, D)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_backward_mma(dcorr, fl, fr, dfl, dfr, B, H, W, C, D, inv_divisor, s);
  }
  return is_bf16 ? launch_backward<__nv_bfloat16>(dcorr, fl, fr, dfl, dfr, B, H, W, C, D,
                                                  inv_divisor, s)
                 : launch_backward<float>(dcorr, fl, fr, dfl, dfr, B, H, W, C, D,
                                          inv_divisor, s);
}

// bf16 needs C % 16 == 0, C <= 256 and 16-byte aligned fl and fr; the wrapper checks
// both and raises, and this returns cudaErrorInvalidValue for them too.
extern "C" int hst_correlation(const void* fl, const void* fr, void* out, int B,
                               int H, int W, int C, int D, float divisor, int is_bf16,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(fl, fr, out, B, H, W, C, D, divisor, s)
                 : launch_f32(fl, fr, out, B, H, W, C, D, divisor, s);
}
