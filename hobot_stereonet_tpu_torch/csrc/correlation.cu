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
// = 35.0 MB, 10.4 us at 3.35 TB/s; its 4*B*H*W*D*C = 0.35 GFLOP are 5.3 us
// even at the card's 67 TFLOP/s outside the tensor cores.
// Design (a first kernel, right before fast): one block per (b, y, 64
// columns).  It stages g for the columns x0 .. x0+63+D-1 (its own and the
// D-1 after them, which dfr needs), fl for the same columns and fr for
// x0-D+1 .. x0+63, as f32 rows in shared memory, zero outside [0, W) and
// where x < d.  Each thread then owns (x, c) outputs: a warp's 32 lanes
// read 32 consecutive channels of one row (no bank conflict) and one g
// value (a broadcast), and sums D products in f32 for dfl and for dfr.
// Neighbouring blocks re-read D-1 columns of halo (36 % more reads at
// D=24), which L2 mostly serves.  Not on the tensor cores: a later PR.

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

}  // namespace

// dcorr [B,H,W,D] and fl, fr [B,H,W,C] -> dfl, dfr [B,H,W,C], all contiguous and of one
// type; inv_divisor is float32(1 / divisor) (the wrapper passes it).
extern "C" int hst_correlation_backward(const void* dcorr, const void* fl, const void* fr,
                                        void* dfl, void* dfr, int B, int H, int W, int C,
                                        int D, float inv_divisor, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
