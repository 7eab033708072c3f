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
// pixels, D=24, bf16 logits) it must read 5.5 MB and write 0.9 MB: 6.4 MB,
// 1.9 us at 3.35 TB/s (25.8 MB, 7.7 us at B=32); its 24 exponentials a
// pixel are far below the card's rate.
//
// Design, bf16 with D=24 and 16-byte aligned rows (the main path): one
// thread a pixel.  It loads its pixel's 48-byte row as three 16-byte
// loads; a warp's three loads cover its 32 pixels' 1,536 contiguous bytes,
// so every byte fetched is used, the second and third from L1.  The D
// logits stay in registers, packed two to a register, so one pass over
// them takes the maximum (bf16x2 max, exact), then exp2((l - max) * log2 e),
// their sum and their disparity-weighted sum in f32.  Each thread stores
// its two outputs, coalesced.  Staging a warp's rows through shared memory
// with fully coalesced loads, several 32-pixel groups a warp with cp.async,
// a persistent grid, and two pixels a thread were tried on the H100 and
// were no faster; PERF.md compares the kernel's rate with the ingest
// kernel's.
//
// Generic (other D, f32 logits, rows not 16-byte aligned): one thread a
// pixel, scalar loads; a first pass finds the maximum, a second (served
// from L1) sums the exponentials.
//
// D-leading variant (hst_soft_argmin_dlead): the CLASSIC StereoNet's cost,
// [B, D, H, W] contiguous, as its 3-D aggregation leaves it
// (hobot_stereonet_tpu/models/stereonet.py:143-150 computes soft_argmin(cost)
// * k and disparity_confidence(cost) over axis 1).  It takes the cost with
// its sign (logits = -cost, exact) and reads it where it lies, each pixel's D
// values H*W apart.  Bound at the CLASSIC path's shapes (B=8, 24 x 90 x 160
// bf16): 5.53 MB read, 0.92 MB written, 1.93 us at 3.35 TB/s (7.7 us at
// B=32).
//   Vector route (D = 24, plane % P == 0, the cost P * sizeof(T)-byte
//   aligned; the wrapper's soft_argmin_cost_plan decides before launch):
//   each thread takes P adjacent pixels of one plane and issues all 24 of
//   its loads, one P-pixel vector a candidate, before the first use: a warp
//   moves 32 * P * sizeof(T) contiguous bytes a load instruction and a
//   thread has 24 of them in flight.  bf16 values stay packed two pixels to
//   a register; the minimum over the candidates is one bf16x2 min a pair
//   (exact), the exponentials and sums run in f32 in the scalar route's
//   order, so both routes give the same bits.  Each thread stores its P
//   disparities and confidences as vectors.  The grid is (plane / P /
//   threads, B): the batch is the grid's second dimension, so no thread
//   divides.  P = 2 (4-byte bf16 loads, 8-byte f32 ones) at 128 threads a
//   block, fixed here: on the H100 it was the fastest of P = 2, 4, 8 at 64,
//   128 and 256 threads, and the kernel runs at the card's DRAM rate plus
//   its launch (PERF.md; scripts/torch_cost_kernels_ab.py --sweep rebuilds
//   this file with the others through HST_DLEAD_PIXELS / HST_DLEAD_THREADS).
//   Scalar route (any other D, plane or alignment): one thread a pixel, a
//   warp's 32 adjacent pixels load 64 (bf16) or 128 (f32) contiguous bytes
//   a candidate; at D = 24 the values stay in registers, other D take two
//   passes (the second from L1).  The same (plane, B) grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorD = 24;
#ifndef HST_DLEAD_PIXELS
#define HST_DLEAD_PIXELS 2
#endif
#ifndef HST_DLEAD_THREADS
#define HST_DLEAD_THREADS 128
#endif
constexpr int kDleadPixels = HST_DLEAD_PIXELS;     // the vector route's P
constexpr int kDleadThreads = HST_DLEAD_THREADS;   // and block
static_assert((kDleadPixels == 2 || kDleadPixels == 4 || kDleadPixels == 8) &&
                  kDleadThreads % 32 == 0 && kDleadThreads <= kThreads,
              "the vector route takes 2, 4 or 8 pixels a thread, up to 256 threads");
constexpr float kLog2e = 1.4426950408889634f;

// Softmax statistics of one pixel's D bf16 logits, packed two to a register.
template <int D>
__device__ __forceinline__ void pixel_stats(const uint4 (&row)[D / 8], float scale,
                                            float* disp, float* conf) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(row);
  __nv_bfloat162 mx = h[0];
#pragma unroll
  for (int j = 1; j < D / 2; ++j) mx = __hmax2(mx, h[j]);
  const float m = fmaxf(__low2float(mx), __high2float(mx));
  float sum = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    const float e0 = exp2f((f.x - m) * kLog2e);
    const float e1 = exp2f((f.y - m) * kLog2e);
    sum += e0;
    sum += e1;
    wsum = fmaf(static_cast<float>(2 * j), e0, wsum);
    wsum = fmaf(static_cast<float>(2 * j + 1), e1, wsum);
  }
  *disp = (wsum / sum) * scale;
  *conf = 1.0f / sum;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_vector_kernel(const __nv_bfloat16* __restrict__ logits,
                          float* __restrict__ disp, float* __restrict__ conf,
                          long long N, float scale) {
  static_assert(D % 8 == 0, "a row must be whole 16-byte units");
  constexpr int kUnits = D / 8;                    // 16-byte loads a pixel
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const uint4* src = reinterpret_cast<const uint4*>(logits) + n * kUnits;
  uint4 row[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) row[u] = __ldg(src + u);
  pixel_stats<D>(row, scale, disp + n, conf + n);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void soft_argmin_generic_kernel(const T* __restrict__ logits,
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

template <typename T>
__device__ __forceinline__ float logit(const T* cost) {
  return -to_f32(__ldg(cost));
}

// Scalar route: one pixel's softmax statistics over D candidates `plane`
// elements apart; pixel blockIdx.x * kThreads + threadIdx.x of sample blockIdx.y.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_dlead_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                         float* __restrict__ conf, int plane, int d_rt, float scale) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int nd = D > 0 ? D : d_rt;
  const long long n = static_cast<long long>(blockIdx.y) * plane + p;
  const T* c = cost + static_cast<long long>(blockIdx.y) * nd * plane + p;
  float sum = 0.0f, wsum = 0.0f;
  if constexpr (D > 0) {
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = logit(c + static_cast<long long>(d) * plane);
    float m = v[0];
#pragma unroll
    for (int d = 1; d < D; ++d) m = fmaxf(m, v[d]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float e = exp2f((v[d] - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
  } else {
    float m = logit(c);
    for (int d = 1; d < nd; ++d) m = fmaxf(m, logit(c + static_cast<long long>(d) * plane));
    for (int d = 0; d < nd; ++d) {
      const float e = exp2f((logit(c + static_cast<long long>(d) * plane) - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
  }
  disp[n] = (wsum / sum) * scale;
  conf[n] = 1.0f / sum;
}

// P values of T in one load: 4, 8 or 16 bytes.
template <int Bytes> struct LoadWord;
template <> struct LoadWord<4> { using type = unsigned int; };
template <> struct LoadWord<8> { using type = uint2; };
template <> struct LoadWord<16> { using type = uint4; };

// The minimum cost of each of a thread's P pixels over the D candidates, as
// f32; w[d] holds candidate d of the P pixels.
template <int D, int P, typename Word>
__device__ __forceinline__ void min_cost(const Word (&w)[D], const __nv_bfloat16*,
                                         float (&mn)[P]) {
#pragma unroll
  for (int j = 0; j < P / 2; ++j) {
    __nv_bfloat162 m = reinterpret_cast<const __nv_bfloat162*>(&w[0])[j];
#pragma unroll
    for (int d = 1; d < D; ++d) m = __hmin2(m, reinterpret_cast<const __nv_bfloat162*>(&w[d])[j]);
    mn[2 * j] = __low2float(m);
    mn[2 * j + 1] = __high2float(m);
  }
}

template <int D, int P, typename Word>
__device__ __forceinline__ void min_cost(const Word (&w)[D], const float*, float (&mn)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    mn[i] = reinterpret_cast<const float*>(&w[0])[i];
#pragma unroll
    for (int d = 1; d < D; ++d) mn[i] = fminf(mn[i], reinterpret_cast<const float*>(&w[d])[i]);
  }
}

// P consecutive f32 outputs (P even; n a multiple of P, 16-byte stores from P = 4).
template <int P>
__device__ __forceinline__ void store_pixels(float* __restrict__ out, const float (&v)[P]) {
#pragma unroll
  for (int i = 0; i < P; i += (P >= 4 ? 4 : 2)) {
    if constexpr (P >= 4) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
      *reinterpret_cast<float2*>(out + i) = make_float2(v[i], v[i + 1]);
    }
  }
}

// Vector route: P adjacent pixels a thread, vector blockIdx.x * kDleadThreads +
// threadIdx.x of the plane of sample blockIdx.y; plane % P == 0.
template <typename T, int D, int P>
__global__ void __launch_bounds__(kDleadThreads)
soft_argmin_dlead_vector_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                                float* __restrict__ conf, int plane, float scale) {
  using Word = typename LoadWord<P * sizeof(T)>::type;
  const int q = blockIdx.x * kDleadThreads + threadIdx.x;
  if (q >= plane / P) return;
  const T* c = cost + static_cast<long long>(blockIdx.y) * D * plane + q * P;
  Word w[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    w[d] = __ldg(reinterpret_cast<const Word*>(c + static_cast<long long>(d) * plane));
  }
  // m = max of the logits -v = -(min v), exact; (-v) - m is then the scalar
  // route's v - m, bit for bit.
  float mn[P];
  min_cost<D, P>(w, cost, mn);
  float dv[P], cv[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float m = -mn[i];
    float sum = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float e = exp2f((-to_f32(reinterpret_cast<const T*>(&w[d])[i]) - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
    dv[i] = (wsum / sum) * scale;
    cv[i] = 1.0f / sum;
  }
  const long long n = static_cast<long long>(blockIdx.y) * plane + q * P;
  store_pixels<P>(disp + n, dv);
  store_pixels<P>(conf + n, cv);
}

template <typename T>
int launch_dlead(const void* cost, void* disp, void* conf, int B, int plane, int D, float scale,
                 cudaStream_t s) {
  const dim3 grid((plane + kThreads - 1) / kThreads, B);
  const T* c = static_cast<const T*>(cost);
  float* dp = static_cast<float*>(disp);
  float* cf = static_cast<float*>(conf);
  if (D == kVectorD) {
    soft_argmin_dlead_kernel<T, kVectorD><<<grid, kThreads, 0, s>>>(c, dp, cf, plane, D, scale);
  } else {
    soft_argmin_dlead_kernel<T, 0><<<grid, kThreads, 0, s>>>(c, dp, cf, plane, D, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pixels a thread of T on the vector route: P, at most one 16-byte load.
template <typename T>
constexpr int vector_pixels() {
  return kDleadPixels * sizeof(T) > 16 ? 16 / sizeof(T) : kDleadPixels;
}

// The vector route, or cudaErrorInvalidValue where it does not fit (the
// wrapper's plan never asks for that).
template <typename T>
int launch_dlead_vector(const void* cost, void* disp, void* conf, int B, int D, int plane,
                        float scale, cudaStream_t s) {
  constexpr int P = vector_pixels<T>();
  const uintptr_t out_align = P >= 4 ? 16 : 8;
  const uintptr_t misaligned = (reinterpret_cast<uintptr_t>(cost) % (P * sizeof(T))) |
                               (reinterpret_cast<uintptr_t>(disp) % out_align) |
                               (reinterpret_cast<uintptr_t>(conf) % out_align);
  if (D != kVectorD || plane % P || misaligned) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((plane / P + kDleadThreads - 1) / kDleadThreads, B);
  soft_argmin_dlead_vector_kernel<T, kVectorD, P><<<grid, kDleadThreads, 0, s>>>(
      static_cast<const T*>(cost), static_cast<float*>(disp), static_cast<float*>(conf), plane,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward

// The vector-Jacobian product of (disp, conf) with respect to the logits
// (hst_soft_argmin_backward) or the D-leading cost
// (hst_soft_argmin_dlead_backward), as jax.vjp differentiates soft_argmin and
// disparity_confidence (hobot_stereonet_tpu/ops/soft_argmin.py:17, :33) in
// float32.  With x = logits (= -cost), gd and gc the cotangents of disp and
// conf and s the disparity scale:
//
//   w_j = exp(x_j - max x),  y = sum_j w_j,  r2 = 1 / (y * y),  p_j = w_j / y
//   ct_j = (s * gd) * j
//   dg_j = (ct_j / y - sum_i (ct_i * r2) * w_i) * w_j          (disp)
//   ci_j = (gc / n) * [p_j == max_i p_i]                       (conf: the max's
//   cs_j = (ci_j / y - sum_i (ci_i * r2) * w_i) * w_j           n tied entries share gc)
//   dx_j = cs_j + dg_j
//
// which is s * gd * p_j * (j - E[d]) + gc * (p_m [j in argmax] / n - p_j p_m)
// written in the order of XLA's operations, the sums in index order.  The
// result is rounded once to the input's type: the logits' gradient is dx,
// the cost's -dx.  The softmax is recomputed from the input; p is not stored.
// A null gc (or gd) is a zero cotangent.
//
// Bound on the H100: memory.  At B=8, 90x160, D=24, bf16 it must read the
// input and the two cotangents and write the gradient, B*h*w*(2D*2 + 8) bytes
// = 12.0 MB, 3.6 us at 3.35 TB/s (47.9 MB, 14.3 us at B=32).  The arithmetic
// is not far below it: 24 exponentials, 25 correctly rounded divisions (29
// with gc) and some 100 other operations a pixel are about 700 instructions,
// some 11 us of instruction throughput on 132 SMs at B=32.
//
// Staged route (D = 24; the wrapper's soft_argmin_backward_plan fixes L, T
// and the grid before launch, and this file refuses a plan that does not fit):
//  * A block takes a tile of T pixels and copies it into shared memory in the
//    layout memory has, with 16-byte cp.async: channel-last, T rows of 24
//    contiguous values (the last tile may be short); D-leading, 24 planes of T
//    adjacent pixels (T <= 64, rows a constant 64 values + 16 bytes apart:
//    a lane's accesses take immediate offsets, the pad spreads the banks), on a
//    (plane / T, B) grid, so that no thread divides to find its sample.
//  * A pixel's 24 candidates are spread over a group of L adjacent lanes, C =
//    24 / L each (lane k holds k*C .. k*C + C - 1): the exponentials, the
//    divisions and the products run in parallel.  The max and the tie count
//    are order-free and go through __shfl_xor_sync.  y, sum_d and sum_c keep
//    the index order: lane k adds its terms to lane k-1's sum, passed along
//    the group by __shfl_sync; never a tree.
//  * Divisions: ct_j / y a candidate; r2, gshare, gshare / y and 0 / y once a
//    pixel; the max probability as wmax / y (a correctly rounded division is
//    monotone in its numerator), and p_j = w_j / y only for the weights within
//    2^-21 of wmax, the only ones whose quotient can round to the max (the tie
//    screen).  The one-thread-a-pixel kernel before it divided four times a
//    candidate: 146 divisions a pixel with gc, 25 without; now 29 with gc
//    (and one for each near tie), 25 without.
//  * The group writes its gradient over its input in shared memory, and the
//    block stores the tile with 16-byte stores.  The cotangents are loaded
//    once a pixel (lane 0, shuffled to the group); a launch without gc (the
//    training step's: its loss never reads the confidence) reads none and runs
//    no confidence terms.
// Every value goes through the same IEEE operations in the same order as in
// that kernel (the screen only skips divisions whose result cannot equal the
// max), so the outputs are bit-equal to it.
// Scalar route (any other D, or an input not 16-byte aligned): one thread a
// pixel reads its values where they lie, the channel-last ones 2 or 4 bytes
// at a time; at D = 24 it runs the same routine with L = 1, other D recompute
// w and p in each pass (D is not known at compile time).
// Tried and measured on an H100 (PERF.md §6; scripts/torch_cost_kernels_ab.py
// --sweep times every L and T, and holds the outputs bit for bit to the kernel
// before): gd only 0.0066 ms at the training shape (the timing floor is
// 0.0049), 0.0267 (channel-last) and 0.0293 ms (D-leading, a tie with the
// kernel before) at B = 32; with gc 0.0384 and 0.0408.  L = 1 is fastest for
// gd at the serving shapes, L = 4 or 8 at the training shape, L = 2 with gc
// (at L = 1 its terms take 110 registers).  A runtime D-leading row stride
// (the 24 shared addresses held in registers: 93 against 64) and integer
// divisions in the copy loops cost that layout 0.007 ms at B = 32.

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBwdMaxThreads = 256;          // threads a block on the staged route
constexpr int kDleadMaxTile = 64;            // pixels a D-leading tile
// The tie screen: a candidate whose weight lies below wmax * (1 - 2^-21) has a
// probability below the max (see pixel_vjp).
constexpr float kTieScreen = 1.0f - 0x1p-21f;

template <> struct LoadWord<2> { using type = unsigned short; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The max over the group of L adjacent lanes (order-free).
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ int group_add(int v) {
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Sums over the group's candidates in index order, from +0: lane 0 adds its C
// terms, lane 1 goes on from lane 0's sum, and so on; every lane gets the
// totals.  sa sums a; with kTwo, sb sums the terms of b whose bit is set in
// take_b.
template <int L, int C, bool kTwo>
__device__ __forceinline__ void ordered_sums(const float (&a)[C], const float (&b)[C],
                                             unsigned take_b, int k, float& sa, float& sb) {
  sa = 0.0f;
  sb = 0.0f;
#pragma unroll
  for (int s = 0; s < L; ++s) {
    if (k == s) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        sa = __fadd_rn(sa, a[i]);
        if (kTwo && ((take_b >> i) & 1u)) sb = __fadd_rn(sb, b[i]);
      }
    }
    if constexpr (L > 1) {
      sa = __shfl_sync(kFullMask, sa, s, L);
      if constexpr (kTwo) sb = __shfl_sync(kFullMask, sb, s, L);
    }
  }
}

// One pixel's gradient.  Lane k of a group of L holds candidates k*C ..
// k*C + C - 1 of x (the logits, sign applied) in v and gets dx there; sgd =
// scale * gd (0 for none), g = gc.
template <int L, int C, bool kGC>
__device__ __forceinline__ void pixel_vjp(float (&v)[C], int k, float sgd, float g) {
  float m = v[0];
#pragma unroll
  for (int i = 1; i < C; ++i) m = fmaxf(m, v[i]);
  m = group_max<L>(m);
  float w[C];
#pragma unroll
  for (int i = 0; i < C; ++i) w[i] = expf(__fsub_rn(v[i], m));
  float y, none;
  ordered_sums<L, C, false>(w, w, 0u, k, y, none);
  const float r2 = __fdiv_rn(1.0f, __fmul_rn(y, y));
  float td[C], tc[C] = {};
  unsigned tie = 0u;                 // bit i: p of candidate k*C + i is the max
  float gshare = 0.0f;
  if constexpr (kGC) {
    // p_j = w_j / y rounds monotonically in w_j, so max_j p_j = wmax / y.  A
    // candidate ties with it only if its quotient rounds to that float f
    // (normal: f >= 1/24), and two reals that round to f lie within ulp(f) <=
    // 2^-23 f of each other; so a w_j below wmax * (1 - 2^-21), rounding
    // included, is no tie, and only the rest are divided.  The same ties as
    // dividing every p_j.
    float wmax = w[0];
#pragma unroll
    for (int i = 1; i < C; ++i) wmax = fmaxf(wmax, w[i]);
    wmax = group_max<L>(wmax);
    const float pmax = fmaxf(0.0f, __fdiv_rn(wmax, y));
    const float near = __fmul_rn(wmax, kTieScreen);
    int ties = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (w[i] == wmax || (w[i] >= near && __fdiv_rn(w[i], y) == pmax)) {
        tie |= 1u << i;
        ++ties;
      }
    }
    gshare = __fdiv_rn(g, static_cast<float>(group_add<L>(ties)));   // a sum of 1s: exact
    const float gr = __fmul_rn(gshare, r2);
#pragma unroll
    for (int i = 0; i < C; ++i) tc[i] = __fmul_rn(gr, w[i]);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float ct = __fmul_rn(sgd, static_cast<float>(k * C + i));
    td[i] = __fmul_rn(__fmul_rn(ct, r2), w[i]);
  }
  float sum_d, sum_c;
  ordered_sums<L, C, kGC>(td, tc, tie, k, sum_d, sum_c);
  float q = 0.0f, z = 0.0f;          // ci / y for a tie and for any other candidate
  if constexpr (kGC) {
    q = __fdiv_rn(gshare, y);
    z = __fdiv_rn(0.0f, y);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float ct = __fmul_rn(sgd, static_cast<float>(k * C + i));
    float dx = __fmul_rn(__fsub_rn(__fdiv_rn(ct, y), sum_d), w[i]);
    if constexpr (kGC) {
      dx = __fadd_rn(__fmul_rn(__fsub_rn((tie >> i) & 1u ? q : z, sum_c), w[i]), dx);
    }
    v[i] = dx;
  }
}

// The widest word (2 to 16 bytes) that divides a run of C values of T.
template <typename T, int C>
__host__ __device__ constexpr int run_word() {
  constexpr int b = C * static_cast<int>(sizeof(T));
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : b % 4 == 0 ? 4 : 2;
}

// C consecutive values of T at s (aligned to run_word), times sign, as f32.
template <typename T, int C>
__device__ __forceinline__ void load_run(const T* s, float (&v)[C], float sign) {
  constexpr int kW = run_word<T, C>(), kWords = C * sizeof(T) / kW;
  using Word = typename LoadWord<kW>::type;
  Word w[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) w[u] = reinterpret_cast<const Word*>(s)[u];
  const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = sign * to_f32(e[i]);
}

// sign * v rounded to T, to C consecutive values at s.
template <typename T, int C>
__device__ __forceinline__ void store_run(T* s, const float (&v)[C], float sign) {
  constexpr int kW = run_word<T, C>(), kWords = C * sizeof(T) / kW;
  using Word = typename LoadWord<kW>::type;
  Word w[kWords];
  T* e = reinterpret_cast<T*>(w);
#pragma unroll
  for (int i = 0; i < C; ++i) store_as(e + i, sign * v[i]);
#pragma unroll
  for (int u = 0; u < kWords; ++u) reinterpret_cast<Word*>(s)[u] = w[u];
}

// Staged route: a tile of T pixels a block, L lanes a pixel (T * L threads),
// D = 24.  Channel-last: rows n0 .. n0 + T - 1 of x [N, D], the last tile
// short where N % T != 0; grid (ceil(N / T), 1).  D-leading: pixels p0 .. p0
// + T - 1 of sample blockIdx.y's planes of x [B, D, plane]; grid (plane / T,
// B), T a power of two up to kDleadMaxTile, plane % T == 0; each plane's row
// of the tile kS values apart in shared memory, a constant, so that a lane's
// 24 accesses take immediate offsets.  x and dx 16-byte aligned.
template <typename T, int L, bool kGC, bool kDLead>
__global__ void __launch_bounds__(kBwdMaxThreads)
soft_argmin_backward_staged_kernel(const T* __restrict__ x, const float* __restrict__ gd,
                                   const float* __restrict__ gc, T* __restrict__ dx,
                                   long long N, int plane, int tile, float sign, float scale) {
  constexpr int D = kVectorD, C = D / L, kPer = 16 / sizeof(T);   // values a 16-byte chunk
  constexpr int kS = kDleadMaxTile + kPer;    // D-leading: a plane's row, padded by 16 bytes
  static_assert(D % L == 0 && L <= 8, "24 candidates over 1, 2, 4 or 8 lanes");
  extern __shared__ uint4 stage[];
  T* s = reinterpret_cast<T*>(stage);
  long long base, pix;               // the tile's first element and first pixel
  int rows, chunks, shift = 0;
  if constexpr (kDLead) {
    const int p0 = blockIdx.x * tile;
    base = static_cast<long long>(blockIdx.y) * D * plane + p0;
    pix = static_cast<long long>(blockIdx.y) * plane + p0;
    rows = tile;
    shift = __ffs(tile / kPer) - 1;  // log2 of the chunks a plane
    chunks = D << shift;
  } else {
    pix = static_cast<long long>(blockIdx.x) * tile;
    base = pix * D;
    rows = static_cast<int>(min(static_cast<long long>(tile), N - pix));
    chunks = rows * (D / kPer);
  }
  // Chunk c of the tile: its global and shared offsets, in elements.
  auto global_at = [&](int c) -> long long {
    if constexpr (kDLead) {
      const int j = c >> shift;
      return base + static_cast<long long>(j) * plane + (c - (j << shift)) * kPer;
    } else {
      return base + static_cast<long long>(c) * kPer;
    }
  };
  auto shared_at = [&](int c) -> int {
    if constexpr (kDLead) {
      const int j = c >> shift;
      return j * kS + (c - (j << shift)) * kPer;
    } else {
      return c * kPer;
    }
  };
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    cp_async16(s + shared_at(c), x + global_at(c));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // The pixel's cotangents, loaded by lane 0 of its group while the tile lands.
  const int t = threadIdx.x / L, k = threadIdx.x % L;
  float sgd = 0.0f, g = 0.0f;
  if (k == 0 && t < rows) {
    if (gd) sgd = __fmul_rn(__ldg(gd + pix + t), scale);
    if constexpr (kGC) g = __ldg(gc + pix + t);
  }
  if constexpr (L > 1) {
    sgd = __shfl_sync(kFullMask, sgd, 0, L);
    if constexpr (kGC) g = __shfl_sync(kFullMask, g, 0, L);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Past a short last tile the group computes on stale shared memory and
  // stores nothing; every lane stays for the shuffles.
  float v[C];
  if constexpr (kDLead) {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = sign * to_f32(s[(k * C + i) * kS + t]);
  } else {
    load_run<T, C>(s + t * D + k * C, v, sign);
  }
  pixel_vjp<L, C, kGC>(v, k, sgd, g);
  if constexpr (kDLead) {
#pragma unroll
    for (int i = 0; i < C; ++i) store_as(s + (k * C + i) * kS + t, sign * v[i]);
  } else {
    store_run<T, C>(s + t * D + k * C, v, sign);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    *reinterpret_cast<uint4*>(dx + global_at(c)) =
        *reinterpret_cast<const uint4*>(s + shared_at(c));
  }
}

// Any D, one thread a pixel (the scalar route's D != 24): w and p are
// recomputed in each pass from the input, read where it lies.
template <typename T, bool kGC>
__device__ __forceinline__ void softmax_vjp_any(const T* __restrict__ in, long long stride, int D,
                                                float sign, float sgd, float gc,
                                                T* __restrict__ out) {
  auto val = [&](int j) -> float { return sign * to_f32(__ldg(in + j * stride)); };
  float m = val(0);
  for (int j = 1; j < D; ++j) m = fmaxf(m, val(j));
  auto w = [&](int j) -> float { return expf(__fsub_rn(val(j), m)); };
  float y = 0.0f;
  for (int j = 0; j < D; ++j) y = __fadd_rn(y, w(j));
  const float r2 = __fdiv_rn(1.0f, __fmul_rn(y, y));
  // The maximum probability and its ties in one pass: the count restarts
  // where the running max rises, so it ends as the count of the max.
  float pmax = 0.0f, ties = 0.0f, gshare = 0.0f, q = 0.0f, z = 0.0f;
  if constexpr (kGC) {
    for (int j = 0; j < D; ++j) {
      const float p = __fdiv_rn(w(j), y);
      if (p > pmax) {
        pmax = p;
        ties = 1.0f;
      } else if (p == pmax) {
        ties = __fadd_rn(ties, 1.0f);
      }
    }
    gshare = __fdiv_rn(gc, ties);
    q = __fdiv_rn(gshare, y);
    z = __fdiv_rn(0.0f, y);
  }
  const float gr = __fmul_rn(gshare, r2);
  float sum_d = 0.0f, sum_c = 0.0f;
  for (int j = 0; j < D; ++j) {
    const float wj = w(j);
    const float ct = __fmul_rn(sgd, static_cast<float>(j));
    sum_d = __fadd_rn(sum_d, __fmul_rn(__fmul_rn(ct, r2), wj));
    if (kGC && __fdiv_rn(wj, y) == pmax) sum_c = __fadd_rn(sum_c, __fmul_rn(gr, wj));
  }
  for (int j = 0; j < D; ++j) {
    const float wj = w(j);
    const float ct = __fmul_rn(sgd, static_cast<float>(j));
    float dx = __fmul_rn(__fsub_rn(__fdiv_rn(ct, y), sum_d), wj);
    if (kGC) dx = __fadd_rn(__fmul_rn(__fsub_rn(__fdiv_rn(wj, y) == pmax ? q : z, sum_c), wj), dx);
    store_as(out + j * stride, sign * dx);
  }
}

// Scalar route: one thread a pixel, its KD (0: nd) values stride apart where
// they lie.  Channel-last (dlead == 0): pixel blockIdx.x * kThreads +
// threadIdx.x of x [N, nd], grid (ceil(N / kThreads), 1).  D-leading: pixel
// blockIdx.x * kThreads + threadIdx.x of sample blockIdx.y's planes of x [B,
// nd, plane], grid (ceil(plane / kThreads), B).
template <typename T, int KD, bool kGC>
__global__ void __launch_bounds__(kThreads)
soft_argmin_backward_kernel(const T* __restrict__ x, const float* __restrict__ gd,
                            const float* __restrict__ gc, T* __restrict__ dx, long long N,
                            int plane, int dlead, int nd, float sign, float scale) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long n, base, stride;
  if (dlead) {
    if (q >= plane) return;
    n = static_cast<long long>(blockIdx.y) * plane + q;
    base = static_cast<long long>(blockIdx.y) * nd * plane + q;
    stride = plane;
  } else {
    if (q >= N) return;
    n = q;
    base = q * nd;
    stride = 1;
  }
  const float sgd = gd ? __fmul_rn(__ldg(gd + n), scale) : 0.0f;
  const float g = kGC ? __ldg(gc + n) : 0.0f;
  if constexpr (KD > 0) {
    float v[KD];
#pragma unroll
    for (int j = 0; j < KD; ++j) v[j] = sign * to_f32(__ldg(x + base + j * stride));
    pixel_vjp<1, KD, kGC>(v, 0, sgd, g);
#pragma unroll
    for (int j = 0; j < KD; ++j) store_as(dx + base + j * stride, sign * v[j]);
  } else {
    softmax_vjp_any<T, kGC>(x + base, stride, nd, sign, sgd, g, dx + base);
  }
}

// A launch of either backward as the wrapper planned it
// (correlation.soft_argmin_backward_plan).
struct BackwardPlan {
  int staged;          // 1: the staged route, 0: the scalar route
  int lanes;           // L: lanes a pixel (1 on the scalar route)
  int pixels;          // T: pixels a block
  int threads;         // T * L
  dim3 grid;
  int smem;            // dynamic shared-memory bytes
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether plan p fits a launch on x [B, plane, D] (channel-last) or [B, D,
// plane] (D-leading) of T at x and dx.
template <typename T>
bool plan_fits(const BackwardPlan& p, bool dlead, const void* x, const void* dx, int B, int D,
               int plane) {
  const long long n = static_cast<long long>(B) * plane;
  if (B <= 0 || D <= 0 || plane <= 0 || p.grid.z != 1 || (dlead && B > 65535)) return false;
  if (!p.staged) {
    const long long blocks = ((dlead ? plane : n) + kThreads - 1) / kThreads;
    return p.lanes == 1 && p.pixels == kThreads && p.threads == kThreads && p.smem == 0 &&
           p.grid.x == blocks && p.grid.y == (dlead ? static_cast<unsigned>(B) : 1u);
  }
  constexpr int kPer = 16 / sizeof(T);
  const int L = p.lanes, T_ = p.pixels;
  if (D != kVectorD || !(L == 1 || L == 2 || L == 4 || L == 8) || T_ <= 0 ||
      p.threads != T_ * L || p.threads % 32 || p.threads > kBwdMaxThreads || !aligned16(x) ||
      !aligned16(dx)) {
    return false;
  }
  if (dlead) {
    return T_ <= kDleadMaxTile && (T_ & (T_ - 1)) == 0 && plane % T_ == 0 && T_ % kPer == 0 &&
           p.grid.x == static_cast<unsigned>(plane / T_) && p.grid.y == static_cast<unsigned>(B) &&
           p.smem == static_cast<int>(D * (kDleadMaxTile + kPer) * sizeof(T));
  }
  return p.grid.x == (n + T_ - 1) / T_ && p.grid.y == 1 &&
         p.smem == static_cast<int>(T_ * D * sizeof(T));
}

template <typename T, int L, bool kDLead>
void launch_staged_lanes(const BackwardPlan& p, const T* x, const float* gd, const float* gc,
                         T* dx, long long n, int plane, float sign, float scale, cudaStream_t s) {
  if (gc) {
    soft_argmin_backward_staged_kernel<T, L, true, kDLead><<<p.grid, p.threads, p.smem, s>>>(
        x, gd, gc, dx, n, plane, p.pixels, sign, scale);
  } else {
    soft_argmin_backward_staged_kernel<T, L, false, kDLead><<<p.grid, p.threads, p.smem, s>>>(
        x, gd, gc, dx, n, plane, p.pixels, sign, scale);
  }
}

template <typename T, bool kDLead>
void launch_staged(const BackwardPlan& p, const T* x, const float* gd, const float* gc, T* dx,
                   long long n, int plane, float sign, float scale, cudaStream_t s) {
  switch (p.lanes) {
    case 1: launch_staged_lanes<T, 1, kDLead>(p, x, gd, gc, dx, n, plane, sign, scale, s); break;
    case 2: launch_staged_lanes<T, 2, kDLead>(p, x, gd, gc, dx, n, plane, sign, scale, s); break;
    case 4: launch_staged_lanes<T, 4, kDLead>(p, x, gd, gc, dx, n, plane, sign, scale, s); break;
    default: launch_staged_lanes<T, 8, kDLead>(p, x, gd, gc, dx, n, plane, sign, scale, s); break;
  }
}

template <typename T, int KD>
void launch_scalar(const BackwardPlan& p, const T* x, const float* gd, const float* gc, T* dx,
                   long long n, int plane, int dlead, int D, float sign, float scale,
                   cudaStream_t s) {
  if (gc) {
    soft_argmin_backward_kernel<T, KD, true><<<p.grid, kThreads, 0, s>>>(
        x, gd, gc, dx, n, plane, dlead, D, sign, scale);
  } else {
    soft_argmin_backward_kernel<T, KD, false><<<p.grid, kThreads, 0, s>>>(
        x, gd, gc, dx, n, plane, dlead, D, sign, scale);
  }
}

// The launch, or cudaErrorInvalidValue where the plan does not fit (the
// wrapper's plan never asks for that).
template <typename T>
int launch_backward(bool dlead, const void* x, const void* gd, const void* gc, void* dx, int B,
                    int D, int plane, float scale, const BackwardPlan& p, cudaStream_t s) {
  if (!plan_fits<T>(p, dlead, x, dx, B, D, plane)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * plane;
  const float sign = dlead ? -1.0f : 1.0f;
  const T* xp = static_cast<const T*>(x);
  const float* gdp = static_cast<const float*>(gd);
  const float* gcp = static_cast<const float*>(gc);
  T* dxp = static_cast<T*>(dx);
  if (p.staged && dlead) {
    launch_staged<T, true>(p, xp, gdp, gcp, dxp, n, plane, sign, scale, s);
  } else if (p.staged) {
    launch_staged<T, false>(p, xp, gdp, gcp, dxp, n, plane, sign, scale, s);
  } else if (D == kVectorD) {
    launch_scalar<T, kVectorD>(p, xp, gdp, gcp, dxp, n, plane, dlead, D, sign, scale, s);
  } else {
    launch_scalar<T, 0>(p, xp, gdp, gcp, dxp, n, plane, dlead, D, sign, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int backward_entry(bool dlead, const void* x, const void* gd, const void* gc, void* dx, int B,
                   int D, int plane, float scale, int is_bf16, int staged, int lanes, int pixels,
                   int threads, int grid_x, int grid_y, int smem, void* stream) {
  if (grid_x <= 0 || grid_y <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BackwardPlan p{staged, lanes, pixels, threads,
                       dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y)), smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_backward<__nv_bfloat16>(dlead, x, gd, gc, dx, B, D, plane, scale, p, s)
                 : launch_backward<float>(dlead, x, gd, gc, dx, B, D, plane, scale, p, s);
}

}  // namespace

// logits [B, plane, D] contiguous (plane = H*W); gd, gc [B, plane] f32 (either
// may be null: a zero cotangent); dlogits of the logits' shape and type.  The
// launch (staged: the route, then L, T, T * L threads, the grid, the shared
// bytes) is the wrapper's soft_argmin_backward_plan; cudaErrorInvalidValue if
// it does not fit.
extern "C" int hst_soft_argmin_backward(const void* logits, const void* gd, const void* gc,
                                        void* dlogits, int B, int D, int plane, float scale,
                                        int is_bf16, int staged, int lanes, int pixels,
                                        int threads, int grid_x, int grid_y, int smem,
                                        void* stream) {
  return backward_entry(false, logits, gd, gc, dlogits, B, D, plane, scale, is_bf16, staged,
                        lanes, pixels, threads, grid_x, grid_y, smem, stream);
}

// cost [B, D, H, W] contiguous (plane = H*W); gd, gc [B, H, W] f32 (either may
// be null); dcost [B, D, H, W] of the cost's type.  The plan as above.
extern "C" int hst_soft_argmin_dlead_backward(const void* cost, const void* gd, const void* gc,
                                              void* dcost, int B, int D, int plane, float scale,
                                              int is_bf16, int staged, int lanes, int pixels,
                                              int threads, int grid_x, int grid_y, int smem,
                                              void* stream) {
  return backward_entry(true, cost, gd, gc, dcost, B, D, plane, scale, is_bf16, staged, lanes,
                        pixels, threads, grid_x, grid_y, smem, stream);
}

// cost [B, D, H, W] contiguous (plane = H*W), lower is better; disp, conf
// [B, H, W] f32.  vector != 0 takes the vector route (2 pixels a thread),
// which needs D = 24, an even plane, the cost 2 * sizeof(T)-byte and disp,
// conf 8-byte aligned, else this returns cudaErrorInvalidValue; vector == 0
// the scalar route.
extern "C" int hst_soft_argmin_dlead(const void* cost, void* disp, void* conf, int B, int D,
                                     int plane, float scale, int is_bf16, int vector,
                                     void* stream) {
  if (B <= 0 || D <= 0 || plane <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    return is_bf16 ? launch_dlead_vector<__nv_bfloat16>(cost, disp, conf, B, D, plane, scale, s)
                   : launch_dlead_vector<float>(cost, disp, conf, B, D, plane, scale, s);
  }
  return is_bf16 ? launch_dlead<__nv_bfloat16>(cost, disp, conf, B, plane, D, scale, s)
                 : launch_dlead<float>(cost, disp, conf, B, plane, D, scale, s);
}

// vector != 0 selects the D=24 bf16 kernel, which needs 16-byte aligned
// logits; the wrapper decides, and this returns cudaErrorInvalidValue if
// the logits do not fit it.
extern "C" int hst_soft_argmin(const void* logits, void* disp, void* conf, int N,
                               int D, float scale, int is_bf16, int vector, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = N;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (vector) {
    if (!is_bf16 || D != kVectorD || (reinterpret_cast<uintptr_t>(logits) & 15)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    soft_argmin_vector_kernel<kVectorD><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    soft_argmin_generic_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, D, scale);
  } else {
    soft_argmin_generic_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(disp),
        static_cast<float*>(conf), n, D, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
