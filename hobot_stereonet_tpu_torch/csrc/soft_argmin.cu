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
//   w_j = exp(x_j - max x),  y = sum_j w_j,  r2 = 1 / (y * y)
//   ct_j = (s * gd) * j
//   dg_j = (ct_j / y - sum_i (ct_i * r2) * w_i) * w_j          (disp)
//   ci_j = (gc / n) * [w_j / y == max_i w_i / y]               (conf: the max's
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
// logits and the two cotangents and write the gradient, B*h*w*(2D*2 + 8)
// bytes = 12.0 MB, 3.6 us at 3.35 TB/s; its 24 exponentials and divisions a
// pixel are far below the card's rate.
// Design (a first kernel): one thread a pixel, as the forward.  At D = 24
// the inputs and exponentials stay in registers and memory is read once;
// other D take five passes over the pixel's values (the later ones from L1).
// The channel-last variant reads and writes its pixel's D contiguous
// values one at a time (L1 serves the warp's strided accesses); the
// D-leading variant reads and writes D planes h*w apart, so a warp's 32
// adjacent pixels touch 32 contiguous values per candidate, coalesced.

template <typename T, int KD>
__device__ __forceinline__ void softmax_vjp(const T* __restrict__ in, long long stride, int nd,
                                            float sign, float sgd, bool has_gc, float gc,
                                            T* __restrict__ out) {
  constexpr bool kCached = KD > 0;
  const int D = kCached ? KD : nd;
  float vc[kCached ? KD : 1], wc[kCached ? KD : 1];
  if constexpr (kCached) {
#pragma unroll
    for (int j = 0; j < KD; ++j) vc[j] = sign * to_f32(__ldg(in + j * stride));
  }
  auto val = [&](int j) -> float {
    if constexpr (kCached) return vc[j];
    else return sign * to_f32(__ldg(in + j * stride));
  };
  float m = val(0);
#pragma unroll
  for (int j = 1; j < D; ++j) m = fmaxf(m, val(j));
  float y = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float e = expf(__fsub_rn(val(j), m));
    if constexpr (kCached) wc[j] = e;
    y = __fadd_rn(y, e);
  }
  auto w = [&](int j) -> float {
    if constexpr (kCached) return wc[j];
    else return expf(__fsub_rn(val(j), m));
  };
  const float r2 = __fdiv_rn(1.0f, __fmul_rn(y, y));
  // The maximum probability and its ties, over p_j = w_j / y as computed.
  float pmax = 0.0f, ties = 0.0f;
  if (has_gc) {
#pragma unroll
    for (int j = 0; j < D; ++j) pmax = fmaxf(pmax, __fdiv_rn(w(j), y));
#pragma unroll
    for (int j = 0; j < D; ++j) ties = __fadd_rn(ties, __fdiv_rn(w(j), y) == pmax ? 1.0f : 0.0f);
  }
  const float gshare = has_gc ? __fdiv_rn(gc, ties) : 0.0f;
  float sum_d = 0.0f, sum_c = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float wj = w(j);
    const float ct = __fmul_rn(sgd, static_cast<float>(j));
    sum_d = __fadd_rn(sum_d, __fmul_rn(__fmul_rn(ct, r2), wj));
    if (has_gc && __fdiv_rn(wj, y) == pmax) sum_c = __fadd_rn(sum_c, __fmul_rn(__fmul_rn(gshare, r2), wj));
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float wj = w(j);
    const float ct = __fmul_rn(sgd, static_cast<float>(j));
    float dx = __fmul_rn(__fsub_rn(__fdiv_rn(ct, y), sum_d), wj);
    if (has_gc) {
      const float ci = __fdiv_rn(wj, y) == pmax ? gshare : 0.0f;
      dx = __fadd_rn(__fmul_rn(__fsub_rn(__fdiv_rn(ci, y), sum_c), wj), dx);
    }
    store_as(out + j * stride, sign * dx);
  }
}

template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
soft_argmin_backward_kernel(const T* __restrict__ x, const float* __restrict__ gd,
                            const float* __restrict__ gc, T* __restrict__ dx, long long N,
                            long long plane, int nd, float sign, float scale) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  // plane == 0: channel-last rows of nd values; else D-leading [B, nd, plane].
  long long base, stride;
  if (plane == 0) {
    base = n * nd;
    stride = 1;
  } else {
    const long long b = n / plane;
    base = b * nd * plane + (n - b * plane);
    stride = plane;
  }
  const float sgd = gd ? __fmul_rn(__ldg(gd + n), scale) : 0.0f;
  const float g = gc ? __ldg(gc + n) : 0.0f;
  softmax_vjp<T, KD>(x + base, stride, nd, sign, sgd, gc != nullptr, g, dx + base);
}

template <typename T>
int launch_backward(const void* x, const void* gd, const void* gc, void* dx, long long n,
                    long long plane, int D, float sign, float scale, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const float* gdp = static_cast<const float*>(gd);
  const float* gcp = static_cast<const float*>(gc);
  T* dxp = static_cast<T*>(dx);
  if (D == kVectorD) {
    soft_argmin_backward_kernel<T, kVectorD><<<blocks, kThreads, 0, s>>>(
        xp, gdp, gcp, dxp, n, plane, D, sign, scale);
  } else {
    soft_argmin_backward_kernel<T, 0><<<blocks, kThreads, 0, s>>>(
        xp, gdp, gcp, dxp, n, plane, D, sign, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [N, D] contiguous; gd, gc [N] f32 (either may be null: a zero
// cotangent); dlogits [N, D] of the logits' type.
extern "C" int hst_soft_argmin_backward(const void* logits, const void* gd, const void* gc,
                                        void* dlogits, int N, int D, float scale, int is_bf16,
                                        void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_backward<__nv_bfloat16>(logits, gd, gc, dlogits, N, 0, D, 1.0f, scale, s)
                 : launch_backward<float>(logits, gd, gc, dlogits, N, 0, D, 1.0f, scale, s);
}

// cost [B, D, H, W] contiguous (plane = H*W); gd, gc [B, H, W] f32 (either may
// be null); dcost [B, D, H, W] of the cost's type.
extern "C" int hst_soft_argmin_dlead_backward(const void* cost, const void* gd, const void* gc,
                                              void* dcost, int B, int D, int plane, float scale,
                                              int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || plane <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * plane;
  return is_bf16 ? launch_backward<__nv_bfloat16>(cost, gd, gc, dcost, n, plane, D, -1.0f,
                                                  scale, s)
                 : launch_backward<float>(cost, gd, gc, dcost, n, plane, D, -1.0f, scale, s);
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
