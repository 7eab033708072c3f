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
// its sign (logits = -cost, exact in bf16) and reads it where it lies: one
// thread a pixel, its D values H*W apart, so a warp's 32 adjacent pixels
// load 64 (bf16) or 128 (f32) contiguous bytes per candidate, coalesced.  At D = 24 the values stay in registers and memory
// is read once; other D take two passes (the second from L1).  The
// arithmetic is the one-pass kernel's.  Bound at the CLASSIC path's shapes
// (B=8, 24 x 90 x 160 bf16): 5.53 MB read, 0.92 MB written, 1.93 us at
// 3.35 TB/s (7.7 us at B=32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorD = 24;
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

// One pixel's softmax statistics over D candidates `plane` elements apart.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_dlead_kernel(const T* __restrict__ cost, float* __restrict__ disp,
                         float* __restrict__ conf, long long N, long long plane, int d_rt,
                         float scale) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long b = n / plane;
  const int nd = D > 0 ? D : d_rt;
  const T* c = cost + b * nd * plane + (n - b * plane);
  float sum = 0.0f, wsum = 0.0f;
  if constexpr (D > 0) {
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = logit(c + d * plane);
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
    for (int d = 1; d < nd; ++d) m = fmaxf(m, logit(c + d * plane));
    for (int d = 0; d < nd; ++d) {
      const float e = exp2f((logit(c + d * plane) - m) * kLog2e);
      sum += e;
      wsum = fmaf(static_cast<float>(d), e, wsum);
    }
  }
  disp[n] = (wsum / sum) * scale;
  conf[n] = 1.0f / sum;
}

template <typename T>
int launch_dlead(const void* cost, void* disp, void* conf, long long n, long long plane, int D,
                 float scale, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const T* c = static_cast<const T*>(cost);
  float* dp = static_cast<float*>(disp);
  float* cf = static_cast<float*>(conf);
  if (D == kVectorD) {
    soft_argmin_dlead_kernel<T, kVectorD><<<blocks, kThreads, 0, s>>>(c, dp, cf, n, plane, D,
                                                                       scale);
  } else {
    soft_argmin_dlead_kernel<T, 0><<<blocks, kThreads, 0, s>>>(c, dp, cf, n, plane, D, scale);
  }
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
// [B, H, W] f32.
extern "C" int hst_soft_argmin_dlead(const void* cost, void* disp, void* conf, int B, int D,
                                     int plane, float scale, int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || plane <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * plane;
  return is_bf16 ? launch_dlead<__nv_bfloat16>(cost, disp, conf, n, plane, D, scale, s)
                 : launch_dlead<float>(cost, disp, conf, n, plane, D, scale, s);
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
