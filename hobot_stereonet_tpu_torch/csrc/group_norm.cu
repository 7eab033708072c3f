// Channels-last GroupNorm with ATen's one-thread CPU statistics.
//
// Written by hand without a Pallas counterpart: the JAX package's GroupNorm
// (flax, hobot_stereonet_tpu/models/layers.py) is left to XLA.  The port
// computes it as ATen's CPU kernel does for a channels-last input at one
// thread, so that the card and ops/kernels/group_norm.py's plain version
// give the same bits (the recipe is in that module's docstring):
//
//   1. per (sample n, channel c), sequential float32 sums over the P
//      positions in memory order: s1 += x, s2 = fma(x, x, s2);
//   2-5. per (n, group g): the group's channel sums in channel order,
//      mean = S1 * float32(1 / (D * P)),
//      var = max(fma(S2, s, -(mean * mean)), 0),
//      rstd = float32(1 / sqrt(double(var) + eps)) in double;
//   6. per channel scale = rstd * gamma, bias = fma(-scale, mean, beta),
//      y = fma(x, scale, bias), rounded to the input's dtype.
//
// Every operation is an intrinsic (__fadd_rn, __fmul_rn, __fmaf_rn,
// __dsqrt_rn, __ddiv_rn), so that nvcc's contraction cannot change a
// rounding.
//
// in : x [N, C, *spatial] bf16 or float32 in channels-last memory
//      ([N, P, C] with P the spatial size), gamma, beta float32 [C].
// out: y like x; mean, rstd float32 [N, G]; sb float32 [N, C, 2] (scale,
//      bias), scratch for the second kernel.
//
// Bound on the H100: the statistics are P dependent float32 adds per
// (n, c) (no split of a chain keeps its bits), at least 4 cycles each, so
// a GroupNorm takes at least P * 4 cycles whatever the batch: 0.47 ms at
// P = 230 400 (half of 720p), 1.9 ms at 921 600 (full 720p) at 1.98 GHz;
// the kernel's chains take about 10 cycles a position (PERF.md).  The
// bytes, read twice and written once (6 bytes an element in bf16), bound
// the normalize pass and large batches.
//
// Design.
//   group_norm_stats_kernel: two threads per (n, c), one for each of its
//   two chains (s1 and s2, on warps of their own, so that each warp issues
//   one add a position), S = 32 / C samples a block where C < 32 (their
//   chains packed across a warp's lanes), one sample a block otherwise.
//   A producer warp (its first thread) keeps a ring of shared-memory
//   stages filled with 1-D bulk copies (TMA, cp.async.bulk) of a tile of
//   positions of each sample: all C channels of consecutive positions, one
//   contiguous range of memory.  Each stage
//   has a full barrier (the copies' bytes) and an empty one (each consumer
//   warp arrives when done with it), so the chain threads never issue a
//   copy.  Each copy is the range widened to 16-byte boundaries (the
//   copy's rule); the extra bytes lie in 16-byte chunks that hold bytes of
//   x, inside its allocation, and are never read from shared memory.  The
//   chain threads read shared memory only, GROUP values at a time with
//   constant offsets (the channel count is a template argument for the
//   networks' 12, 16, 32 and 64), the next group's loads issued before
//   the current group's adds, so that the dependent adds, not memory
//   latency, set the pace.  The block then sums its groups, writes mean
//   and rstd, and each channel's (scale, bias).
//   group_norm_apply_kernel: y = fma(x, scale, bias) over channels-last
//   memory, a sample a grid row, with 16-byte loads and stores (scalar
//   where a sample's rows are not 16-byte aligned).
// A sample's result depends on that sample's data alone, never on the batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_CHAINS = 480;                     // (sample, channel) chains a block
constexpr int MAX_STAGES = 16;
constexpr int BAR_BYTES = 16 * MAX_STAGES;           // full and empty mbarriers, first in smem
constexpr int RING_BYTES = 128 * 1024;               // the ring's shared memory
constexpr int TILE_TARGET = 16384;                   // bytes of one stage, all samples
constexpr int GROUP = 16;                            // positions a chain thread loads at once

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

__device__ __forceinline__ void bulk_load(uint32_t dst, uint64_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// GROUP values of one chain as stored, positions p .. p + GROUP - 1 of a
// tile whose channel-c column starts at col (C values apart).  Converted
// only when added, so that no instruction waits on these loads before the
// previous group's adds are issued.
template <typename T, int CC>
__device__ __forceinline__ void load_group(const T* col, int C, int p, T* v) {
  const T* at = col + p * (CC ? CC : C);
#pragma unroll
  for (int k = 0; k < GROUP; ++k) v[k] = at[k * (CC ? CC : C)];
}

// One step of chain SUM: s1 += x (SUM 0) or s2 = fma(x, x, s2) (SUM 1).
template <int SUM>
__device__ __forceinline__ float add(float acc, float v) {
  return SUM == 0 ? __fadd_rn(acc, v) : __fmaf_rn(v, v, acc);
}

// Chain SUM over np positions of a tile's channel column col: whole groups,
// each group's loads issued before the previous group's adds (two register
// buffers), then the rest one by one.
template <int SUM, typename T, int CC>
__device__ __forceinline__ float consume(const T* col, int C, int np, float acc) {
  const int groups = np / GROUP;
  T a[GROUP], b[GROUP];
  if (groups > 0) load_group<T, CC>(col, C, 0, a);
  int g = 0;
  for (; g + 2 <= groups; g += 2) {
    load_group<T, CC>(col, C, (g + 1) * GROUP, b);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) acc = add<SUM>(acc, to_f32(a[k]));
    if (g + 2 < groups) load_group<T, CC>(col, C, (g + 2) * GROUP, a);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) acc = add<SUM>(acc, to_f32(b[k]));
  }
  if (g < groups) {
#pragma unroll
    for (int k = 0; k < GROUP; ++k) acc = add<SUM>(acc, to_f32(a[k]));
  }
  for (int p = groups * GROUP; p < np; ++p) acc = add<SUM>(acc, to_f32(col[p * (CC ? CC : C)]));
  return acc;
}

// Launch geometry of the statistics kernel, shared by the C entry and the kernel.
struct StatsPlan {
  int S;             // samples a block
  int TP;            // positions a tile
  int sample_bytes;  // shared bytes of one sample's tile (16-byte multiple)
  int stages;
  int threads;       // consumers (whole warps), after the producer warp: one
                     // thread per (sample, channel) for s1, then one for s2
};

StatsPlan stats_plan(int C, int elem) {
  StatsPlan p;
  p.S = C < 32 ? 32 / C : 1;
  const int row = C * elem;
  p.TP = TILE_TARGET / (p.S * row) / GROUP * GROUP;   // whole groups of positions
  if (p.TP < GROUP) p.TP = GROUP;
  p.sample_bytes = (p.TP * row + 15) / 16 * 16 + 16;   // room for the 16-byte widening
  p.stages = RING_BYTES / (p.S * p.sample_bytes);
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  if (p.stages < 2) p.stages = 2;
  p.threads = 2 * ((p.S * C + 31) / 32 * 32);        // warps of s1 chains, then of s2
  return p;
}

// CC: the channel count where it is one of the networks' (12, 16, 32, 64),
// so that a chain's loads take constant offsets; 0 for any other.
template <typename T, int CC>
__global__ void __launch_bounds__(32 + 2 * MAX_CHAINS + 32)
group_norm_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, float2* __restrict__ sb, int N, int C_arg,
                        int P, int G, double eps, StatsPlan plan) {
  const int C = CC ? CC : C_arg;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + BAR_BYTES;
  const int S = plan.S, TP = plan.TP, stages = plan.stages;
  const int stage_bytes = S * plan.sample_bytes;
  const int n0 = blockIdx.x * S;
  const int ns = min(S, N - n0);
  const int tid = static_cast<int>(threadIdx.x) - 32;   // consumer index; the producer's < 0
  const int half = plan.threads / 2;
  const int sum = tid >= half;                          // 0: s1's chains, 1: s2's
  const int chain_id = tid - sum * half;                // (sample, channel) of the chain
  const int s = chain_id / C, c = chain_id - s * C;
  const bool active = tid >= 0 && s < ns;
  const long long row = static_cast<long long>(C) * sizeof(T);
  const uint64_t xaddr = reinterpret_cast<uint64_t>(x);
  const int tiles = (P + TP - 1) / TP;

  auto full = [&](int st) { return smem_u32(smem + 8 * st); };
  auto empty = [&](int st) { return smem_u32(smem + 8 * (MAX_STAGES + st)); };
  // The 16-byte widened range of sample k's tile t: (first byte, bytes).
  auto range = [&](int t, int k, uint64_t* lo) {
    const long long p0 = static_cast<long long>(t) * TP;
    const long long np = min(static_cast<long long>(TP), P - p0);
    const uint64_t start = xaddr + ((static_cast<long long>(n0 + k) * P + p0) * row);
    *lo = start & ~uint64_t(15);
    return static_cast<uint32_t>(((start + np * row + 15) & ~uint64_t(15)) - *lo);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), plan.threads / 32);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc = 0.0f;                                     // this thread's chain
  if (threadIdx.x == 0) {
    // Producer: tile t of every sample of the block into stage t % stages,
    // once the consumers have released that stage's previous tile.
    for (int t = 0; t < tiles; ++t) {
      const int st = t % stages, use = t / stages;
      if (use > 0) mbar_wait(empty(st), static_cast<uint32_t>((use - 1) & 1));
      uint64_t lo;
      uint32_t total = 0;
      for (int k = 0; k < ns; ++k) total += range(t, k, &lo);
      mbar_expect_tx(full(st), total);
      for (int k = 0; k < ns; ++k) {
        const uint32_t len = range(t, k, &lo);
        bulk_load(smem_u32(ring + st * stage_bytes + k * plan.sample_bytes), lo, len, full(st));
      }
    }
  } else if (tid >= 0) {
    for (int t = 0; t < tiles; ++t) {
      const int st = t % stages;
      mbar_wait(full(st), static_cast<uint32_t>((t / stages) & 1));
      if (active) {
        const long long p0 = static_cast<long long>(t) * TP;
        const int np = static_cast<int>(min(static_cast<long long>(TP), P - p0));
        const uint64_t start = xaddr + ((static_cast<long long>(n0 + s) * P + p0) * row);
        const T* col = reinterpret_cast<const T*>(ring + st * stage_bytes +
                                                  s * plan.sample_bytes + (start & 15)) + c;
        acc = sum == 0 ? consume<0, T, CC>(col, C, np, acc) : consume<1, T, CC>(col, C, np, acc);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty(st));      // this warp is done with stage st
    }
  }
  __syncthreads();

  // The ring is free: each (n, c)'s sums, then each (n, g)'s mean and rstd.
  float* sums = reinterpret_cast<float*>(ring);          // s1 of each chain, then s2
  float2* stats = reinterpret_cast<float2*>(sums + plan.threads);
  if (tid >= 0) sums[tid] = acc;
  __syncthreads();
  const int D = C / G;
  if (tid >= 0 && tid < ns * G) {
    const int k = tid / G, g = tid - k * G;
    const float* c1 = sums + k * C + g * D;
    const float* c2 = c1 + half;
    float S1 = c1[0], S2 = c2[0];
    for (int d = 1; d < D; ++d) {
      S1 = __fadd_rn(S1, c1[d]);
      S2 = __fadd_rn(S2, c2[d]);
    }
    const float inv = __fdiv_rn(1.0f, __ll2float_rn(static_cast<long long>(D) * P));
    const float m = __fmul_rn(S1, inv);
    float var = __fmaf_rn(S2, inv, -__fmul_rn(m, m));
    var = var < 0.0f ? 0.0f : var;                     // std::max(var, 0): NaN stays NaN
    const float r = __double2float_rn(
        __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(static_cast<double>(var), eps))));
    mean_out[(n0 + k) * G + g] = m;
    rstd_out[(n0 + k) * G + g] = r;
    stats[tid] = make_float2(m, r);
  }
  __syncthreads();
  if (active && sum == 0) {
    const float2 mr = stats[s * G + c / D];
    const float scale = __fmul_rn(mr.y, gamma[c]);
    sb[static_cast<long long>(n0 + s) * C + c] =
        make_float2(scale, __fmaf_rn(-scale, mr.x, beta[c]));
  }
}

// y = fma(x, scale[n, c], bias[n, c]) over sample n = blockIdx.y's [P, C]
// memory, V elements a thread and step (16 bytes, or 1 where a sample's
// rows are not 16-byte aligned).  The channel of a thread's first element
// moves by the same step every iteration, so no division is in the loop.
template <typename T, int V>
__global__ void __launch_bounds__(256)
group_norm_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const float2* __restrict__ sb, int PC, int C) {
  struct alignas(V * sizeof(T)) Vec { T v[V]; };
  const long long base = static_cast<long long>(blockIdx.y) * PC;
  const float2* ab = sb + static_cast<long long>(blockIdx.y) * C;
  const int step = gridDim.x * blockDim.x * V;
  const int delta = step % C;
  int i = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  int c0 = i % C;
  for (; i + V <= PC; i += step) {
    const Vec in = *reinterpret_cast<const Vec*>(x + base + i);
    Vec out;
    int c = c0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 sc = __ldg(ab + c);
      from_f32(__fmaf_rn(to_f32(in.v[k]), sc.x, sc.y), &out.v[k]);
      if (++c == C) c = 0;
    }
    *reinterpret_cast<Vec*>(y + base + i) = out;
    c0 += delta;
    if (c0 >= C) c0 -= C;
  }
  // The sample's last PC % V elements.
  const int t = PC / V * V + blockIdx.x * blockDim.x + threadIdx.x;
  if (V > 1 && t < PC) {
    const float2 sc = __ldg(ab + t % C);
    from_f32(__fmaf_rn(to_f32(x[base + t]), sc.x, sc.y), &y[base + t]);
  }
}

template <typename T, int CC>
cudaError_t launch_stats(const void* x, const float* gamma, const float* beta, float* mean,
                         float* rstd, float2* sb, int N, int C, int P, int G, double eps,
                         cudaStream_t stream) {
  // Shared memory above 48 KB: allowed once per instantiation.
  static const cudaError_t allowed = cudaFuncSetAttribute(
      group_norm_stats_kernel<T, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BAR_BYTES + RING_BYTES + 64 * 1024);
  if (allowed != cudaSuccess) return allowed;
  const StatsPlan plan = stats_plan(C, sizeof(T));
  const int smem = BAR_BYTES + plan.stages * plan.S * plan.sample_bytes;
  group_norm_stats_kernel<T, CC><<<(N + plan.S - 1) / plan.S, 32 + plan.threads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, mean, rstd, sb, N, C, P, G, eps, plan);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, void* y, float* mean,
           float* rstd, float2* sb, int N, int C, int P, int G, double eps, cudaStream_t stream) {
  const auto stats = [&](auto launch_cc) {
    return launch_cc(x, gamma, beta, mean, rstd, sb, N, C, P, G, eps, stream);
  };
  cudaError_t e;
  switch (C) {
    case 12: e = stats(launch_stats<T, 12>); break;
    case 16: e = stats(launch_stats<T, 16>); break;
    case 32: e = stats(launch_stats<T, 32>); break;
    case 64: e = stats(launch_stats<T, 64>); break;
    default: e = stats(launch_stats<T, 0>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  const int PC = P * C;
  constexpr int V = 16 / sizeof(T);
  // Every sample's rows 16-byte aligned: x and y, and the sample's size.
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         static_cast<uintptr_t>(PC) * sizeof(T)) & 15) == 0;
  const int per_block = 256 * (aligned ? V : 1);
  int chunks = (PC + per_block - 1) / per_block;
  const int cap = (132 * 8 + N - 1) / N;               // about 8 blocks an SM in all
  if (chunks > cap) chunks = cap;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(N));
  if (aligned)
    group_norm_apply_kernel<T, V><<<grid, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), sb, PC, C);
  else
    group_norm_apply_kernel<T, 1><<<grid, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), sb, PC, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hst_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                              void* mean, void* rstd, void* sb, int N, int C, int P, int G,
                              double eps, int is_bf16, void* stream) {
  if (N <= 0 || C <= 0 || P <= 0 || G <= 0 || C % G || C > MAX_CHAINS || N > 65535 ||
      static_cast<long long>(P) * C > (1LL << 30) ||
      (reinterpret_cast<uintptr_t>(x) & (is_bf16 ? 1 : 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto args = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(x, static_cast<const float*>(gamma), static_cast<const float*>(beta), y,
                     static_cast<float*>(mean), static_cast<float*>(rstd),
                     static_cast<float2*>(sb), N, C, P, G, eps, static_cast<cudaStream_t>(stream));
  };
  return is_bf16 ? args(__nv_bfloat16()) : args(0.0f);
}
