// Channels-last GroupNorm with ATen's one-thread CPU statistics, computed by
// an exact parallel scan; optionally fused with the conv's bias add before
// it and a residual add and LeakyReLU(0.2) after it.
//
// Written by hand without a Pallas counterpart: the JAX package's GroupNorm
// (flax, hobot_stereonet_tpu/models/layers.py) is left to XLA.  The port
// computes it as ATen's CPU kernel does for a channels-last input at one
// thread, so that the card and ops/kernels/group_norm.py's plain version
// give the same bits (the recipe is in that module's docstring):
//
//   1. per (sample n, channel c), sequential float32 sums over the P
//      positions in memory order: s1 += a, s2 = fma(a, a, s2) (bf16:
//      s2 += a * a, the square rounded to float32);
//   2-5. per (n, group g): the group's channel sums in channel order,
//      mean = S1 * float32(1 / (D * P)),
//      var = max(fma(S2, s, -(mean * mean)), 0),
//      rstd = float32(1 / sqrt(double(var) + eps)) in double;
//   6. per channel scale = rstd * gamma, shift = fma(-scale, mean, beta),
//      g = fma(a, scale, shift), rounded to the input's dtype T.
//
// The fused entry (ops/kernels/group_norm.py, group_norm_fused) reads the
// conv's output x without its bias and computes, each rounding as the
// unfused PyTorch ops make it:
//   a   = T(x + T(bias))                   (no bias: a = x; read on the fly
//                                           in every pass, never stored)
//   r   = T(skip + g)                      (a residual block; else r = g)
//   out = r >= 0 ? r : T(r * T(0.2))       (with the activation; else r)
//
// Split at the statistics (row tiles across ranks, parallel/tiling.py): the
// same launch in two modes.  Mode STATS runs phases 1-5 and writes each
// (sample, group)'s S1 and S2 (steps 1-2) instead of the output; mode APPLY
// skips phases 1-4, takes mean and rstd as given and runs step 6 with the
// fusions (phases 5-6).  The caller combines the ranks' sums and computes
// steps 3-5 as phase 5 does (ops/kernels/group_norm.py), so that STATS, then
// APPLY over a whole tensor give the one launch's bits.
//
// Every operation is an intrinsic (__fadd_rn, __fmul_rn, __fmaf_rn,
// __dsqrt_rn, __ddiv_rn, __float2int_rn), so that nvcc's contraction cannot
// change a rounding.
//
// The scan's invariant.  Take a spacing u = 2^(key - 150) (key a float32
// exponent field) and a running sum s = k * u, k an integer, |k| < 2^24.
// A step s <- RN(s + v) whose v is a multiple of u is exact while the sum
// stays below 2^24 u in magnitude: k <- k + v / u, in any binade.  A step
// whose v is not is rounded at spacing u when the sum lies in the top
// binade [2^23 u, 2^24 u) of either sign: k <- k + t, t = v / u rounded to
// an integer, half to even; only at a tie (v / u a half-integer) does t
// depend on k, through its parity.  So a run of steps under u is a map from
// the start's parity p to an offset a_p, and maps compose:
//   (g after f).a_p = f.a_p + g.a_{(p + f.a_p) & 1}.
// A map also carries, per start parity, the least and largest prefix
// (lo_p, hi_p) and those right after a step that rounds (rl_p, rh_p).
// Applied to a start k it is exact if every prefix lies strictly below
// 2^24 and every prefix after a rounding step strictly inside one sign's
// top binade (2^23, 2^24): each step's exact sum then rounds at spacing u.
// The two parity paths add the same until the first tie and keep a
// constant difference after it, so a run's map is one offset, that
// difference and the paths' extremes.  A map is computed in float32 for
// float32 values (s1, and s2 of bf16: the square rounded to float32 as
// the plain version sums it), in float64 for float32 squares.  Where no
// map can be applied the steps are taken one at a time, as one thread
// would.  The result is the one-thread chain's, bit for bit, however the
// positions are split.
//
// Design: one cooperative launch of a persistent grid (all SMs, the
// occupancy's blocks each), six phases separated by grid barriers.  A
// sample's positions are cut into segments of LANES runs of R positions
// (R from the channel count: a segment holds about 16K elements).
//   1. each block copies segments into shared memory (cp.async, the next
//      segment's copy in flight while this one is computed; one run a row,
//      padded to an odd word count); thread (run group, channel) sums its
//      channel's two chains over a group of runs, the groups combined in
//      order: each segment's sum, and its prefixes' extremes, a chain;
//   2. a warp per chain scans those sums in float64: the key of the largest
//      magnitude each segment's sum is predicted to reach;
//   3. the segments again: thread (run group, channel) composes its
//      chains' maps over its runs under the predicted keys, the groups
//      combined in order: each segment's map;
//   4. a warp per chain walks its segments in order: the warp loads LANES
//      segments' keys and maps, lane 0 takes the sum into each new key's
//      units and applies the maps up to one that fails, and the warp steps
//      that segment alone (its values staged in shared memory, one lane
//      stepping);
//   5. per (sample, channel): the group statistics (steps 2-5) and the
//      channel's (scale, shift);
//   6. out over the whole batch, 16-byte vectors where aligned.
// Chose a persistent grid with barriers over decoupled look-back: phase 4
// needs every segment's predicted key, which needs the prefix of all the
// segment sums before any map is computed, and a barrier gives both in one
// launch with no flags to poll; the grid spans the card at batch 1.
//
// Where the batch supplies the parallelism (the caller's choice, from the
// number of (sample, channel) pairs: ops/kernels/group_norm.py,
// SEQUENTIAL_CHAINS), group_norm_walk_kernel walks each chain in order
// instead, one thread a chain taking every step alone, and the cooperative
// kernel then skips phases 1-4.  The scan's maps cost about 50 operations
// an element over the batch; the walk costs P dependent steps a chain
// whatever the batch, so past that many chains it takes less time.
//
// Bound on the H100: the bytes, x (and the skip) read once and out written
// once: 4 bytes an element in bf16, 6 with a skip.  The kernel reads x
// three times (phases 1, 3, 6); when the batch's input fits in the 50 MB
// L2, as at batch 1, the second and third reads can be served from L2, so
// that x comes from device memory once (no L2 counter is read here).
// Phase 3 costs about 50 operations an element (two chains), so where it
// runs over a large batch the maps, not the bytes, set the pace; such
// batches walk in order instead (x read twice), at P dependent steps a
// chain whatever the batch.
// Phase 4 is a chain of windows and fallbacks (a fallback is one lane's
// steps at about 5 cycles a position), whose length is set by how often
// a segment's prediction fails (PERF.md counts it on real activations).
// Both modes compute the one-thread chain, so a sample's result depends on
// that sample's data alone, never on the batch or the mode.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;                 // lanes a warp: runs a segment, segments a window
constexpr int KEY_NONE = -1;
constexpr int MAP_INF = 1 << 29;
constexpr int MAP_REACH = 1 << 25;
constexpr int KEY_EMIN = 32, KEY_EMAX = 200;
constexpr float Q_LIMIT = 4194304.0f;     // 2^22
constexpr int MAX_WARPS = 8;
constexpr int MAX_C = 256;
constexpr unsigned FULL = 0xffffffffu;

// A map in units of u: for a start k of parity p the steps add a[p]; every
// prefix lies in [k + lo[p], k + hi[p]], every prefix right after a step
// that rounds in [k + rl[p], k + rh[p]].
struct Map { int a[2], lo[2], hi[2], rl[2], rh[2]; };

__device__ __forceinline__ Map identity_map() {
  return Map{{0, 0}, {MAP_INF, MAP_INF}, {-MAP_INF, -MAP_INF}, {MAP_INF, MAP_INF},
             {-MAP_INF, -MAP_INF}};
}
__device__ __forceinline__ Map dead_map() {
  return Map{{0, 0}, {-MAP_INF, -MAP_INF}, {MAP_INF, MAP_INF}, {MAP_INF, MAP_INF},
             {-MAP_INF, -MAP_INF}};
}

// A path whose prefix moved MAP_REACH or more cannot pass any check.
__device__ __forceinline__ Map normalize(Map m) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (m.lo[p] <= -MAP_REACH || m.hi[p] >= MAP_REACH) {
      m.a[p] = 0; m.lo[p] = -MAP_INF; m.hi[p] = MAP_INF; m.rl[p] = MAP_INF; m.rh[p] = -MAP_INF;
    }
  }
  return m;
}

// f's steps, then g's.
__device__ __forceinline__ Map compose(const Map& f, const Map& g) {
  Map m;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int fa = f.a[p];
    const bool odd = (p + fa) & 1;                    // k's parity after f
    m.a[p] = fa + (odd ? g.a[1] : g.a[0]);
    m.lo[p] = min(f.lo[p], fa + (odd ? g.lo[1] : g.lo[0]));
    m.hi[p] = max(f.hi[p], fa + (odd ? g.hi[1] : g.hi[0]));
    m.rl[p] = min(f.rl[p], fa + (odd ? g.rl[1] : g.rl[0]));
    m.rh[p] = max(f.rh[p], fa + (odd ? g.rh[1] : g.rh[0]));
  }
  return normalize(m);
}

// The key for a sum of magnitude up to m (a spacing u = 2^(key - 150)):
// the exponent field of |m|, 127 for zero, KEY_NONE above KEY_EMAX.
__device__ __forceinline__ int key_of(float m) {
  m = fabsf(m);
  const int e = m == 0.0f ? 127 : static_cast<int>((__float_as_uint(m) >> 23) & 0xFF);
  if (!isfinite(m) || e > KEY_EMAX) return KEY_NONE;
  return e < KEY_EMIN ? KEY_EMIN : e;
}

// s in units of u(key), an integer below 2^24 in magnitude, or false.
__device__ __forceinline__ bool start_k(float s, int key, int* k) {
  if (key == KEY_NONE || !isfinite(s)) return false;
  const double kd = __dmul_rn(static_cast<double>(s), __longlong_as_double(
                                                         static_cast<long long>(1173 - key) << 52));
  if (!(fabs(kd) < 16777216.0) || kd != rint(kd)) return false;
  *k = static_cast<int>(kd);
  return true;
}

__device__ __forceinline__ float value_of(int k, int key) {
  return __fmul_rn(__int2float_rn(k), __int_as_float((key - 23) << 23));   // k * 2^(key - 150)
}

// Every prefix of m from k below 2^24 in magnitude, and every prefix after
// a rounding step strictly inside one sign's top binade (2^23, 2^24).
// (Each field picked by a select: a runtime index would put the map in
// local memory.)
__device__ __forceinline__ bool range_ok(const Map& m, int k) {
  const bool odd = k & 1;
  return k + (odd ? m.lo[1] : m.lo[0]) > -(1 << 24) && k + (odd ? m.hi[1] : m.hi[0]) < (1 << 24) &&
         (k + (odd ? m.rl[1] : m.rl[0]) > (1 << 23) || k + (odd ? m.rh[1] : m.rh[0]) < -(1 << 23));
}

// k plus m's offset for k's parity.
__device__ __forceinline__ int apply_k(const Map& m, int k) {
  return k + ((k & 1) ? m.a[1] : m.a[0]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T, as a float
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f32(from_f32<T>(v));
}

// One chain's step values: v = a (SQ 0) or a * a (SQ 1), and the step's
// map arithmetic, in float32 (V = float) or float64 (float32 squares).
template <int SQ, typename T> struct Step {
  using V = float;
  static __device__ __forceinline__ float value(float a) { return SQ ? __fmul_rn(a, a) : a; }
};
template <> struct Step<1, float> {
  using V = double;
  static __device__ __forceinline__ double value(float a) {
    return __dmul_rn(static_cast<double>(a), static_cast<double>(a));
  }
};

// The step alone, as ATen's loop takes it: s + a; s + a * a for bf16 (the
// square rounded to float32, exact but below the normal range); fma(a, a, s)
// for float32.
template <int SQ, typename T> __device__ __forceinline__ float step_alone(float s, float a) {
  if (!SQ) return __fadd_rn(s, a);
  return sizeof(T) == 2 ? __fadd_rn(s, __fmul_rn(a, a)) : __fmaf_rn(a, a, s);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// q = v / u rounded half to even, and q minus that (exact): a step whose
// v is a multiple of u is exact, one that rounds does so at spacing u only
// in the top binade, and at a tie the path whose k is odd takes the other
// neighbour.  float: by the magic
// number 1.5 * 2^23, exact for |q| < 2^22 (a larger q makes the run's sum
// of |q| dead), without a conversion instruction.
__device__ __forceinline__ void round_half_even(float q, int* ne, float* diff) {
  constexpr float MAGIC = 12582912.0f;
  const float t = __fadd_rn(q, MAGIC);
  *ne = __float_as_int(t) - __float_as_int(MAGIC);
  *diff = __fsub_rn(q, __fsub_rn(t, MAGIC));
}
__device__ __forceinline__ void round_half_even(double q, int* ne, double* diff) {
  *ne = __double2int_rn(q);
  *diff = __dsub_rn(q, static_cast<double>(*ne));
}

// 1 / u = 2^(150 - key), key in [32, 200].
template <typename V> __device__ __forceinline__ V inv_spacing(int key) {
  return static_cast<V>(__int_as_float((277 - key) << 23));
}

struct Params {
  const void* x;          // [N, P, C] conv output (or GroupNorm input), T
  const void* bias;       // [C] conv bias (float32 or bf16) or null
  const void* skip;       // [N, P, C] T or null
  const float* gamma;
  const float* beta;
  void* y;                // [N, P, C] T
  void* r_out;            // [N, P, C] T: r, before the activation, or null
  float* mean;            // [N, G]; inputs in mode APPLY
  float* rstd;
  float* gsums;           // [N, G, 2] S1, S2: mode STATS's output
  double* agg;            // [N, 2C, K] segment sums
  float2* ext;            // [N, 2C, K] their prefixes' least and largest
  int* keys;              // [N, 2C, K] predicted spacings
  Map* maps;              // [N, 2C, K] segment maps
  float* sums;            // [N, 2C] the chains
  float2* sb;             // [N, C] (scale, shift)
  unsigned* bar;          // grid barrier: arrivals, generation
  unsigned long long* clock;   // null, or 7 device times (ns): the start and each phase's
                               // end; then phase 4's windows and failed segments
  double eps;
  int N, C, P, G, R, K;
  int groups;             // G of phases 1 and 3: run groups a segment
  int bias_bf16, activate;
  int sequential;         // phase 4 walks each chain in order; phases 1-3 skipped
  int mode;               // FUSED, STATS or APPLY
};

constexpr int FUSED = 0, STATS = 1, APPLY = 2;

__device__ __forceinline__ void count(unsigned long long* clock, int i, int lane) {
  if (clock && lane == 0) atomicAdd(clock + i, 1ull);
}

__device__ __forceinline__ void stamp(unsigned long long* clock, int i) {
  if (clock && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clock[i] = t;
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// All blocks of the cooperative launch; co-residency is the launch's guarantee.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
struct Kernel {
  const Params& p;
  const int C, P, R, K, L, C2;
  const float* bias_s;     // shared: T(bias) per channel
  T* tile;                 // shared: a segment, run j at j * stride
  int stride;              // elements between runs in the tile

  __device__ Kernel(const Params& p_, float* bias_smem, T* tile_smem, int stride_)
      : p(p_), C(p_.C), P(p_.P), R(p_.R), K(p_.K), L(LANES * p_.R), C2(2 * p_.C),
        bias_s(bias_smem), tile(tile_smem), stride(stride_) {}

  __device__ __forceinline__ float prep(T v, int c) const {
    const float f = to_f32(v);
    return p.bias ? round_t<T>(__fadd_rn(f, bias_s[c])) : f;
  }

  // Start copying segment seg of sample n into dst (x as stored; the
  // bias is added where it is read), 4-byte asynchronous copies into
  // each run's row, one commit group; elementwise where x's words do not
  // line up with the segment.
  __device__ void stage(int n, int seg, T* dst) const {
    const int np = min(L, P - seg * L);
    const int ne = np * C, rc = R * C;
    const T* src = static_cast<const T*>(p.x) + (static_cast<long long>(n) * P +
                                                  static_cast<long long>(seg) * L) * C;
    constexpr int PER = 4 / sizeof(T);                 // elements a word
    if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 && ne % PER == 0) {
      const int nw = ne / PER, rcw = rc / PER, sw = stride / PER;
      const unsigned* from = reinterpret_cast<const unsigned*>(src);
      unsigned* to = reinterpret_cast<unsigned*>(dst);
      int w = threadIdx.x, j = w / rcw, off = w - j * rcw;
      for (; w < nw; w += blockDim.x) {
        cp_async4(to + j * sw + off, from + w);
        off += blockDim.x;
        while (off >= rcw) {
          off -= rcw;
          ++j;
        }
      }
    } else {
      for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        const int j = e / rc;
        dst[j * stride + e - j * rc] = src[e];
      }
    }
    cp_async_commit();
  }

  // Phases 1 and 3 over the block's segments, the next one's copy in
  // flight while this one is computed.
  template <typename Work>
  __device__ void over_segments(T* buf0, int tile_elems, Work work) {
    const int items = p.N * K;
    T* now = buf0;
    T* later = buf0 + tile_elems;
    if (static_cast<int>(blockIdx.x) < items) stage(blockIdx.x / K, blockIdx.x % K, now);
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int next = it + gridDim.x;
      if (next < items) {
        stage(next / K, next % K, later);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tile = now;
      work(it / K, it % K);
      __syncthreads();
      T* const t = now;
      now = later;
      later = t;
    }
  }

  // Positions of run j that exist in segment seg: [0, count).
  __device__ __forceinline__ int run_len(int seg, int j) const {
    return max(0, min(R, P - seg * L - j * R));
  }

  // Phases 1 and 3 split a staged segment's 32 runs into G groups of
  // consecutive runs; thread (g, c) takes channel c's two chains over group
  // g's runs in order (consecutive threads read consecutive channels of a
  // row), leaves each chain's partial in shared memory, and the partials
  // are combined in group order by a tree over g.
  __device__ __forceinline__ int runs_a_group() const { return LANES / p.groups; }

  // Combine partials [G][2C] in group order into partials [0][chain].
  template <typename Part, typename Combine>
  __device__ void fold_groups(Part* part, Combine combine) {
    for (int d = 1; d < p.groups; d <<= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < C2 * p.groups; t += blockDim.x) {
        const int g = t / C2, chain = t - g * C2;
        if (g % (2 * d) == 0 && g + d < p.groups) {
          part[g * C2 + chain] = combine(part[g * C2 + chain], part[(g + d) * C2 + chain]);
        }
      }
    }
    __syncthreads();
  }

  // Phase 1: each segment's sum of each chain, and the least and largest
  // of its prefixes from the segment's start (a chain's values summed in
  // float32, float32 squares in float64; runs combined in float64).
  struct Sums { double sum, lo, hi; };

  __device__ void group_sums(int seg, int g, int c, Sums* o1, Sums* o2) const {
    using V2 = typename Step<1, T>::V;
    *o1 = Sums{0.0, 0.0, 0.0};
    *o2 = Sums{0.0, 0.0, 0.0};
    for (int j = g * runs_a_group(); j < (g + 1) * runs_a_group(); ++j) {
      const T* run = tile + j * stride + c;
      float s1 = 0.0f, lo1 = 0.0f, hi1 = 0.0f;
      V2 s2 = 0, hi2 = 0;                      // s2 never decreases: its least prefix is 0
      const int len = run_len(seg, j);
#pragma unroll 4
      for (int r = 0; r < len; ++r) {
        const float a = prep(run[r * C], c);
        s1 = __fadd_rn(s1, a);
        lo1 = fminf(lo1, s1);
        hi1 = fmaxf(hi1, s1);
        s2 = add_rn(s2, Step<1, T>::value(a));
      }
      hi2 = s2;
      *o1 = combine_sums(*o1, Sums{s1, lo1, hi1});
      *o2 = combine_sums(*o2, Sums{static_cast<double>(s2), 0.0, static_cast<double>(hi2)});
    }
  }

  static __device__ __forceinline__ Sums combine_sums(const Sums& f, const Sums& g) {
    return Sums{__dadd_rn(f.sum, g.sum), fmin(f.lo, __dadd_rn(f.sum, g.lo)),
                fmax(f.hi, __dadd_rn(f.sum, g.hi))};
  }

  __device__ void segment_sums(int n, int seg, Sums* part) {
    for (int t = threadIdx.x; t < p.groups * C; t += blockDim.x) {
      const int g = t / C, c = t - g * C;
      group_sums(seg, g, c, &part[g * C2 + c], &part[g * C2 + C + c]);
    }
    fold_groups(part, combine_sums);
    for (int chain = threadIdx.x; chain < C2; chain += blockDim.x) {
      const long long at = (static_cast<long long>(n) * C2 + chain) * K + seg;
      p.agg[at] = part[chain].sum;
      p.ext[at] = make_float2(__double2float_rn(part[chain].lo), __double2float_rn(part[chain].hi));
    }
  }

  // Phase 2: chain task's keys: the spacing of the largest magnitude the
  // float64 prefix of the segment sums predicts in each segment.
  __device__ void predict(int task, int lane) {
    const double* agg = p.agg + static_cast<long long>(task) * K;
    const float2* ext = p.ext + static_cast<long long>(task) * K;
    int* keys = p.keys + static_cast<long long>(task) * K;
    double base = 0.0;
    for (int i0 = 0; i0 < K; i0 += LANES) {
      const double own = i0 + lane < K ? agg[i0 + lane] : 0.0;
      double inc = own;
#pragma unroll
      for (int d = 1; d < LANES; d <<= 1) {
        const double o = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc = __dadd_rn(inc, o);
      }
      if (i0 + lane < K) {
        const double e = __dadd_rn(base, __dsub_rn(inc, own));
        const float2 mm = ext[i0 + lane];
        const double m = fmax(fabs(__dadd_rn(e, mm.x)), fabs(__dadd_rn(e, mm.y)));
        keys[i0 + lane] = key_of(__double2float_rn(m));
      }
      base = __dadd_rn(base, __shfl_sync(FULL, inc, LANES - 1));
    }
  }

  // Phase 3: the segments' maps under their predicted spacings; a run's
  // s1 and s2 steps in one loop (one load, two independent chains).
  // Both parity paths of a run: they add the same until the first tie,
  // where exactly one adds d; from there both values have one parity and
  // add the same again, so path 1 = path 0 + delta throughout.
  struct Path {
    int a = 0, delta = 0, lo0 = MAP_INF, lo1 = MAP_INF, hi0 = -MAP_INF, hi1 = -MAP_INF;
    int rl0 = MAP_INF, rl1 = MAP_INF, rh0 = -MAP_INF, rh1 = -MAP_INF;
    bool seen = false;
    template <typename V>
    __device__ __forceinline__ void step(V q, V& qsum) {
      int ne;
      V diff;
      round_half_even(q, &ne, &diff);
      const int d = (diff == V(0.5)) - (diff == V(-0.5));
      const bool odd = a & 1;
      if (!seen && d != 0) {
        delta = odd ? -d : d;
        seen = true;
      }
      a += ne + (odd ? d : 0);
      const int a1 = a + delta;
      lo0 = min(lo0, a);
      hi0 = max(hi0, a);
      lo1 = min(lo1, a1);
      hi1 = max(hi1, a1);
      if (diff != V(0)) {
        rl0 = min(rl0, a);
        rh0 = max(rh0, a);
        rl1 = min(rl1, a1);
        rh1 = max(rh1, a1);
      }
      qsum = add_rn(qsum, q < V(0) ? -q : q);
    }
    __device__ __forceinline__ Map map() const {
      return Map{{a, a + delta}, {lo0, lo1}, {hi0, hi1}, {rl0, rl1}, {rh0, rh1}};
    }
  };

  // s2's steps never decrease the sum (v >= 0), so each path's least and
  // largest prefix are its first and last.  The two paths add the same
  // until the first tie, where exactly one adds d; from there both values
  // have one parity and add the same again: path 1 = path 0 + delta.
  struct MonoPath {
    int a = 0, delta = 0, f0 = MAP_INF, f1 = MAP_INF, rf0 = MAP_INF, rf1 = MAP_INF;
    int rl0 = -MAP_INF, rl1 = -MAP_INF;
    bool seen = false, started = false, rseen = false;
    template <typename V>
    __device__ __forceinline__ void step(V q, V& qsum) {
      int ne;
      V diff;
      round_half_even(q, &ne, &diff);
      const int d = (diff == V(0.5)) - (diff == V(-0.5));
      const bool odd = a & 1;
      if (!seen && d != 0) {
        delta = odd ? -d : d;
        seen = true;
      }
      a += ne + (odd ? d : 0);
      const int a1 = a + delta;
      if (!started) {
        f0 = a;
        f1 = a1;
        started = true;
      }
      if (diff != V(0)) {
        if (!rseen) {
          rf0 = a;
          rf1 = a1;
          rseen = true;
        }
        rl0 = a;
        rl1 = a1;
      }
      qsum = add_rn(qsum, q);
    }
    __device__ __forceinline__ Map map() const {
      if (!started) return identity_map();
      return Map{{a, a + delta}, {f0, f1}, {a, a + delta}, {rf0, rf1}, {rl0, rl1}};
    }
  };

  __device__ void group_maps(int seg, int g, int c, int key1, int key2, Map* m1, Map* m2) const {
    using V2 = typename Step<1, T>::V;
    *m1 = identity_map();
    *m2 = identity_map();
    const float scale1 = key1 == KEY_NONE ? 0.0f : inv_spacing<float>(key1);
    const V2 scale2 = key2 == KEY_NONE ? V2(0) : inv_spacing<V2>(key2);
    for (int j = g * runs_a_group(); j < (g + 1) * runs_a_group(); ++j) {
      const T* run = tile + j * stride + c;
      const int len = run_len(seg, j);
      Path p1;
      MonoPath p2;
      float qs1 = 0.0f;
      V2 qs2 = 0;
#pragma unroll 4
      for (int r = 0; r < len; ++r) {
        const float a = prep(run[r * C], c);
        p1.step(__fmul_rn(a, scale1), qs1);
        p2.step(mul_rn(Step<1, T>::value(a), scale2), qs2);
      }
      Map r1 = key1 == KEY_NONE || !(qs1 < Q_LIMIT) ? dead_map() : normalize(p1.map());
      Map r2 = key2 == KEY_NONE || !(qs2 < static_cast<V2>(Q_LIMIT)) ? dead_map()
                                                                    : normalize(p2.map());
      *m1 = compose(*m1, r1);
      *m2 = compose(*m2, r2);
    }
  }

  __device__ void segment_maps(int n, int seg, Map* part) {
    const long long base = static_cast<long long>(n) * C2 * K + seg;
    for (int t = threadIdx.x; t < p.groups * C; t += blockDim.x) {
      const int g = t / C, c = t - g * C;
      group_maps(seg, g, c, p.keys[base + static_cast<long long>(c) * K],
                 p.keys[base + static_cast<long long>(C + c) * K], &part[g * C2 + c],
                 &part[g * C2 + C + c]);
    }
    fold_groups(part, [](const Map& f, const Map& g) { return compose(f, g); });
    for (int chain = threadIdx.x; chain < C2; chain += blockDim.x)
      p.maps[base + static_cast<long long>(chain) * K] = part[chain];
  }

  // A segment that failed, stepped in order from s: its column of a staged
  // in the warp's buffer (each lane loads BATCH values, then stores them),
  // then lane 0 takes every step alone, as one thread would (a lone warp's
  // maps of the segment's runs cost more than these steps).
  template <int SQ>
  __device__ float slow_segment(int n, int c, int seg, float s, int lane, T* buf) {
    const int np = min(L, P - seg * L);
    const long long e0 = (static_cast<long long>(n) * P + static_cast<long long>(seg) * L) * C + c;
    const T* x = static_cast<const T*>(p.x);
    constexpr int BATCH = 16;
    __syncwarp();
    for (int i0 = lane; i0 < np; i0 += LANES * BATCH) {
      T v[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int i = i0 + b * LANES;
        if (i < np) v[b] = x[e0 + static_cast<long long>(i) * C];
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int i = i0 + b * LANES;
        if (i < np) buf[i] = p.bias ? from_f32<T>(prep(v[b], c)) : v[b];
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int i = 0; i < np; ++i) s = step_alone<SQ, T>(s, to_f32(buf[i]));
    }
    return __shfl_sync(FULL, s, 0);
  }

  // Phase 4: chain task's sum, its segments in order: the warp loads a
  // window of LANES segments' keys and maps into its shared buffer, lane 0
  // applies them one after another (taking s into units of each new key)
  // up to the first that fails, and the warp steps that one alone.
  template <int SQ>
  __device__ float resolve(int n, int c, int lane, T* buf, Map* wmap, int* wkey) {
    const long long base = (static_cast<long long>(n) * C2 + SQ * C + c) * K;
    const Map* maps = p.maps + base;
    const int* keys = p.keys + base;
    float s = 0.0f;
    int i = 0;
    while (i < K) {
      const int nw = min(LANES, K - i);
      count(p.clock, 7, lane);
      __syncwarp();
      if (lane < nw) {
        wmap[lane] = maps[i + lane];
        wkey[lane] = keys[i + lane];
      }
      __syncwarp();
      int f = nw;
      if (lane == 0) {
        int key = KEY_NONE, k = 0;
        bool have = false;
        for (int j = 0; j < nw; ++j) {
          if (wkey[j] != key) {
            if (have) s = value_of(k, key);
            key = wkey[j];
            have = start_k(s, key, &k);
          }
          if (!have || !range_ok(wmap[j], k)) {
            f = j;
            break;
          }
          k = apply_k(wmap[j], k);
        }
        if (have) s = value_of(k, key);
      }
      f = __shfl_sync(FULL, f, 0);
      s = __shfl_sync(FULL, s, 0);
      i += f;
      if (f < nw) {
        count(p.clock, 8, lane);
        s = slow_segment<SQ>(n, c, i, s, lane, buf);
        ++i;
      }
    }
    return s;
  }

  // Phase 5: (n, c)'s group statistics and (scale, shift); mode STATS: the
  // group's sums only; mode APPLY: (scale, shift) from the given statistics.
  __device__ void statistics(int n, int c) {
    const int D = C / p.G, g = c / D;
    if (p.mode == APPLY) {
      const float scale = __fmul_rn(p.rstd[n * p.G + g], p.gamma[c]);
      p.sb[static_cast<long long>(n) * C + c] =
          make_float2(scale, __fmaf_rn(-scale, p.mean[n * p.G + g], p.beta[c]));
      return;
    }
    const float* c1 = p.sums + static_cast<long long>(n) * C2 + g * D;
    const float* c2 = c1 + C;
    float S1 = c1[0], S2 = c2[0];
    for (int d = 1; d < D; ++d) {
      S1 = __fadd_rn(S1, c1[d]);
      S2 = __fadd_rn(S2, c2[d]);
    }
    if (p.mode == STATS) {
      if (c == g * D) {
        p.gsums[(n * p.G + g) * 2] = S1;
        p.gsums[(n * p.G + g) * 2 + 1] = S2;
      }
      return;
    }
    const float inv = __fdiv_rn(1.0f, __ll2float_rn(static_cast<long long>(D) * P));
    const float mu = __fmul_rn(S1, inv);
    float var = __fmaf_rn(S2, inv, -__fmul_rn(mu, mu));
    var = var < 0.0f ? 0.0f : var;                     // std::max(var, 0): NaN stays NaN
    const float r = __double2float_rn(
        __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(static_cast<double>(var), p.eps))));
    if (c == g * D) {
      p.mean[n * p.G + g] = mu;
      p.rstd[n * p.G + g] = r;
    }
    const float scale = __fmul_rn(r, p.gamma[c]);
    p.sb[static_cast<long long>(n) * C + c] = make_float2(scale, __fmaf_rn(-scale, mu, p.beta[c]));
  }

  // out (and r) of one element: a, its (scale, shift), its skip value.
  __device__ __forceinline__ T finish(float a, float2 sc, float skip, T* r_out) const {
    float r = round_t<T>(__fmaf_rn(a, sc.x, sc.y));
    if (p.skip) r = round_t<T>(__fadd_rn(skip, r));
    *r_out = from_f32<T>(r);
    if (p.activate && !(r >= 0.0f)) r = __fmul_rn(r, round_t<T>(0.2f));
    return from_f32<T>(r);
  }

  // Phase 6: out over the batch.
  __device__ void apply() {
    const long long pc = static_cast<long long>(P) * C, total = pc * p.N;
    const T* x = static_cast<const T*>(p.x);
    const T* skip = static_cast<const T*>(p.skip);
    T* y = static_cast<T*>(p.y);
    T* r_out = static_cast<T*>(p.r_out);
    constexpr int V = 16 / sizeof(T);
    const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
    const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                       reinterpret_cast<uintptr_t>(skip) | reinterpret_cast<uintptr_t>(r_out)) &
                      15) == 0 && pc % V == 0;
    if (vec) {
      struct alignas(16) Vec { T v[V]; };
      for (long long e = tid * V; e < total; e += nthreads * V) {
        const Vec in = *reinterpret_cast<const Vec*>(x + e);
        Vec sk;
        if (skip) sk = *reinterpret_cast<const Vec*>(skip + e);
        const long long n = e / pc;
        int c = static_cast<int>(e % C);
        const float2* sb = p.sb + n * C;
        Vec out, pre;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          out.v[k] = finish(prep(in.v[k], c), sb[c], skip ? to_f32(sk.v[k]) : 0.0f, &pre.v[k]);
          if (++c == C) c = 0;
        }
        *reinterpret_cast<Vec*>(y + e) = out;
        if (r_out) *reinterpret_cast<Vec*>(r_out + e) = pre;
      }
    } else {
      for (long long e = tid; e < total; e += nthreads) {
        const int c = static_cast<int>(e % C);
        T pre;
        y[e] = finish(prep(x[e], c), p.sb[(e / pc) * C + c], skip ? to_f32(skip[e]) : 0.0f,
                      &pre);
        if (r_out) r_out[e] = pre;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
group_norm_scan_kernel(Params p, int stride, int tile_elems, int part_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);
  T* tile = reinterpret_cast<T*>(smem + MAX_C * sizeof(float));
  void* part = smem + MAX_C * sizeof(float) + part_offset;   // phases 1 and 3's partials
  Kernel<T> k(p, bias_s, tile, stride);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  if (p.bias) {
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
      const float b = p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[c])
                                  : static_cast<const float*>(p.bias)[c];
      bias_s[c] = round_t<T>(b);
    }
  }
  __syncthreads();
  // Warp tasks spread over the blocks first, so that few tasks use many SMs.
  const int wtask0 = warp * gridDim.x + blockIdx.x, wtasks = warps * gridDim.x;

  stamp(p.clock, 0);
  if (p.sequential || p.mode == APPLY) {   // walked in order by group_norm_walk_kernel, or given
    stamp(p.clock, 1);
    stamp(p.clock, 2);
    stamp(p.clock, 3);
  } else {
    k.over_segments(tile, tile_elems, [&](int n, int seg) {        // 1
      k.segment_sums(n, seg, static_cast<typename Kernel<T>::Sums*>(part));
    });
    grid_sync(p.bar);
    stamp(p.clock, 1);
    for (int t = wtask0; t < p.N * k.C2; t += wtasks) k.predict(t, lane);   // 2
    grid_sync(p.bar);
    stamp(p.clock, 2);
    k.over_segments(tile, tile_elems, [&](int n, int seg) {        // 3
      k.segment_maps(n, seg, static_cast<Map*>(part));
    });
    grid_sync(p.bar);
    stamp(p.clock, 3);
    k.tile = tile;
    T* buf = tile + warp * LANES * p.R;
    Map* wmap = reinterpret_cast<Map*>(static_cast<unsigned char*>(part) +
                                       warp * LANES * (sizeof(Map) + sizeof(int)));
    int* wkey = reinterpret_cast<int*>(wmap + LANES);
    for (int t = wtask0; t < p.N * k.C2; t += wtasks) {           // 4
      const int n = t / k.C2, chain = t % k.C2;
      const float s = chain < p.C ? k.template resolve<0>(n, chain, lane, buf, wmap, wkey)
                                  : k.template resolve<1>(n, chain - p.C, lane, buf, wmap, wkey);
      if (lane == 0) p.sums[t] = s;
    }
  }
  grid_sync(p.bar);
  stamp(p.clock, 4);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < p.N * p.C;   // 5
       t += gridDim.x * blockDim.x)
    k.statistics(t / p.C, t % p.C);
  if (p.mode == STATS) return;
  grid_sync(p.bar);
  stamp(p.clock, 5);
  k.apply();                                                        // 6
  stamp(p.clock, 6);
}

// The chains walked in order, one thread a chain, a launch of its own
// before the cooperative kernel (which then skips phases 1-4).  S = 32 / C
// samples a block where C < 32, their chains packed across a warp's lanes;
// the s1 chains on the first W consumer threads, the s2 chains on the next
// W (W: S * C rounded up to whole warps, so that a warp takes one kind).
// A producer warp (its first thread) keeps a ring of shared-memory stages
// filled with 1-D bulk copies (TMA, cp.async.bulk) of a tile of TP
// positions of each sample, one contiguous range of x widened to 16-byte
// boundaries (the copy's rule; the extra bytes lie in 16-byte chunks that
// hold bytes of x, inside its allocation, and are never read).  Each stage
// has a full barrier (the copies' bytes) and an empty one (each consumer
// warp arrives when done with it), so the chain threads issue no copy; per
// thread asynchronous copies from a few warps kept too few bytes in flight.
// A chain thread loads GROUP values while the previous GROUP's steps run,
// at offsets that are constants where CC (the channel count: 12, 16, 32,
// 64, else 0) is, so that the dependent adds, not the loads, set the pace.
constexpr int WALK_MAX_STAGES = 16;
constexpr int WALK_BAR_BYTES = 16 * WALK_MAX_STAGES;    // full and empty mbarriers, first
constexpr int WALK_RING_BYTES = 128 * 1024;
constexpr int WALK_TILE_TARGET = 16384;                 // bytes of one stage, all samples
constexpr int WALK_GROUP = 16;                          // positions a chain loads at once
constexpr int WALK_SMEM_MAX = 200 * 1024;

struct WalkPlan {
  int S;             // samples a block
  int TP;            // positions a tile
  int sample_bytes;  // shared bytes of one sample's tile (16-byte multiple)
  int stages;
  int threads;       // consumers (whole warps): s1's chains, then s2's
};

WalkPlan walk_plan(int C, int elem) {
  WalkPlan p;
  p.S = C < 32 ? 32 / C : 1;
  const int row = C * elem;
  p.TP = WALK_TILE_TARGET / (p.S * row) / WALK_GROUP * WALK_GROUP;
  if (p.TP < WALK_GROUP) p.TP = WALK_GROUP;
  p.sample_bytes = (p.TP * row + 15) / 16 * 16 + 16;    // room for the 16-byte widening
  p.stages = WALK_RING_BYTES / (p.S * p.sample_bytes);
  if (p.stages > WALK_MAX_STAGES) p.stages = WALK_MAX_STAGES;
  if (p.stages < 2) p.stages = 2;
  p.threads = 2 * ((p.S * C + 31) / 32 * 32);
  return p;
}

struct WalkParams {
  const void* x;
  const void* bias;
  float* sums;            // [N, 2C]
  int N, C, P;
  int bias_bf16;
  WalkPlan plan;
};

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

// One chain's steps over np positions of a staged tile, its values at
// col[r * C], from s: SQ 0 the s1 chain, 1 the s2 chain; BIAS: add bc first.
// Each group's loads are issued before the previous group's steps.
template <int SQ, bool BIAS, typename T, int CC>
__device__ __forceinline__ float walk_tile(const T* col, int c_arg, int np, float bc, float s) {
  const int C = CC ? CC : c_arg;
  auto step = [&](T v) {
    const float f = to_f32(v);
    s = step_alone<SQ, T>(s, BIAS ? round_t<T>(__fadd_rn(f, bc)) : f);
  };
  auto load = [&](int g, T* v) {
    const T* at = col + g * WALK_GROUP * C;
#pragma unroll
    for (int k = 0; k < WALK_GROUP; ++k) v[k] = at[k * C];
  };
  const int groups = np / WALK_GROUP;
  T a[WALK_GROUP], b[WALK_GROUP];
  if (groups > 0) load(0, a);
  int g = 0;
  for (; g + 2 <= groups; g += 2) {
    load(g + 1, b);
#pragma unroll
    for (int k = 0; k < WALK_GROUP; ++k) step(a[k]);
    if (g + 2 < groups) load(g + 2, a);
#pragma unroll
    for (int k = 0; k < WALK_GROUP; ++k) step(b[k]);
  }
  if (g < groups) {
#pragma unroll
    for (int k = 0; k < WALK_GROUP; ++k) step(a[k]);
  }
  for (int r = groups * WALK_GROUP; r < np; ++r) step(col[r * C]);
  return s;
}

template <typename T, int CC>
__global__ void __launch_bounds__(32 + 512) group_norm_walk_kernel(const WalkParams w) {
  extern __shared__ __align__(128) unsigned char walk_smem[];
  unsigned char* ring = walk_smem + WALK_BAR_BYTES;
  const WalkPlan plan = w.plan;
  const int C = CC ? CC : w.C;
  const int P = w.P, S = plan.S, TP = plan.TP, stages = plan.stages;
  const int stage_bytes = S * plan.sample_bytes;
  const int n0 = blockIdx.x * S, ns = min(S, w.N - n0);
  const int tid = static_cast<int>(threadIdx.x) - 32;   // consumer index; the producer's < 0
  const int half = plan.threads / 2;
  const int sq = tid >= half;                           // 0: s1's chains, 1: s2's
  const int chain = tid - sq * half;
  const int si = chain / C, c = chain - si * C;
  const bool active = tid >= 0 && si < ns;
  const long long row = static_cast<long long>(C) * sizeof(T);
  const uint64_t xaddr = reinterpret_cast<uint64_t>(w.x);
  const int tiles = (P + TP - 1) / TP;

  auto full = [&](int st) { return smem_u32(walk_smem + 8 * st); };
  auto empty = [&](int st) { return smem_u32(walk_smem + 8 * (WALK_MAX_STAGES + st)); };
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

  float s = 0.0f;                                       // this thread's chain
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
    const bool has_bias = w.bias != nullptr;
    float bc = 0.0f;
    if (active && has_bias) {
      bc = round_t<T>(w.bias_bf16
                          ? __bfloat162float(static_cast<const __nv_bfloat16*>(w.bias)[c])
                          : static_cast<const float*>(w.bias)[c]);
    }
    for (int t = 0; t < tiles; ++t) {
      const int st = t % stages;
      mbar_wait(full(st), static_cast<uint32_t>((t / stages) & 1));
      if (active) {
        const long long p0 = static_cast<long long>(t) * TP;
        const int np = static_cast<int>(min(static_cast<long long>(TP), P - p0));
        const uint64_t start = xaddr + ((static_cast<long long>(n0 + si) * P + p0) * row);
        const T* col = reinterpret_cast<const T*>(ring + st * stage_bytes +
                                                  si * plan.sample_bytes + (start & 15)) + c;
        if (sq) {
          s = has_bias ? walk_tile<1, true, T, CC>(col, C, np, bc, s)
                       : walk_tile<1, false, T, CC>(col, C, np, bc, s);
        } else {
          s = has_bias ? walk_tile<0, true, T, CC>(col, C, np, bc, s)
                       : walk_tile<0, false, T, CC>(col, C, np, bc, s);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty(st));      // this warp is done with stage st
    }
  }
  if (active) w.sums[static_cast<long long>(n0 + si) * 2 * C + sq * C + c] = s;
}

template <typename T, int CC>
cudaError_t launch_walk_as(const WalkParams& w, int smem, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      group_norm_walk_kernel<T, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, WALK_SMEM_MAX);
  if (allowed != cudaSuccess) return allowed;
  group_norm_walk_kernel<T, CC><<<(w.N + w.plan.S - 1) / w.plan.S, 32 + w.plan.threads, smem,
                                  stream>>>(w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_walk(const Params& p, cudaStream_t stream) {
  WalkParams w;
  w.x = p.x; w.bias = p.bias; w.bias_bf16 = p.bias_bf16; w.sums = p.sums;
  w.N = p.N; w.C = p.C; w.P = p.P;
  w.plan = walk_plan(p.C, static_cast<int>(sizeof(T)));
  const int smem = WALK_BAR_BYTES + w.plan.stages * w.plan.S * w.plan.sample_bytes;
  if (smem > WALK_SMEM_MAX || w.plan.threads > 512) return cudaErrorInvalidValue;
  switch (p.C) {
    case 12: return launch_walk_as<T, 12>(w, smem, stream);
    case 16: return launch_walk_as<T, 16>(w, smem, stream);
    case 32: return launch_walk_as<T, 32>(w, smem, stream);
    case 64: return launch_walk_as<T, 64>(w, smem, stream);
    default: return launch_walk_as<T, 0>(w, smem, stream);
  }
}

long long align256(long long b) { return (b + 255) / 256 * 256; }

// Byte offsets of the workspace's parts, and its size.
struct Layout {
  long long agg, ext, keys, maps, sums, sb, bar, bytes;
};

Layout layout(int N, int C, int K) {
  const long long chains = 2LL * N * C * K;
  Layout l;
  l.agg = 0;
  l.ext = l.agg + align256(chains * 8);
  l.keys = l.ext + align256(chains * 8);
  l.maps = l.keys + align256(chains * 4);
  l.sums = l.maps + align256(chains * static_cast<long long>(sizeof(Map)));
  l.sb = l.sums + align256(2LL * N * C * 4);
  l.bar = l.sb + align256(static_cast<long long>(N) * C * 8);
  l.bytes = l.bar + 256;
  return l;
}

template <typename T>
int launch(Params p, unsigned char* work, cudaStream_t stream) {
  const int warps = p.C <= MAX_WARPS ? p.C : MAX_WARPS;
  const int threads = 32 * (warps < 4 ? 4 : warps);
  const int rcw = p.R * p.C * static_cast<int>(sizeof(T)) / 4;   // words of a run
  const int stride_words = rcw | 1;                                 // odd: 32 runs on 32 banks
  int groups = 1;                                                  // a power of 2, <= 32
  while (groups < LANES && 2 * groups * p.C <= threads) groups *= 2;
  p.groups = groups;
  const int tile_bytes = 2 * LANES * stride_words * 4;             // phases 1 and 3: 2 tiles
  const int bufs_bytes = threads / 32 * LANES * p.R * static_cast<int>(sizeof(T));  // phase 4
  const int part_offset = ((tile_bytes > bufs_bytes ? tile_bytes : bufs_bytes) + 15) / 16 * 16;
  const int part_bytes = max(groups * 2 * p.C * static_cast<int>(sizeof(Map)),     // 1, 3
                             threads / 32 * LANES * static_cast<int>(sizeof(Map) + 4));  // 4
  const int smem = MAX_C * static_cast<int>(sizeof(float)) + part_offset + part_bytes;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      group_norm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 224 * 1024);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  if (smem > 224 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_norm_scan_kernel<T>, threads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Layout l = layout(p.N, p.C, p.sequential || p.mode == APPLY ? 0 : p.K);
  p.agg = reinterpret_cast<double*>(work + l.agg);
  p.ext = reinterpret_cast<float2*>(work + l.ext);
  p.keys = reinterpret_cast<int*>(work + l.keys);
  p.maps = reinterpret_cast<Map*>(work + l.maps);
  p.sums = reinterpret_cast<float*>(work + l.sums);
  p.sb = reinterpret_cast<float2*>(work + l.sb);
  p.bar = reinterpret_cast<unsigned*>(work + l.bar);
  e = cudaMemsetAsync(p.bar, 0, 2 * sizeof(unsigned), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.sequential && p.mode != APPLY) {
    e = launch_walk<T>(p, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int stride = stride_words * 4 / static_cast<int>(sizeof(T));
  int part_at = part_offset;
  int tile_elems = LANES * stride;
  void* args[] = {&p, &stride, &tile_elems, &part_at};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(group_norm_scan_kernel<T>),
                                  dim3(sms * per_sm), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hst_group_norm(const void* x, const void* bias, int bias_bf16, const void* skip,
                              int activate, const void* gamma, const void* beta, void* y,
                              void* r_out, void* mean, void* rstd, void* work,
                              long long work_bytes, void* clock, int sequential, int mode,
                              void* gsums, int N, int C, int P, int G, int R, double eps,
                              int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (N <= 0 || C <= 0 || P <= 0 || G <= 0 || C % G || C > MAX_C || R < 2 || R > 128 ||
      mode < FUSED || mode > APPLY || (mode == STATS) != (gsums != nullptr) ||
      (R * C * elem) % 4 || static_cast<long long>(P) * C > (1LL << 30) ||
      static_cast<long long>(N) * P * C > (1LL << 40) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(skip) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(r_out)) & (elem - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x = x; p.bias = bias; p.skip = skip; p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta); p.y = y; p.r_out = r_out;
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd); p.eps = eps;
  p.N = N; p.C = C; p.P = P; p.G = G; p.R = R; p.K = (P + LANES * R - 1) / (LANES * R);
  p.bias_bf16 = bias_bf16; p.activate = activate; p.sequential = sequential;
  p.mode = mode; p.gsums = static_cast<float*>(gsums);
  p.clock = static_cast<unsigned long long*>(clock);
  if (static_cast<long long>(p.N) * p.K > (1LL << 31) - 1 ||
      layout(N, C, sequential || mode == APPLY ? 0 : p.K).bytes > work_bytes ||
      (reinterpret_cast<uintptr_t>(work) & 255)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* w = static_cast<unsigned char*>(work);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, w, s) : launch<float>(p, w, s);
}
