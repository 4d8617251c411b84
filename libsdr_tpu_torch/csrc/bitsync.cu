// Bit-clock recovery for a bank of M lanes: the majority vote over each
// lane's last L symbols and the bit-clock PLL that samples one bit per
// symbol period.
//
// Replaces the TPU kernels libsdr_tpu/ops/pallas_bitsync.py::_kernel (and
// its 'split' variant _kernel_split, entry pll_pallas: every lane has the
// same parameters) and ::_kernel_bank (and _kernel_bank_split, entry
// pll_pallas_bank: per-lane omega bounds, gain, bit mapping and window L).
// One set of kernels serves both: a lane's parameters come from per-lane
// vectors when the caller gives them, else from scalars.
//
// Per lane and step t (sym[t] in {0, nonzero}, sign = sym ? +1 : -1):
//
//   s_now   = rs + sign(t)                      (rs: the last L-1 signs' sum)
//   bn      = s_now > 0
//   crossed = (last < 0) != (s_now < 0)         (last: the previous s_now)
//   rs      = s_now - sign(t - L + 1);  last = s_now
//   phase  += omega;  emit = phase >= 1;  if emit: phase -= 1,
//             last_bits = ((last_bits << 1) | bn) & 0xFFFF
//   bit     = transition ? (lb ^ lb >> 1 ^ 1) & 1 : lb & 1
//   if crossed: omega = fma(gain, 0.5 - phase, omega)   (one rounding)
//   omega   = min(max(omega, omega_min), omega_max)
//   out[t]  = bit | emit << 1
//
// with sign(t) for t < 0 from the carried signs.  The JAX package computes
// the nudge omega + gain*(0.5 - phase), which XLA contracts into one fused
// multiply-add; __fmaf_rn rounds once the same way, so the bits, the valid
// flags and every carried value are equal to the JAX scan's.
//
// What bounds it on an H100: per lane-step it reads 1 byte and writes 1
// (the JAX cost estimate counts 2 bytes and ~30 operations), so the
// roofline bound is microseconds, but the PLL is a recurrence: each step's
// phase needs the previous step's through the add, the compare with 1 and
// the wrap's subtraction (t - 1 is exact there, Sterbenz), about 12
// cycles.  No time-parallel form is bit-exact (a scan of affine maps
// rounds differently, and the map from one crossing to the next has
// determinant 1, so speculative chunks never merge), so the chain's T
// steps are the floor: T x ~6 ns at the 1.98 GHz boost clock.  What the
// design does about it is to keep nothing else on that chain and to keep
// the warp that runs it from waiting on other lanes.
//
// Design, five kernels a call:
// * pll_majority: the majority vote does not depend on the PLL, so it is
//   computed for every step in parallel (one warp per lane and chunk of
//   kMajChunk steps; the window sums as differences of a warp scan's prefix
//   sums, exact in integers, so bit-identical to the reference's ring) and
//   written as bit masks: per lane and 32-step word, one uint32 of bn and
//   one of crossed.  The window is limited by the carried signs' width
//   (L - 1 <= R) and by the prefix sums each warp keeps (L <= kMaxWindow).
// * pll_serial: the recurrence alone, carrying only (phase, omega).  A word
//   whose crossed mask is 0 runs 32 straight-line steps (add, set 1.0 or
//   0.0 by the compare, subtract it; the emit bit OR-ed into a register)
//   with no branch; a word with crossings runs by groups of 8 steps, and
//   only a group with a crossing of the lane's own runs its steps with the
//   nudges predicated on its mask bits.  (Jumping into the straight-line
//   run from one crossing to the next, by a switch or brx.idx, and a loop
//   over the word's steps were slower: PERF.md.)  The emit bits are
//   written as a mask (M, W) like the inputs.  No warp vote: with few
//   lanes in a warp, a warp pays only for its own lanes' crossings, and
//   the bank's M lanes spread over as many schedulers (one warp a block).
//   Above a count of warps (kPllWarps), lanes are packed up to 32 a warp,
//   where issue, not latency, binds (sdr_pll_lanes_per_warp, from M).
// * pll_sums, pll_scan, pll_bits: the sampled bits, rebuilt in parallel.
//   last_bits after step t is the last 16 bn bits at emit steps <= t
//   shifted onto last_bits_in, so a run of steps acts on it as a summary
//   (n = its emit count capped at 16, the last n emitted bits), and
//   summaries compose associatively.  pll_sums summarises each word and
//   scans the words of each chunk of kChunkWords (a warp); pll_scan scans
//   the chunks of each lane from last_bits_in (a warp a lane, 32 chunks at
//   a time) and gives last_bits_out; pll_bits rebuilds each word's 32
//   output bytes from the state entering it (a thread a word, coalesced
//   32-byte rows).  O(T) however rarely a lane emits.
// * Layout: lane-major (M, T), the BitStream's own (channels..., T)
//   layout, so no transpose; the JAX kernel ran time-major (T, M).
// * The entry point returns cudaGetLastError() after the launches, or -1
//   when the shape is outside the gate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdr {
namespace {

constexpr int kMajChunk = 4096;  // steps per warp of pll_majority
constexpr int kMajWarps = 4;     // warps per block of pll_majority
constexpr int kRing = 1024;      // P values kept per warp (power of two)
constexpr int kMaxWindow = kRing - 128;  // the ring outlives a group by L
constexpr int kChunkWords = 32;  // words per chunk of the bits pass
constexpr int kBitsThreads = 256;
// Warps the serial pass aims for before it packs more lanes into a warp
// (sdr_pll_lanes_per_warp): two a scheduler of the H100's 132 SMs; the
// lane cut measured on the card (PERF.md).
constexpr long long kPllWarps = 1056;
constexpr int kCrossGrain = 8;   // steps a group of a word with crossings

struct PllParams {
  const uint8_t* sym;  // (M, T) symbols
  const int* signs;    // (M, R) carried signs; a lane's in its last L-1
  const int* ss_in;    // (M,) previous window sum
  const float* ph_in;
  const float* om_in;
  const int* lb_in;
  // per-lane parameters (M,), or null for the scalars below
  const float* omin_v;
  const float* omax_v;
  const float* gain_v;
  const int* trans_v;
  const int* ell_v;
  float omin, omax, gain;
  int trans, ell;
  // scratch, (M, W) words of 32 steps each: bit k of word w is step 32w+k
  uint32_t* bn_w;     // bn
  uint32_t* cr_w;     // crossed
  uint32_t* emit_w;   // emit
  uint32_t* scan_w;   // each word's summary composed over its chunk so far
  uint32_t* csum;     // (M, C) each chunk's summary
  int* enter;         // (M, C) last_bits entering each chunk
  uint8_t* out;       // (M, T) bit | valid << 1
  int* ss_out;
  float* ph_out;
  float* om_out;
  int* lb_out;
  long long M, T, W, C;
  int R;
};

__device__ __forceinline__ int sign_at(const PllParams& p, long long m,
                                       const uint8_t* row, long long t) {
  return t >= 0 ? (row[t] ? 1 : -1) : p.signs[m * p.R + p.R + t];
}

// The majority vote of one lane over one chunk of kMajChunk steps, by one
// warp: with P(t) the sum of the signs from t0 - L + 1 to t (P(t0 - L) =
// 0), the window sum is S(t) = P(t) - P(t - L).  Lane l takes steps
// g + 4l .. g + 4l + 3 of each group of 128, so the warp's byte loads fill
// one 128-byte line; a warp scan gives P, and a ring of the last kRing
// values of P in shared memory gives P(t - L).  Integer sums are exact, so
// S equals the running sum of the reference's ring.  Each lane's 4 bits
// of bn and of crossed are OR-ed over 8 lanes into a word.
__global__ void __launch_bounds__(kMajWarps * 32)
pll_majority(const PllParams p, long long n_chunks) {
  __shared__ int rings[kMajWarps][kRing];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.x * (long long)kMajWarps + (threadIdx.x >> 5);
  if (w >= p.M * n_chunks) return;  // uniform across the warp
  int* ring = rings[threadIdx.x >> 5];
  const long long m = w % p.M;
  const long long t0 = (w / p.M) * kMajChunk;
  const long long t1 = min(p.T, t0 + kMajChunk);
  const int L = p.ell_v ? p.ell_v[m] : p.ell;
  const uint8_t* row = p.sym + m * p.T;
  uint32_t* bn_row = p.bn_w + m * p.W;
  uint32_t* cr_row = p.cr_w + m * p.W;
  auto slot = [](long long t) { return (int)((t + kRing) & (kRing - 1)); };
  auto scan = [&](int v) {  // inclusive prefix sum over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(full, v, off);
      if (lane >= off) v += u;
    }
    return v;
  };
  // P over the L - 1 steps before the chunk (the carried signs before the
  // block's first step).
  if (lane == 0) ring[slot(t0 - L)] = 0;
  int base = 0;  // P at the step before the next group
  for (long long g = t0 - L + 1; g < t0; g += 32) {
    const long long t = g + lane;
    const int v = scan(t < t0 ? sign_at(p, m, row, t) : 0) + base;
    if (t < t0) ring[slot(t)] = v;
    base = __shfl_sync(full, v, 31);
  }
  // S(t0 - 1): the carried window sum at the block's start.
  int last = t0 == 0 ? p.ss_in[m] : base + sign_at(p, m, row, t0 - L);
  __syncwarp();
  for (long long g = t0; g < t1; g += 128) {
    const long long t = g + 4 * lane;
    int pre[4], acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += t + k < t1 ? (row[t + k] ? 1 : -1) : 0;
      pre[k] = acc;
    }
    const int excl = scan(acc) - acc + base;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t + k < t1) ring[slot(t + k)] = excl + pre[k];
    }
    __syncwarp();
    int sw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sw[k] = t + k < t1 ? excl + pre[k] - ring[slot(t + k - L)] : 0;
    }
    int prev = __shfl_up_sync(full, sw[3], 1);
    if (lane == 0) prev = last;
    const int sh = 4 * (lane & 7);
    uint32_t vb = 0, vc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t + k < t1) {
        vb |= (uint32_t)(sw[k] > 0) << (sh + k);
        vc |= (uint32_t)((prev < 0) != (sw[k] < 0)) << (sh + k);
      }
      prev = sw[k];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      vb |= __shfl_xor_sync(full, vb, off);
      vc |= __shfl_xor_sync(full, vc, off);
    }
    const long long tw = g + 32 * (lane >> 3);
    if ((lane & 7) == 0 && tw < t1) {
      bn_row[tw >> 5] = vb;
      cr_row[tw >> 5] = vc;
    }
    base = __shfl_sync(full, excl + pre[3], 31);
    last = __shfl_sync(full, sw[3], 31);
    __syncwarp();  // every read of the ring is done before the next writes
  }
  // The window sum at the block's last step (base is P(T - 1) there).
  if (t1 == p.T && lane == 0) p.ss_out[m] = base - ring[slot(p.T - 1 - L)];
}

// One lane's PLL parameters.
struct Pll {
  float omin, omax, g;
};

// One step without a nudge: phase += omega, wrapped; returns the emit bit.
// The wrap subtracts the compare's 1.0 or 0.0 (set.ge.f32 gives the float
// itself: t - 1 is exact for t in [1, 2), t - 0 is t), so the chain is
// add -> set -> add with no predicate; a compare and select took ~35% more
// time a step (PERF.md).
__device__ __forceinline__ uint32_t phase_step(float& ph, const float om) {
  const float t = __fadd_rn(ph, om);
  float d;
  asm("set.ge.f32.f32 %0, %1, 0f3F800000;" : "=f"(d) : "f"(t));
  ph = __fsub_rn(t, d);
  return __float_as_uint(d) >> 23 & 1u;  // 1.0f has bit 23 set, 0.0f not
}

// The nudge of a crossing step, clamped.
__device__ __forceinline__ void nudge(float& om, const float ph,
                                      const Pll& q) {
  om = fminf(fmaxf(__fmaf_rn(q.g, __fsub_rn(0.5f, ph), om), q.omin),
             q.omax);
}

// kN steps without a crossing, straight-line; their emit bits from bit 0.
template <int kN>
__device__ __forceinline__ uint32_t plain_steps(float& ph, const float om) {
  uint32_t e = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) e |= phase_step(ph, om) << k;
  return e;
}

// kN steps with the nudge after each step whose bit of c is set, the
// nudge predicated on that bit (no branch).
template <int kN>
__device__ __forceinline__ uint32_t crossing_steps(const uint32_t c, float& ph,
                                                   float& om, const Pll& q) {
  uint32_t e = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    e |= phase_step(ph, om) << k;
    if (c & (1u << k)) nudge(om, ph, q);
  }
  return e;
}

// One full word of 32 steps with crossed mask c; returns its emit mask.
// Without a crossing, 32 straight-line steps.  With crossings, by groups
// of kCrossGrain steps: a group without one straight-line, a group with
// one with its nudges predicated (a nudge puts four more operations on the
// chain, so only the crossing's own group pays them).
__device__ __forceinline__ uint32_t word_steps(const uint32_t c, float& ph,
                                               float& om, const Pll& q) {
  if (c == 0u) return plain_steps<32>(ph, om);
  uint32_t e = 0;
#pragma unroll
  for (int b = 0; b < 32; b += kCrossGrain) {
    const uint32_t cb = (uint32_t)((c >> b) & ((1ull << kCrossGrain) - 1));
    if (cb == 0u) {
      e |= plain_steps<kCrossGrain>(ph, om) << b;
    } else {
      e |= crossing_steps<kCrossGrain>(cb, ph, om, q) << b;
    }
  }
  return e;
}

// Steps k0 .. n-1 of a word, one at a time (a block's first and last word).
__device__ __forceinline__ uint32_t word_steps_from(const uint32_t c, int k0,
                                                    int n, float& ph,
                                                    float& om, const Pll& q) {
  uint32_t e = 0;
  for (int k = k0; k < n; ++k) {
    e |= phase_step(ph, om) << k;
    if (c & (1u << k)) nudge(om, ph, q);
  }
  return e;
}

// The recurrence of lanes_per_warp lanes, one warp a block: thread j < lpw
// runs lane blockIdx.x * lpw + j over its crossed mask and writes its emit
// mask, phase and omega.
__global__ void __launch_bounds__(32) pll_serial(const PllParams p, int lpw) {
  if ((int)threadIdx.x >= lpw) return;
  const long long m = blockIdx.x * (long long)lpw + threadIdx.x;
  if (m >= p.M) return;
  float ph = p.ph_in[m], om = p.om_in[m];
  const Pll q{p.omin_v ? p.omin_v[m] : p.omin,
              p.omax_v ? p.omax_v[m] : p.omax,
              p.gain_v ? p.gain_v[m] : p.gain};
  const uint32_t* cr = p.cr_w + m * p.W;
  uint32_t* em = p.emit_w + m * p.W;
  const long long W = p.W;
  const int last_n = (int)(p.T - 32 * (W - 1));  // steps of the last word
  const uint32_t c0 = cr[0];
  // Step 0.  The reference clamps omega at every step; once clamped, omega
  // changes only by the nudge, which clamps, so only the block's first
  // step clamps without a crossing.
  uint32_t e0 = phase_step(ph, om);
  if (c0 & 1u) om = __fmaf_rn(q.g, __fsub_rn(0.5f, ph), om);
  om = fminf(fmaxf(om, q.omin), q.omax);
  if (W == 1) {
    em[0] = e0 | word_steps_from(c0, 1, last_n, ph, om, q);
  } else {
    em[0] = e0 | word_steps_from(c0, 1, 32, ph, om, q);
    // Full words 1 .. wf - 1 on the straight-line path, their masks loaded
    // four words ahead; then a short last word one step at a time.
    const long long wf = last_n == 32 ? W : W - 1;
    auto at = [&](long long w) { return w < wf ? cr[w] : 0u; };
    uint32_t b0 = at(1), b1 = at(2), b2 = at(3), b3 = at(4);
    for (long long w = 1; w < wf; ++w) {
      const uint32_t c = b0;
      b0 = b1;
      b1 = b2;
      b2 = b3;
      b3 = at(w + 4);
      em[w] = word_steps(c, ph, om, q);
    }
    if (last_n < 32) {
      em[W - 1] = word_steps_from(cr[W - 1], 0, last_n, ph, om, q);
    }
  }
  p.ph_out[m] = ph;
  p.om_out[m] = om;
}

// A summary of a run of steps: bits 16-20 its emit count n capped at 16,
// bits 0-15 the bn bits of its last n emits, the latest in bit 0.
__device__ __forceinline__ uint32_t word_summary(uint32_t e, const uint32_t b) {
  uint32_t n = 0, bits = 0;
  while (e != 0u && n < 16u) {
    const int k = 31 - __clz(e);
    bits |= ((b >> k) & 1u) << n;
    ++n;
    e ^= 1u << k;
  }
  return n << 16 | bits;
}

// The summary of run s1 followed by run s2.
__device__ __forceinline__ uint32_t compose(const uint32_t s1,
                                            const uint32_t s2) {
  const uint32_t n2 = s2 >> 16;
  const uint32_t n = min((s1 >> 16) + n2, 16u);
  return n << 16 | ((((s1 & 0xFFFFu) << n2) | s2) & 0xFFFFu);
}

// last_bits after a run with summary s, from lb before it.
__device__ __forceinline__ int apply(const int lb, const uint32_t s) {
  const uint32_t n = s >> 16;
  return n == 0u ? lb : (int)((((uint32_t)lb << n) | s) & 0xFFFFu);
}

// Inclusive scan of summaries over a warp, in lane order.
__device__ __forceinline__ uint32_t scan_summaries(uint32_t s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s = compose(u, s);
  }
  return s;
}

// One warp per lane and chunk of kChunkWords words: each word's summary
// composed over the chunk up to it, and the chunk's.
__global__ void __launch_bounds__(128) pll_sums(const PllParams p) {
  const int lane = threadIdx.x & 31;
  const long long wi = blockIdx.x * 4LL + (threadIdx.x >> 5);
  if (wi >= p.M * p.C) return;  // uniform across the warp
  const long long m = wi / p.C, c = wi % p.C;
  const long long w = c * kChunkWords + lane;
  const long long i = m * p.W + w;
  uint32_t s = w < p.W ? word_summary(p.emit_w[i], p.bn_w[i]) : 0u;
  s = scan_summaries(s, lane);
  if (w < p.W) p.scan_w[i] = s;
  if (lane == 31) p.csum[wi] = s;
}

// One warp per lane: last_bits entering each chunk, from last_bits_in, and
// last_bits_out.
__global__ void __launch_bounds__(128) pll_scan(const PllParams p) {
  const int lane = threadIdx.x & 31;
  const long long m = blockIdx.x * 4LL + (threadIdx.x >> 5);
  if (m >= p.M) return;  // uniform across the warp
  int lb = p.lb_in[m];
  for (long long c0 = 0; c0 < p.C; c0 += 32) {
    const long long c = c0 + lane;
    const uint32_t s =
        scan_summaries(c < p.C ? p.csum[m * p.C + c] : 0u, lane);
    uint32_t before = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) before = 0u;
    if (c < p.C) p.enter[m * p.C + c] = apply(lb, before);
    lb = apply(lb, __shfl_sync(0xffffffffu, s, 31));
  }
  if (lane == 0) p.lb_out[m] = lb;
}

// One thread per lane and word: the word's 32 output bytes from the
// last_bits entering it (only its two low bits decide a bit).
__global__ void __launch_bounds__(kBitsThreads) pll_bits(const PllParams p) {
  const long long i = blockIdx.x * (long long)kBitsThreads + threadIdx.x;
  if (i >= p.M * p.W) return;
  const long long m = i / p.W, w = i % p.W, c = w / kChunkWords;
  int lb = p.enter[m * p.C + c];
  if (w % kChunkWords) lb = apply(lb, p.scan_w[i - 1]);
  const uint32_t e = p.emit_w[i], b = p.bn_w[i];
  const bool tr = (p.trans_v ? p.trans_v[m] : p.trans) != 0;
  uint32_t x = (uint32_t)lb, o[8];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t ek = (e >> k) & 1u;
    if (ek) x = (x << 1) | ((b >> k) & 1u);
    const uint32_t bit = tr ? ((x ^ (x >> 1) ^ 1u) & 1u) : (x & 1u);
    const uint32_t byte = (bit | ek << 1) << (8 * (k & 3));
    o[k >> 2] = (k & 3) ? o[k >> 2] | byte : byte;
  }
  uint8_t* dst = p.out + m * p.T + 32 * w;
  const long long n = min(32LL, p.T - 32 * w);
  if (n == 32 && (p.T & 15) == 0) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    for (int k = 0; k < n; ++k) dst[k] = (uint8_t)(o[k >> 2] >> (8 * (k & 3)));
  }
}

long long words_of(long long T) { return (T + 31) / 32; }
long long chunks_of(long long T) {
  return (words_of(T) + kChunkWords - 1) / kChunkWords;
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// int32 words of scratch that sdr_pll needs for M lanes of T steps.
long long sdr_pll_scratch_words(long long M, long long T) {
  return M * (4 * words_of(T) + 2 * chunks_of(T));
}

// The serial pass's lanes per warp for M lanes: one while M warps fit the
// warp budget kPllWarps, else the fewest (a power of two, at most 32)
// that keep ceil(M / lanes) within it.  A build with -DSDR_PLL_LANES=n
// (1, 2, 4, 8, 16 or 32) takes n lanes a warp at every M, for measuring
// the layouts (tools/pll_times.py --sweep).
int sdr_pll_lanes_per_warp(long long M) {
#ifdef SDR_PLL_LANES
  static_assert(SDR_PLL_LANES >= 1 && SDR_PLL_LANES <= 32 &&
                    (SDR_PLL_LANES & (SDR_PLL_LANES - 1)) == 0,
                "SDR_PLL_LANES: a power of two, 1 to 32");
  return SDR_PLL_LANES;
#else
  int l = 1;
  while (l < 32 && (M + l - 1) / l > kPllWarps) l <<= 1;
  return l;
#endif
}

// Majority vote + PLL over sym (M, T) uint8 for M lanes.  All pointers are
// device pointers; signs is (M, R) int32 with each lane's carried signs in
// its last L-1 columns, oldest first (the columns before them are not
// read); ss_in, lb_in, ss_out, lb_out (M,) int32; ph/om (M,) float32; out
// (M, T) uint8; scratch sdr_pll_scratch_words(M, T) int32 words.  The *_v
// vectors (M,) give per-lane parameters; where one is null, its scalar
// applies to every lane.  The serial pass takes sdr_pll_lanes_per_warp(M)
// lanes a warp.  Returns 0, -1
// when the shape or a window is outside the gate (1 <= L <= min(R + 1,
// kMaxWindow); per-lane windows are checked by the caller), else a
// cudaError_t.
int sdr_pll(const uint8_t* sym, const int* signs, const int* ss_in,
            const float* ph_in, const float* om_in, const int* lb_in,
            const float* omin_v, const float* omax_v, const float* gain_v,
            const int* trans_v, const int* ell_v, float omin, float omax,
            float gain, int trans, int ell, int* scratch, uint8_t* out,
            int* ss_out, float* ph_out, float* om_out, int* lb_out,
            long long M, long long T, int R, void* stream) {
  if (M < 1 || T < 1 || R < 0 || !sym || !scratch || !out ||
      (R > 0 && !signs) ||
      (!ell_v && (ell < 1 || ell > R + 1 || ell > kMaxWindow))) {
    return -1;
  }
  const int lanes_per_warp = sdr_pll_lanes_per_warp(M);
  PllParams p{};
  p.sym = sym;
  p.signs = signs;
  p.ss_in = ss_in;
  p.ph_in = ph_in;
  p.om_in = om_in;
  p.lb_in = lb_in;
  p.omin_v = omin_v;
  p.omax_v = omax_v;
  p.gain_v = gain_v;
  p.trans_v = trans_v;
  p.ell_v = ell_v;
  p.omin = omin;
  p.omax = omax;
  p.gain = gain;
  p.trans = trans;
  p.ell = ell;
  p.M = M;
  p.T = T;
  p.W = words_of(T);
  p.C = chunks_of(T);
  p.R = R;
  uint32_t* s = reinterpret_cast<uint32_t*>(scratch);
  const long long mw = M * p.W;
  p.bn_w = s;
  p.cr_w = s + mw;
  p.emit_w = s + 2 * mw;
  p.scan_w = s + 3 * mw;
  p.csum = s + 4 * mw;
  p.enter = reinterpret_cast<int*>(s + 4 * mw + M * p.C);
  p.out = out;
  p.ss_out = ss_out;
  p.ph_out = ph_out;
  p.om_out = om_out;
  p.lb_out = lb_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (T + kMajChunk - 1) / kMajChunk;
  const long long warps = M * n_chunks;
  pll_majority<<<(unsigned)((warps + kMajWarps - 1) / kMajWarps),
                 kMajWarps * 32, 0, st>>>(p, n_chunks);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  pll_serial<<<(unsigned)((M + lanes_per_warp - 1) / lanes_per_warp), 32, 0,
               st>>>(p, lanes_per_warp);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  pll_sums<<<(unsigned)((M * p.C + 3) / 4), 128, 0, st>>>(p);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  pll_scan<<<(unsigned)((M + 3) / 4), 128, 0, st>>>(p);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  pll_bits<<<(unsigned)((mw + kBitsThreads - 1) / kBitsThreads),
             kBitsThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
