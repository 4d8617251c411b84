// Bit-clock recovery for a bank of M lanes: the majority vote over each
// lane's last L symbols and the bit-clock PLL that samples one bit per
// symbol period.
//
// Replaces the TPU kernels libsdr_tpu/ops/pallas_bitsync.py::_kernel (and
// its 'split' variant _kernel_split, entry pll_pallas: every lane has the
// same parameters) and ::_kernel_bank (and _kernel_bank_split, entry
// pll_pallas_bank: per-lane omega bounds, gain, bit mapping and window L).
// One kernel pair serves both: a lane's parameters come from per-lane
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
// phase needs the previous step's omega through a chain of dependent
// instructions (add, compare, the wrap's add; with a nudge also 0.5 -
// phase, FMA, max, min).  With one lane per thread the time is T times
// that chain however many lanes there are: on an H100 the serial kernel
// took ~30 ns a step, flat from 64 to 8,192 lanes (PERF.md).  The scaling
// axis is lanes, as on the TPU.  The majority pass is parallel in time and moves whole
// 128-byte lines (a first version with one byte stream per thread took
// 38.6 ms for 8,192 lanes x 2^16 steps, this one 1.06 ms).
//
// Design:
// * Two kernels.  The majority vote does not depend on the PLL, so
//   pll_majority computes it for every step in parallel (one warp per lane
//   and chunk of kMajChunk steps, the window sums as differences of a warp
//   scan's prefix sums, exact in integers; see below) and writes
//   bn | crossed << 1 per step; pll_serial then runs only the
//   recurrence, one thread per lane, reading 16 steps per 16-byte load and
//   writing 16 packed outputs per store, and running the nudge only on
//   steps where some lane of the warp crosses (pll_step).  This is the JAX
//   package's 'split' variant; the integer sums make the two bit-identical
//   to its ring.
// * No sign ring: the window sums come from the prefix sums of the signs,
//   the first L-1 steps of a block from the carried signs.  The window is
//   limited by the carried signs' width (L - 1 <= R) and by the prefix
//   sums each warp keeps (L <= kMaxWindow = 896; the JAX kernels took
//   L <= 512).
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
constexpr int kLanesPerBlock = 32;  // pll_serial: one warp per block

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
  uint8_t* bncr;  // (M, T) scratch: bn | crossed << 1
  uint8_t* out;   // (M, T) bit | valid << 1
  int* ss_out;
  float* ph_out;
  float* om_out;
  int* lb_out;
  long long M, T;
  int R;
};

__device__ __forceinline__ int sign_at(const PllParams& p, long long m,
                                       const uint8_t* row, long long t) {
  return t >= 0 ? (row[t] ? 1 : -1) : p.signs[m * p.R + p.R + t];
}

// The majority vote of one lane over one chunk of kMajChunk steps, by one
// warp: with P(t) the sum of the signs from t0 - L + 1 to t (P(t0 - L) =
// 0), the window sum is S(t) = P(t) - P(t - L).  Lane l takes steps
// g + 4l .. g + 4l + 3 of each group of 128, so the warp's byte loads and
// stores each fill one 128-byte line; a warp scan gives P, and a ring of
// the last kRing values of P in shared memory gives P(t - L).  Integer sums
// are exact, so S equals the running sum of the reference's ring.
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
  uint8_t* o = p.bncr + m * p.T;
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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t + k < t1) {
        const int crossed = (prev < 0) != (sw[k] < 0);
        o[t + k] = (uint8_t)((sw[k] > 0 ? 1 : 0) | (crossed << 1));
      }
      prev = sw[k];
    }
    base = __shfl_sync(full, excl + pre[3], 31);
    last = __shfl_sync(full, sw[3], 31);
    __syncwarp();  // every read of the ring is done before the next writes
  }
  // The window sum at the block's last step (base is P(T - 1) there).
  if (t1 == p.T && lane == 0) p.ss_out[m] = base - ring[slot(p.T - 1 - L)];
}

// One PLL step on b = bn | crossed << 1; returns bit | emit << 1.
//
// kFirst: the reference clamps omega every step.  Once clamped, omega
// changes only when nudged, so after a block's first steps (kFirst) the
// clamp runs only with the nudge, and both run only when some lane of the
// warp crosses (a warp vote on precomputed flags, off the chain): a step
// without one keeps three instructions (add, compare, wrap) on the
// loop-carried chain instead of seven.
template <bool kFirst>
__device__ __forceinline__ uint32_t pll_step(uint32_t b, float& ph, float& om,
                                             int& lb, float omin, float omax,
                                             float g, bool tr,
                                             unsigned lanes) {
  ph = __fadd_rn(ph, om);
  const bool emit = ph >= 1.f;
  if (emit) {
    ph = __fsub_rn(ph, 1.f);
    lb = ((lb << 1) | (int)(b & 1u)) & 0xFFFF;
  }
  const int bit = tr ? ((lb ^ (lb >> 1) ^ 1) & 1) : (lb & 1);
  if (kFirst) {
    if (b & 2u) om = __fmaf_rn(g, __fsub_rn(0.5f, ph), om);
    om = fminf(fmaxf(om, omin), omax);
  } else if (__any_sync(lanes, b & 2u)) {
    if (b & 2u) {
      om = fminf(fmaxf(__fmaf_rn(g, __fsub_rn(0.5f, ph), om), omin), omax);
    }
  }
  return (uint32_t)bit | (emit ? 2u : 0u);
}

// 16 steps on the 16 bytes of v; returns their 16 output bytes.
template <bool kFirst>
__device__ __forceinline__ uint4 pll_16(uint4 v, float& ph, float& om, int& lb,
                                        float omin, float omax, float g,
                                        bool tr, unsigned lanes) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t acc = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      acc |= pll_step<kFirst>((w[k] >> (8 * s)) & 0xFFu, ph, om, lb, omin,
                              omax, g, tr, lanes)
             << (8 * s);
    }
    o[k] = acc;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kLanesPerBlock) pll_serial(const PllParams p) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= p.M) return;
  const unsigned lanes = __activemask();  // the lanes of this warp's votes
  float ph = p.ph_in[m], om = p.om_in[m];
  int lb = p.lb_in[m];
  const float omin = p.omin_v ? p.omin_v[m] : p.omin;
  const float omax = p.omax_v ? p.omax_v[m] : p.omax;
  const float g = p.gain_v ? p.gain_v[m] : p.gain;
  const bool tr = (p.trans_v ? p.trans_v[m] : p.trans) != 0;
  const uint8_t* in = p.bncr + m * p.T;
  uint8_t* out = p.out + m * p.T;
  if ((p.T & 15) == 0) {
    // Rows start 16-byte aligned: 16 steps per load and per store, the
    // next group's load issued before this group's steps.
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const long long n4 = p.T / 16;
    uint4 nxt = in4[0];
    for (long long q = 0; q < n4; ++q) {
      const uint4 cur = nxt;
      if (q + 1 < n4) nxt = in4[q + 1];
      out4[q] = q == 0 ? pll_16<true>(cur, ph, om, lb, omin, omax, g, tr,
                                      lanes)
                       : pll_16<false>(cur, ph, om, lb, omin, omax, g, tr,
                                       lanes);
    }
  } else {
    for (long long t = 0; t < p.T; ++t) {
      out[t] = (uint8_t)(t < 16 ? pll_step<true>(in[t], ph, om, lb, omin,
                                                 omax, g, tr, lanes)
                                : pll_step<false>(in[t], ph, om, lb, omin,
                                                  omax, g, tr, lanes));
    }
  }
  p.ph_out[m] = ph;
  p.om_out[m] = om;
  p.lb_out[m] = lb;
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// Majority vote + PLL over sym (M, T) uint8 for M lanes.  All pointers are
// device pointers; signs is (M, R) int32 with each lane's carried signs in
// its last L-1 columns, oldest first (the columns before them are not
// read); ss_in, lb_in, ss_out, lb_out (M,) int32; ph/om (M,) float32; bncr
// and out (M, T) uint8.  The *_v vectors (M,) give per-lane parameters;
// where one is null, its scalar applies to every lane.  Returns 0, -1 when
// the shape or a window is outside the gate (1 <= L <= min(R + 1,
// kMaxWindow); per-lane windows are checked by the caller), else a
// cudaError_t.
int sdr_pll(const uint8_t* sym, const int* signs, const int* ss_in,
            const float* ph_in, const float* om_in, const int* lb_in,
            const float* omin_v, const float* omax_v, const float* gain_v,
            const int* trans_v, const int* ell_v, float omin, float omax,
            float gain, int trans, int ell, uint8_t* bncr, uint8_t* out,
            int* ss_out, float* ph_out, float* om_out, int* lb_out,
            long long M, long long T, int R, void* stream) {
  if (M < 1 || T < 1 || R < 0 || !sym || !bncr || !out ||
      (R > 0 && !signs) ||
      (!ell_v && (ell < 1 || ell > R + 1 || ell > kMaxWindow))) {
    return -1;
  }
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
  p.bncr = bncr;
  p.out = out;
  p.ss_out = ss_out;
  p.ph_out = ph_out;
  p.om_out = om_out;
  p.lb_out = lb_out;
  p.M = M;
  p.T = T;
  p.R = R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (T + kMajChunk - 1) / kMajChunk;
  const long long warps = M * n_chunks;
  pll_majority<<<(unsigned)((warps + kMajWarps - 1) / kMajWarps),
                 kMajWarps * 32, 0, s>>>(p, n_chunks);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  pll_serial<<<(unsigned)((M + kLanesPerBlock - 1) / kLanesPerBlock),
               kLanesPerBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
