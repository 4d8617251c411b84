// BPSK31's demodulator recurrence for a bank of C channels, one thread a
// channel, every sample of the block in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as one
// lax.scan over the block's samples (libsdr_tpu/ops/psk31.py:183), which
// XLA compiles into a loop on the accelerator.  The port's plain version
// (ops/psk31.py::bpsk31_scan_plain) is the same step as a numpy loop over
// time on the host; this kernel keeps the step on the card, so a block
// makes no host copy and a pipeline holding BPSK31 can be captured into a
// CUDA graph (core/graph.py::compile_chunked).
//
// Per channel and sample x (complex), with the carry of the JAX op's dict:
//
//   mu   -= 1;  P = wrap(P + F);  dl[idx] = exp(i P) x;  idx = (idx+1) % 8
//   produce = mu <= 1
//   y    = sum_k dl[k] * bank[clip(rint(128 mu), 0, 128)][(k - idx) % 8]
//   c0   = y.re > 0 ? -1 : 1
//   err  = clip((y.re - p1.re) c0' - (c0 - c1') p0.re, -1, 1)
//   om   = clip(omega + g_om err, omin, omax);  mu' = (mu + om) + g_mu err
//   phi  = |y|^2 == 0 ? 0 : -y.re y.im / |y|^2
//   F'   = clip(F + beta phi, -df, df);  P' = wrap((P + F') + alpha phi)
//   the phase history's sum, previous value and index decide a symbol cut
//   (early on a zero crossing), which emits the differential bit;
//   where produce: p2 <- p1 <- p0 <- y, c2 <- c1 <- c0, and P, F, mu,
//   omega take their new values (else mu alone, and P = wrap(P + F)).
//
// Every operation rounds as the plain version's float32 numpy operation
// does, in its order: the step is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so that nvcc contracts nothing into an FMA, and
// rintf rounds half to even as np.round.  The phasor is cos and sin of P
// in float64 rounded to float32, on both sides: the float32 cos/sin of
// CUDA and of numpy are different approximations (within an ulp or two of
// each other), and a one-ulp difference in the phasor sends the carrier
// PLL another way on a channel without a signal.  So the kernel's bits,
// valid flags and every carried value equal the plain version's.
//
// What bounds it on an H100: per channel-sample it reads 8 bytes and
// writes 2, so the roofline bound is microseconds, but every step is on
// one chain: the phasor needs P, which needs the previous step's phi,
// which needs y, which needs mu's row of the bank; there is no
// time-parallel form (the rotation depends on the carrier PLL and the taps
// on mu).  The chain's T steps are the floor: the float64 sincos (~40
// dependent float64 operations on the H100's 1:2 float64 units), the
// shared-memory row of taps, the 8-tap sum (8 dependent adds), the
// division and the updates, a few hundred cycles a step.  What the design
// does about it is to keep the whole state in registers and nothing else
// on that chain:
// * one thread a channel, one channel a warp and one warp a block (the
//   warp's other lanes only load the bank): a lane of its own keeps each
//   channel's chain off its neighbours' issue slots;
// * the 8-deep delay ring in registers.  A register array indexed by a
//   runtime index spills to local memory, and the ring index is one scalar
//   of the carry shared by every channel, advancing by one a sample.  The
//   loop runs by turns of the ring: the steps up to the first sample
//   written at position 0 (the head), then whole turns of 8 samples, then
//   the tail; within a turn every ring and tap position is a compile-time
//   constant.  The 8-tap sum runs over ring positions 0..7, the plain
//   version's order, so it needs no rotation of the ring;
// * the interpolation bank (129 x 8 float32, 4,128 B) in shared memory,
//   read as two 16-byte rows a step: channels read different rows, which
//   constant memory would serialise;
// * each turn's 16 input samples loaded at the start of the turn before,
//   so their latency is off the chain;
// * produce's branches as selects; the block's ring index read from device
//   memory (the wrapper computes the next one on the card too), so nothing
//   in the step reads the host.
// The entry point returns cudaGetLastError() after the launch, or -1 when
// the shape is outside the gate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdr {
namespace {

constexpr int kPskRows = 129;  // interpolation rows (NSTEPS + 1)
constexpr int kPskTaps = 8;    // taps a row, the ring's depth
constexpr int kSuper = 64;     // phase samples a symbol

// The carry's (C,) float leaves, in this order, then its int leaves.
enum { kP, kF, kMu, kOmega, kP0r, kP0i, kP1r, kP1i, kP2r, kP2i, kC0, kC1,
       kC2, kHsum, kHprev, kFloatLeaves };
enum { kHidx, kLast, kIntLeaves };

struct PskParams {
  const float* xr;  // (C, T) planes
  const float* xi;
  const float* bank;    // (129, 8)
  const int* dl_idx;    // the ring index entering the block (a scalar)
  const float* f_in[kFloatLeaves];
  const int* i_in[kIntLeaves];
  const float* dlr_in;  // (C, 8) the ring
  const float* dli_in;
  float* f_out[kFloatLeaves];
  int* i_out[kIntLeaves];
  float* dlr_out;
  float* dli_out;
  uint8_t* bits;   // (C, T)
  uint8_t* emits;  // (C, T) bool
  float alpha, beta, fmin, fmax, omin, omax, gmu, gom, two_pi;
  long long C, T;
};

struct PskState {
  float P, F, mu, om, p0r, p0i, p1r, p1i, p2r, p2i, c0, c1, c2, hsum, hprev;
  int hidx, last;
  float dlr[kPskTaps], dli[kPskTaps];
};

__device__ __forceinline__ float wrap(float p, float two_pi) {
  p = p > two_pi ? __fsub_rn(p, two_pi) : p;
  return p < -two_pi ? __fadd_rn(p, two_pi) : p;
}

template <int K>
__device__ __forceinline__ float pick(const float4& a, const float4& b) {
  static_assert(K >= 0 && K < 8, "a tap column");
  const float4& v = K < 4 ? a : b;
  return (K & 3) == 0 ? v.x : (K & 3) == 1 ? v.y : (K & 3) == 2 ? v.z : v.w;
}

// Ring position k's tap when the ring index after the write is W + 1: the
// row's column (k - W - 1) mod 8 (the taps rolled by the index).
template <int W, int K>
__device__ __forceinline__ float tap(const float4& a, const float4& b) {
  return pick<(K + 7 - W) & 7>(a, b);
}

// One sample written at ring position W.
template <int W>
__device__ __forceinline__ void psk_step(PskState& s, const PskParams& p,
                                         const float* bank, float xr,
                                         float xi, uint8_t* bit,
                                         uint8_t* emit) {
  const float mu = __fsub_rn(s.mu, 1.0f);
  const float Pn = wrap(__fadd_rn(s.P, s.F), p.two_pi);
  double sd, cd;
  sincos(static_cast<double>(Pn), &sd, &cd);
  const float fr = __double2float_rn(cd), fi = __double2float_rn(sd);
  s.dlr[W] = __fsub_rn(__fmul_rn(fr, xr), __fmul_rn(fi, xi));
  s.dli[W] = __fadd_rn(__fmul_rn(fr, xi), __fmul_rn(fi, xr));
  const bool produce = mu <= 1.0f;
  const float rf = fminf(fmaxf(rintf(__fmul_rn(mu, 128.0f)), 0.0f), 128.0f);
  const float4* row = reinterpret_cast<const float4*>(bank) +
                      2 * static_cast<int>(rf);
  const float4 ta = row[0], tb = row[1];
  float yr = __fmul_rn(s.dlr[0], tap<W, 0>(ta, tb));
  float yi = __fmul_rn(s.dli[0], tap<W, 0>(ta, tb));
#define SDR_PSK_TAP(k)                                            \
  yr = __fadd_rn(yr, __fmul_rn(s.dlr[k], tap<W, k>(ta, tb)));     \
  yi = __fadd_rn(yi, __fmul_rn(s.dli[k], tap<W, k>(ta, tb)));
  SDR_PSK_TAP(1) SDR_PSK_TAP(2) SDR_PSK_TAP(3) SDR_PSK_TAP(4)
  SDR_PSK_TAP(5) SDR_PSK_TAP(6) SDR_PSK_TAP(7)
#undef SDR_PSK_TAP
  // timing error: (c0 - c[-2]) p[-1] against (y - p[-2]) c[-1]
  const float c0 = yr > 0.0f ? -1.0f : 1.0f;
  const float err = fminf(fmaxf(
      __fsub_rn(__fmul_rn(__fsub_rn(yr, s.p1r), s.c0),
                __fmul_rn(__fsub_rn(c0, s.c1), s.p0r)), -1.0f), 1.0f);
  const float om = fminf(fmaxf(__fadd_rn(s.om, __fmul_rn(p.gom, err)),
                               p.omin), p.omax);
  const float mu_new = __fadd_rn(__fadd_rn(mu, om), __fmul_rn(p.gmu, err));
  // carrier PLL
  const float nrm2 = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi));
  const bool zero_n = nrm2 == 0.0f;
  const float phi = zero_n ? 0.0f
                           : __fdiv_rn(__fmul_rn(-yr, yi),
                                       zero_n ? 1.0f : nrm2);
  const float Fn = fminf(fmaxf(__fadd_rn(s.F, __fmul_rn(p.beta, phi)),
                               p.fmin), p.fmax);
  const float P2 = wrap(__fadd_rn(__fadd_rn(Pn, Fn), __fmul_rn(p.alpha, phi)),
                        p.two_pi);
  // phase history / bit decision
  const float hsum = __fadd_rn(s.hsum, yr);
  const bool trans = ((s.hprev >= 0.0f) & (yr <= 0.0f)) |
                     ((s.hprev <= 0.0f) & (yr >= 0.0f));
  const bool early = (s.hidx > 1) & trans;
  const bool drop = early & (s.hidx < kSuper / 2);
  const bool cut = (early & !drop) | (s.hidx == kSuper - 1);
  const int cconst = hsum > 0.0f ? 1 : -1;
  *bit = static_cast<uint8_t>(s.last == cconst);
  const bool em = cut & produce;
  *emit = static_cast<uint8_t>(em);
  s.last = em ? cconst : s.last;
  const bool reset = (drop | cut) & produce;
  s.hidx = produce ? (reset ? 0 : s.hidx + 1) : s.hidx;
  s.hsum = produce ? (reset ? 0.0f : hsum) : s.hsum;
  s.hprev = produce ? yr : s.hprev;
  // where a sample is made: p2 <- p1 <- p0 <- y, c2 <- c1 <- c0
  s.p2r = produce ? s.p1r : s.p2r;
  s.p2i = produce ? s.p1i : s.p2i;
  s.p1r = produce ? s.p0r : s.p1r;
  s.p1i = produce ? s.p0i : s.p1i;
  s.p0r = produce ? yr : s.p0r;
  s.p0i = produce ? yi : s.p0i;
  s.c2 = produce ? s.c1 : s.c2;
  s.c1 = produce ? s.c0 : s.c1;
  s.c0 = produce ? c0 : s.c0;
  s.P = produce ? P2 : Pn;
  s.F = produce ? Fn : s.F;
  s.mu = produce ? mu_new : mu;
  s.om = produce ? om : s.om;
}

// The steps at ring positions lo <= W < hi of the turn whose position 0 is
// sample n0 of the row (n0 - W < 0 never runs): xr/xi hold the turn's
// samples by position.
template <int W>
__device__ __forceinline__ void turn(PskState& s, const PskParams& p,
                                     const float* bank, const float* xr,
                                     const float* xi, uint8_t* bits,
                                     uint8_t* emits, long long n0, int lo,
                                     int hi) {
  if constexpr (W < kPskTaps) {
    if (W >= lo && W < hi) {
      psk_step<W>(s, p, bank, xr[W], xi[W], bits + (n0 + W),
                  emits + (n0 + W));
    }
    turn<W + 1>(s, p, bank, xr, xi, bits, emits, n0, lo, hi);
  }
}

// The turn's samples at positions lo..hi-1 (others clamped into the row).
__device__ __forceinline__ void load_turn(const float* row_r,
                                          const float* row_i, long long T,
                                          long long n0, float* xr,
                                          float* xi) {
#pragma unroll
  for (int w = 0; w < kPskTaps; ++w) {
    long long n = n0 + w;
    n = n < 0 ? 0 : (n >= T ? T - 1 : n);
    xr[w] = __ldg(row_r + n);
    xi[w] = __ldg(row_i + n);
  }
}

__global__ void __launch_bounds__(32) psk31_scan(const PskParams p) {
  __shared__ __align__(16) float bank[kPskRows * kPskTaps];
  for (int i = threadIdx.x; i < kPskRows * kPskTaps; i += blockDim.x) {
    bank[i] = p.bank[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long c = blockIdx.x;
  const long long T = p.T;
  const float* row_r = p.xr + c * T;
  const float* row_i = p.xi + c * T;
  uint8_t* bits = p.bits + c * T;
  uint8_t* emits = p.emits + c * T;
  PskState s;
  s.P = p.f_in[kP][c];
  s.F = p.f_in[kF][c];
  s.mu = p.f_in[kMu][c];
  s.om = p.f_in[kOmega][c];
  s.p0r = p.f_in[kP0r][c];
  s.p0i = p.f_in[kP0i][c];
  s.p1r = p.f_in[kP1r][c];
  s.p1i = p.f_in[kP1i][c];
  s.p2r = p.f_in[kP2r][c];
  s.p2i = p.f_in[kP2i][c];
  s.c0 = p.f_in[kC0][c];
  s.c1 = p.f_in[kC1][c];
  s.c2 = p.f_in[kC2][c];
  s.hsum = p.f_in[kHsum][c];
  s.hprev = p.f_in[kHprev][c];
  s.hidx = p.i_in[kHidx][c];
  s.last = p.i_in[kLast][c];
#pragma unroll
  for (int k = 0; k < kPskTaps; ++k) {
    s.dlr[k] = p.dlr_in[c * kPskTaps + k];
    s.dli[k] = p.dli_in[c * kPskTaps + k];
  }
  // The head: positions d0..7 of the first turn (sample 0 at position d0).
  const int d0 = *p.dl_idx & (kPskTaps - 1);
  float ar[kPskTaps], ai[kPskTaps];
  long long n0 = 0;
  if (d0 != 0) {
    n0 = kPskTaps - d0;  // the first sample written at position 0
    load_turn(row_r, row_i, T, -d0, ar, ai);
    turn<0>(s, p, bank, ar, ai, bits, emits, -d0, d0,
            static_cast<int>(d0 + (T < n0 ? T : n0)));
  }
  // Whole turns, the next turn's samples loaded before this one runs.
  load_turn(row_r, row_i, T, n0, ar, ai);
  for (; n0 + kPskTaps <= T; n0 += kPskTaps) {
    float br[kPskTaps], bi[kPskTaps];
    load_turn(row_r, row_i, T, n0 + kPskTaps, br, bi);
    turn<0>(s, p, bank, ar, ai, bits, emits, n0, 0, kPskTaps);
#pragma unroll
    for (int w = 0; w < kPskTaps; ++w) {
      ar[w] = br[w];
      ai[w] = bi[w];
    }
  }
  // The tail: positions 0..T-n0-1 of the last turn.
  if (n0 < T) {
    turn<0>(s, p, bank, ar, ai, bits, emits, n0, 0,
            static_cast<int>(T - n0));
  }
  p.f_out[kP][c] = s.P;
  p.f_out[kF][c] = s.F;
  p.f_out[kMu][c] = s.mu;
  p.f_out[kOmega][c] = s.om;
  p.f_out[kP0r][c] = s.p0r;
  p.f_out[kP0i][c] = s.p0i;
  p.f_out[kP1r][c] = s.p1r;
  p.f_out[kP1i][c] = s.p1i;
  p.f_out[kP2r][c] = s.p2r;
  p.f_out[kP2i][c] = s.p2i;
  p.f_out[kC0][c] = s.c0;
  p.f_out[kC1][c] = s.c1;
  p.f_out[kC2][c] = s.c2;
  p.f_out[kHsum][c] = s.hsum;
  p.f_out[kHprev][c] = s.hprev;
  p.i_out[kHidx][c] = s.hidx;
  p.i_out[kLast][c] = s.last;
#pragma unroll
  for (int k = 0; k < kPskTaps; ++k) {
    p.dlr_out[c * kPskTaps + k] = s.dlr[k];
    p.dli_out[c * kPskTaps + k] = s.dli[k];
  }
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// BPSK31 over a block of T samples for C channels.  All pointers are
// device pointers but state_in and state_out, host arrays of 19 device
// pointers each: the carry's float32 (C,) leaves P, F, mu, omega, p0.re,
// p0.im, p1.re, p1.im, p2.re, p2.im, c0, c1, c2, hist_sum, hist_prev, its
// int32 (C,) leaves hist_idx, last_const, and the ring's (C, 8) planes
// dl.re, dl.im.  xr, xi: (C, T) float32; bank: (129, 8) float32 (16-byte
// aligned); dl_idx: the int32 ring index entering the block; bits, emits:
// (C, T) bytes.  Returns 0, -1 when the shape is outside the gate, else a
// cudaError_t.
int sdr_psk31(const float* xr, const float* xi, const float* bank,
              const int* dl_idx, void* const* state_in,
              void* const* state_out, uint8_t* bits, uint8_t* emits,
              float alpha, float beta, float df, float omin, float omax,
              float gmu, float gom, float two_pi, long long C, long long T,
              void* stream) {
  if (C < 1 || C > 0x7fffffffLL || T < 1 || !xr || !xi || !bank || !dl_idx || !state_in ||
      !state_out || !bits || !emits ||
      (reinterpret_cast<uintptr_t>(bank) & 15) != 0) {
    return -1;
  }
  PskParams p{};
  p.xr = xr;
  p.xi = xi;
  p.bank = bank;
  p.dl_idx = dl_idx;
  for (int k = 0; k < kFloatLeaves; ++k) {
    p.f_in[k] = static_cast<const float*>(state_in[k]);
    p.f_out[k] = static_cast<float*>(state_out[k]);
  }
  for (int k = 0; k < kIntLeaves; ++k) {
    p.i_in[k] = static_cast<const int*>(state_in[kFloatLeaves + k]);
    p.i_out[k] = static_cast<int*>(state_out[kFloatLeaves + k]);
  }
  p.dlr_in = static_cast<const float*>(state_in[kFloatLeaves + kIntLeaves]);
  p.dli_in =
      static_cast<const float*>(state_in[kFloatLeaves + kIntLeaves + 1]);
  p.dlr_out = static_cast<float*>(state_out[kFloatLeaves + kIntLeaves]);
  p.dli_out = static_cast<float*>(state_out[kFloatLeaves + kIntLeaves + 1]);
  for (int k = 0; k < kFloatLeaves + kIntLeaves + 2; ++k) {
    if (!state_in[k] || !state_out[k]) return -1;
  }
  p.bits = bits;
  p.emits = emits;
  p.alpha = alpha;
  p.beta = beta;
  p.fmin = -df;
  p.fmax = df;
  p.omin = omin;
  p.omax = omax;
  p.gmu = gmu;
  p.gom = gom;
  p.two_pi = two_pi;
  p.C = C;
  p.T = T;
  psk31_scan<<<static_cast<unsigned>(C), 32, 0,
               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
