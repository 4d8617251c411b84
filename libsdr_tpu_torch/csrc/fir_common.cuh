// Shared declarations of the fused decimating-FIR kernels: the launch
// parameters, the demodulator modes, the complex sample types and the host
// launchers that fir_fm_exact.cu's entry points call.
//
// Every mode computes, per channel c and output j < n_out of a block x
// (C, B) with the (C, T-1) carry tail in front of it:
//
//   y[j] = sum_i g[i] * v[s0 + j*D + i]
//   v[n] = tail[n + T-1] (n < 0),  x[n] (0 <= n < B),  x[n - wrap] (n >= B)
//
// The exact-tiling entry (sdr_fir_exact, K1) has s0 = D - T, so window j
// ends at x[(j+1)D-1], and n_out = B/D.  The v1 contract (sdr_fir_fm_mxu,
// K6, and sdr_fir_mxu, K5, at s0 >= 0) takes B a whole number of
// 128-output frames, n_out = B/D and wrap = 128*D: the last frame's windows
// reach past the block into the frame before it, as the TPU kernel's halo
// clamps to the block's last frame.  fir_overlap_save (ops/fir.py) runs
// sdr_fir_mxu with s0 = offset - (T-1), anywhere in [1 - T, B - T], wrap
// 0 and windows that end inside the block.
//
// and then, by mode:
//   kFm   audio = gain * atan2poly(y[j] conj(y[j-1]) rot), optional
//         de-emphasis out = a*out[-1] + b*audio; exports y[n_out - 1];
//   kFir  the two planes of y;
//   kAm   sig = |y|;
//   kUsb  sig = (re + im)/2 of y[j] * (a0 * ramp[j]), a0 a unit phasor;
//   kAfsk the audio of kFm (no de-emphasis), then the dual-tone FSK
//         correlator: u_m[j] = audio[j] * mark[(n0 + j) mod L] and u_s the
//         same with space (complex (L,) templates), s_m[j] = the sum of
//         the L products u_m ending at j (the first reach back into the
//         carried last L-1 products), and out = |s_m|^2 - |s_s|^2; exports
//         y[n_out - 1] and the last L-1 products of each tone;
// and for kAm / kUsb out = gain*sig, or with the AGC
//   sd[j] = lam*sd[j-1] + b*|sig[j]|,  out = gain*sig/sd  (agc.cu;
//   b = 1 - lam in K1, any b in K6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sdr {

// A shared-memory address as the PTX of cp.async.bulk and mbarrier takes it,
// and a wait on an mbarrier's phase of the given parity.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kFm = 0, kFir = 1, kAm = 2, kUsb = 3, kAfsk = 4 };

// kAfsk: the correlator window L and the per-warp ring of tone products of
// the warp kernel (a power of two, at least L).
constexpr int kAfskMaxL = 256;

// Knockouts of kAfsk's epilogue in the staged and tensor-core kernels, for
// measurement only (tools/fir_times.py --knockouts builds with them; the
// outputs are then wrong): SDR_AFSK_KO_SUM writes u_m's real part in place
// of the window sums, SDR_AFSK_KO_TONE the audio in place of the tone
// products and their sums, SDR_AFSK_KO_DISC takes Re y for the
// discriminator's audio.
#ifdef SDR_AFSK_KO_SUM
constexpr bool kAfskKoSum = true;
#else
constexpr bool kAfskKoSum = false;
#endif
#ifdef SDR_AFSK_KO_TONE
constexpr bool kAfskKoTone = true;
#else
constexpr bool kAfskKoTone = false;
#endif
#ifdef SDR_AFSK_KO_DISC
constexpr bool kAfskKoDisc = true;
#else
constexpr bool kAfskKoDisc = false;
#endif

// The largest stride that takes the staged kernel (fir_fm_exact.cu); larger
// ones take the warp kernel (fir_warp.cu).  Set from both kernels timed in
// every mode at D = 5..80 on an H100 (libsdr_tpu_torch/tools/fir_paths.py,
// PERF.md): the warp kernel runs each output's epilogue on all 32 lanes, so
// the modes with the heavier epilogues (the discriminator, the NCO
// rotation) keep the staged kernel to a larger stride.  kAfsk runs kFm's
// epilogue and more, so it takes kFm's cut.  The comparison
// builds set SDR_STAGED_MAX_D for every mode (0: all strides on the warp
// kernel; a large value: all on the staged one).
inline int staged_max_d(int mode) {
#ifdef SDR_STAGED_MAX_D
  (void)mode;
  return SDR_STAGED_MAX_D;
#else
  return mode == kFm || mode == kUsb || mode == kAfsk ? 40 : 16;
#endif
}

// The strides lo..hi as a set: bit D for stride D (D < 64).
constexpr unsigned long long stride_set(int lo, int hi) {
  return (hi >= 63 ? ~0ULL : (1ULL << (hi + 1)) - 1) & ~((1ULL << lo) - 1);
}

// The multiples of 4 from lo to hi (64 <= lo, hi < 128) as a set: bit D -
// 64 for stride D.
constexpr unsigned long long stride_set4_hi(int lo, int hi) {
  return lo > hi ? 0ULL : (1ULL << (lo - 64)) | stride_set4_hi(lo + 4, hi);
}

// The cuts of the tensor-core kernel (fir_tc.cu): the strides that take it,
// by mode and plane dtype, each set from the three kernels timed in that
// mode on an H100 (libsdr_tpu_torch/tools/fir_paths.py, PERF.md) against the
// kernel the stride takes otherwise (the staged kernel up to staged_max_d,
// the warp kernel above):
// * kFm (K1a; K6's cut for both its modes), D = 2..40, 64 ch x
//   2^24, T = 32 + D - 1: with bfloat16 planes the tensor-core kernel is
//   the fastest at every stride from 4 to 40; with float32 planes, whose
//   three passes and hi/lo conversion cost it more, it ties or wins from 4
//   to 16 and loses above; below 4 the staged kernel's outputs are cheaper
//   than its per-output epilogue and MMAs.
// * kAfsk (K1e), D = 2..40, the AX.25 bank's 64 ch x 2^21 and L =
//   40: with bfloat16 planes the fastest at every stride; with float32
//   planes it wins from 2 to 16 and loses at 24 and 32 (frames of one
//   output).
// * kFir (K1b), 64 ch x 2^24, T = 64 + D - 1, and kAm with the AGC (K1c),
//   the AM bank's 64 ch x 16,777,200, T = 32 + D - 1, at every stride D =
//   2..40, each kernel timed twice: a stride is in the cut where both of
//   the tensor-core kernel's times are below both of the other's.  With
//   bfloat16 planes that is every stride in both modes (at the DDC bank's
//   D = 4, 3.31 ms against the staged kernel's 7.06; at the AM bank's D =
//   40, 2.11 against the warp kernel's 5.43).  With float32 planes its
//   time follows its plan's tile (ops/fir_tc.py::tc_plan) more than the
//   stride: it loses where a tile holds few outputs for the three passes
//   and the conversion (64-128 at D = 24, 32 and 34-39) and at D = 3, 6, 8,
//   9 and 12, where the staged kernel is cheap (kFir at D = 8: 4.25 ms
//   against 4.10), and in mode kAm, whose staged epilogue is cheaper, at
//   every stride up to 12; it wins at every other stride (the DDC bank's
//   D = 4: 4.56 against 5.26 ms; the AM bank's D = 40: 4.59 against 4.92).
constexpr unsigned long long kTcFirF32 =
    stride_set(2, 40) & ~(stride_set(3, 3) | stride_set(6, 6) |
                          stride_set(8, 9) | stride_set(12, 12) |
                          stride_set(24, 24) | stride_set(32, 32) |
                          stride_set(34, 39));
constexpr unsigned long long kTcAmF32 =
    stride_set(13, 40) & ~(stride_set(32, 32) | stride_set(34, 39));
// * kUsb with the AGC (K1d), the USB bank's 64 ch x 16,777,200, T = 64 +
//   D - 1, at every stride D = 2..63, the multiples of 4 from 64 to 128
//   and 160, 180 and 200 (and 90), each kernel timed twice in each of two
//   runs, the same rule as kFir's and kAm's over every timing taken.  With
//   bfloat16 planes the route wins at every stride 2-61 and at the
//   multiples of 4 from 64 to 120 but 84 and 108 (frames of one or two
//   outputs; the USB bank's D = 80: 2.79 ms against the warp kernel's
//   3.66), loses in one run of two at 62, 84 and 108 (within 6%), and
//   loses at 63 (frames of 8), 90 (frames of 4) and from 124 up, where the
//   warp kernel's time falls with the outputs (D = 200: 2.98 against
//   2.44).  With float32 planes it wins only at D = 4, 13-16, 23, 25-31
//   and 33, loses in one run of two at 20 and 40 (within 6%), and loses
//   from 41 up (D = 80: 6.21 against 3.45; 32 frames of one output a tile,
//   ~4 us each).  Below 64 a stride set, from 64 a set of its own
//   (stride_set4_hi; with bfloat16 planes only).
constexpr unsigned long long kTcUsbBf16 = stride_set(2, 61);
constexpr unsigned long long kTcUsbBf16Hi = stride_set4_hi(64, 80) |
                                            stride_set4_hi(88, 104) |
                                            stride_set4_hi(112, 120);
constexpr unsigned long long kTcUsbF32 =
    stride_set(4, 4) | stride_set(13, 16) | stride_set(23, 23) |
    stride_set(25, 31) | stride_set(33, 33);

// Whether stride D takes the tensor-core kernel in the cut of `mode` with
// bf16 (or float32) planes: a stride set below 64, and one of 64 to 127
// (kUsb's alone has strides there).  The comparison builds
// set SDR_TC_MAX_D for every mode and both dtypes (0: no stride on it; a
// large value: every stride whose plan fits).
inline bool tc_stride(int mode, int bf16, int D) {
#ifdef SDR_TC_MAX_D
  (void)mode;
  (void)bf16;
  return D <= SDR_TC_MAX_D;
#else
  unsigned long long set;
  switch (mode) {
    case kFir:
      set = bf16 ? stride_set(2, 40) : kTcFirF32;
      break;
    case kAm:
      set = bf16 ? stride_set(2, 40) : kTcAmF32;
      break;
    case kUsb:
      if (D >= 64) return bf16 && D < 128 && (kTcUsbBf16Hi >> (D - 64) & 1);
      set = bf16 ? kTcUsbBf16 : kTcUsbF32;
      break;
    case kAfsk:
      set = stride_set(2, bf16 ? 40 : 16);
      break;
    default:  // kFm
      set = stride_set(4, bf16 ? 40 : 16);
  }
  return D >= 1 && D < 64 && (set >> D & 1);
#endif
}

// Which kernel runs a launch: the staged kernel, the warp kernel, or the
// tensor-core kernel.
enum Route { kRouteStaged = 0, kRouteWarp = 1, kRouteTc = 2 };

struct Params {
  const void* xr;
  const void* xi;
  const void* tail_r;
  const void* tail_i;
  const float* taps_r;
  const float* taps_i;
  const float* prev_r;  // kFm: y[-1]
  const float* prev_i;
  const float* dstate;  // kFm: de-emphasis state
  const float* ramp_r;  // kUsb: (n_out,) exp(-i theta j)
  const float* ramp_i;
  const float* ph_r;    // kUsb: the carried unit phasor a0 (one value)
  const float* ph_i;
  float* out;    // (C, n_out) audio, sig or the real plane of y (kFir)
  float* out_i;  // kFir: the imaginary plane of y
  float* ylast_r;
  float* ylast_i;
  float* ends;  // kFm: (C, K) de-emphasis state at each chunk's end
  // kAfsk: the (L,) templates [mark re, mark im, space re, space im], the
  // template phase n0 (one int on the device), the carried (C, L-1) tone
  // products [u_m re, u_m im, u_s re, u_s im] and their (C, L-1) exports.
  const float* tpl[4];
  const int* n0;
  const float* u_in[4];
  float* u_out[4];
  int L;
  long long B;
  long long s0;     // window start of output 0 (negative: in the tail)
  long long n_out;  // outputs per channel
  long long wrap;   // an index n >= B reads x[n - wrap]
  long long chunk;  // outputs per chunk (the last chunk may be shorter)
  int T;
  int D;
  int K;  // chunks per channel
  int Q;  // polyphase row length in shared memory (staged kernel)
  float rot_r, rot_i, gain, a, b;
  int deemph;
};

// A complex sample as stored in shared memory: float2 for float32 planes,
// a bf16 pair for bfloat16 planes (widened when read).
template <typename Tin> struct Cplx;
template <> struct Cplx<float> {
  using type = float2;
  static __device__ __forceinline__ float2 make(float r, float i) {
    return make_float2(r, i);
  }
  static __device__ __forceinline__ float2 widen(float2 v) { return v; }
};
template <> struct Cplx<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 make(__nv_bfloat16 r,
                                                        __nv_bfloat16 i) {
    return __halves2bfloat162(r, i);
  }
  static __device__ __forceinline__ float2 widen(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

// Sample v[n] of one channel's plane (see the top of this file).
template <typename Tin>
__device__ __forceinline__ Tin sample_at(const Tin* x, const Tin* tail,
                                         long long n, const Params& p) {
  if (n < 0) return tail[n + p.T - 1];
  return x[n < p.B ? n : n - p.wrap];
}

// The same for a run of loads [lo, lo + len) that the caller has sorted:
// a run inside the block (Inside, the common case) reads x[n] with no
// compare; only a run that reaches into the tail or past the block (Edge)
// pays sample_at's.  Each load loop branches once on inner_run().
using Inside = std::true_type;
using Edge = std::false_type;

__device__ __forceinline__ bool inner_run(long long lo, long long len,
                                          const Params& p) {
  return lo >= 0 && lo + len <= p.B;
}

template <typename Inner, typename Tin>
__device__ __forceinline__ Tin sample(const Tin* x, const Tin* tail,
                                      long long n, const Params& p) {
  if constexpr (Inner::value) {
    return x[n];
  } else {
    return sample_at(x, tail, n, p);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Full-quadrant atan2 from an odd minimax polynomial, |err| < 2e-5 rad; the
// same polynomial as the plain version (ops/fir_fm.py::atan2_poly).  FAST:
// the ratio from the fast division (2 ulp, ~1e-7 rad; fir_tc.cu).
template <bool FAST = false>
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float t = FAST ? __fdividef(mn, fmaxf(mx, 1e-30f))
                       : mn / fmaxf(mx, 1e-30f);
  const float s = t * t;
  float p = -0.0117212f;
  p = p * s + 0.05265332f;
  p = p * s + -0.11643287f;
  p = p * s + 0.19354346f;
  p = p * s + -0.33262347f;
  p = p * s + 0.99997726f;
  float r = t * p;
  if (ay > ax) r = 1.57079632679489662f - r;
  if (x < 0.f) r = 3.14159265358979324f - r;
  return y < 0.f ? -r : r;
}

// kFm's audio of one output y from y[j-1] = (pr, pi):
// gain * atan2poly(y conj(y[j-1]) rot).
template <bool FAST = false>
__device__ __forceinline__ float fm_audio(float yr, float yi, float pr,
                                          float pi, const Params& p) {
  const float zr = yr * pr + yi * pi;
  const float zi = yi * pr - yr * pi;
  const float zr2 = zr * p.rot_r - zi * p.rot_i;
  const float zi2 = zr * p.rot_i + zi * p.rot_r;
  return p.gain * atan2_poly<FAST>(zi2, zr2);
}

// s + lo += a*b with neither the product nor the sum rounded away: the
// product's error by FMA (TwoProduct), the sum's by Knuth's TwoSum, both
// gathered in lo, so s + lo carries the dot product to about twice float32's
// precision.  The _rn intrinsics keep nvcc from contracting the steps.
__device__ __forceinline__ void acc_exact(float& s, float& lo, float a,
                                          float b) {
  const float p = __fmul_rn(a, b);
  const float pe = __fmaf_rn(a, b, -p);
  const float t = __fadd_rn(s, p);
  const float bp = __fsub_rn(t, s);
  const float se = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)),
                             __fsub_rn(p, bp));
  s = t;
  lo = __fadd_rn(lo, __fadd_rn(se, pe));
}

// x*g as the FIR computes it: in float32 (P = 0, the staged and warp
// kernels), or in the tensor-core kernel's P bf16 passes (x_hi*g_hi,
// + x_hi*g_lo, + x_lo*g_hi; fir_tc.cu), the products its MMAs sum.
template <int P>
__device__ __forceinline__ float split_mul(float x, float g) {
  if constexpr (P == 0) {
    return x * g;
  } else {
    const float xh = __bfloat162float(__float2bfloat16_rn(x));
    const float gh = __bfloat162float(__float2bfloat16_rn(g));
    float r = xh * gh;
    if constexpr (P >= 2) {
      r += xh * __bfloat162float(__float2bfloat16_rn(g - gh));
    }
    if constexpr (P == 3) {
      r += __bfloat162float(__float2bfloat16_rn(x - xh)) * gh;
    }
    return r;
  }
}

// y at window start w0 (any index of sample_at's), summed by one warp in
// split_mul<P>'s arithmetic: a later chunk's y[j_begin - 1], which lies in
// the chunk before it.  (The tensor-core kernel's one pass in float32
// would put the chunk's first output ~1e-4 rad off its own arithmetic.)
template <int P, typename Tin>
__device__ float2 warp_y_at(const Tin* xr, const Tin* xi, const Tin* tr,
                            const Tin* ti, long long w0, const Params& p,
                            int lane) {
  float ar = 0.f, ai = 0.f;
  for (int i = lane; i < p.T; i += 32) {
    const long long n = w0 + i;
    const float vr = to_f32(sample_at(xr, tr, n, p));
    const float vi = to_f32(sample_at(xi, ti, n, p));
    const float gr = p.taps_r[i], gi = p.taps_i[i];
    ar += split_mul<P>(vr, gr) - split_mul<P>(vi, gi);
    ai += split_mul<P>(vi, gr) + split_mul<P>(vr, gi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    ar += __shfl_xor_sync(0xffffffffu, ar, off);
    ai += __shfl_xor_sync(0xffffffffu, ai, off);
  }
  return make_float2(ar, ai);
}

// The de-emphasis out[j] = a*out[j-1] + b*audio[j] over a segment of
// kThreads*R consecutive outputs, R to a thread in order, as a chunked
// scan: a per-thread pass from state 0, a scan of the thread ends over the
// warp with shuffles, a pass over the warp totals (from the state before
// the segment, *state, which it leaves as the state after the segment's
// last slot): one thread's loop, or with WARP_PREFIX the same scan in warp
// 0 (fir_tc.cu; the staged kernel keeps the loop, measured faster there),
// and the fix-up out += a^(r+1) * state_in.  Every thread of the block
// calls it (two barriers); loc holds the audio and gets the output.
template <int R>
struct DeemphScan {
  float a, b, aR, a_lane, a32;

  __device__ DeemphScan(float a_, float b_, int lane) : a(a_), b(b_) {
    aR = 1.f;
    for (int r = 0; r < R; ++r) aR *= a;
    a_lane = 1.f;
    for (int q = 0; q < lane; ++q) a_lane *= aR;
    a32 = 1.f;
    for (int q = 0; q < 32; ++q) a32 *= aR;
  }

  template <bool WARP_PREFIX = false>
  __device__ __forceinline__ void run(float (&loc)[R], float* s_wtot,
                                      float* s_wpre, float* state, int lane,
                                      int warp) const {
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l = a * l + b * loc[r];
      loc[r] = l;
    }
    // Inclusive scan of S_t = sum_{u<=t} A^(t-u) l_u over the warp.
    float S = l, m = aR;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, S, off);
      if (lane >= off) S = fmaf(m, v, S);
      m *= m;
    }
    float Sx = __shfl_up_sync(0xffffffffu, S, 1);
    if (lane == 0) Sx = 0.f;
    if (lane == 31) s_wtot[warp] = S;
    __syncthreads();
    if (WARP_PREFIX && warp == 0) {
      // the warps' entry states: the same scan over the kWarps totals
      // (powers A32 = a^(32R)), from the state before the segment
      const float t = lane < kWarps ? s_wtot[lane] : 0.f;
      float W = t, mw = a32, aw = 1.f;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, W, off);
        if (lane >= off) W = fmaf(mw, v, W);
        if (lane & off) aw *= mw;  // A32^lane
        mw *= mw;
      }
      const float P0 = *state;
      const float Wx = __shfl_up_sync(0xffffffffu, W, 1);
      if (lane < kWarps) s_wpre[lane] = fmaf(aw, P0, lane ? Wx : 0.f);
      if (lane == kWarps - 1) *state = fmaf(aw * a32, P0, W);
    } else if (!WARP_PREFIX && warp == 0 && lane == 0) {
      float P = *state;
      for (int w = 0; w < kWarps; ++w) {
        s_wpre[w] = P;
        P = fmaf(a32, P, s_wtot[w]);
      }
      *state = P;
    }
    __syncthreads();
    const float s_in = fmaf(a_lane, s_wpre[warp], Sx);
    float ap = a;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      loc[r] = fmaf(ap, s_in, loc[r]);
      ap *= a;
    }
  }
};

// The USB mode's sample: (re + im)/2 of y * (a0 * ramp[j]).
__device__ __forceinline__ float usb_sig(float yr, float yi, float ar,
                                         float ai, float rr, float ri) {
  const float cr = ar * rr - ai * ri;
  const float ci = ar * ri + ai * rr;
  return 0.5f * ((yr * cr - yi * ci) + (yr * ci + yi * cr));
}

// The chunk count near k that leaves no chunk empty: chunks of
// ceil(n_out/k) outputs cover n_out in ceil(n_out / ceil(n_out/k)) chunks.
inline int fit_chunks(long long n_out, long long k) {
  k = k < 1 ? 1 : k;
  const long long len = (n_out + k - 1) / k;
  return (int)((n_out + len - 1) / len);
}

// The warp kernel for strides above staged_max_d (fir_warp.cu).  Chunks per
// channel for C channels (or -1 when its taps and staging buffers do not
// fit in shared memory, else -2 - cudaError_t), and the launch itself.
int warp_chunks(int mode, long long C, long long n_out, int T, int D, int L,
                int bf16, int smem_max, int sms);
int warp_launch(int mode, const Params& p, long long C, int bf16,
                cudaStream_t stream, int smem_max);

// The de-emphasis across chunks after a launch with K > 1 chunks (kFm;
// fir_fm_exact.cu): every chunk but the first ran from state 0, and
// p.ends holds each chunk's last output.
int deemph_chunks_launch(const Params& p, long long C, cudaStream_t stream);

// The tensor-core kernel (fir_tc.cu) for every mode: whether
// a plan of it fits the card's shared memory at this shape (passes: 1 for
// 'fast', else 3 for float32 planes and 2 for bfloat16; L: kAfsk's window,
// 0 in the other modes), the chunks per channel for C channels (-2 -
// cudaError_t on a failed query), and the launch (L from p.L in kAfsk).
bool tc_fits(int T, int D, int L, int bf16, int fast, int smem_max,
             int smem_sm);
int tc_chunks(int mode, long long C, long long n_out, int T, int D, int L,
              int bf16, int fast, int smem_max, int smem_sm, int sms);
int tc_launch(int mode, const Params& p, long long C, int bf16, int fast,
              cudaStream_t stream, int smem_max, int smem_sm);

// The AGC of kAm / kUsb over out (C, n_out) in place (agc.cu): chunk ends
// from state 0, a scan of them from sd_in, then out = gain*sig/sd; sd_out
// gets the state after the last output.  ends is (C, K) scratch.
int agc_chunks(long long C, long long n_out, int sms);
int agc_launch(float* out, const float* sd_in, float* sd_out, float* ends,
               long long C, long long n_out, int K, double lam, double b,
               float gain, cudaStream_t stream);

}  // namespace sdr
