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
// sdr_fir_mxu with s0 = offset - (T-1), in the tail, and windows that end
// inside the block.
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

#include <type_traits>

namespace sdr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kFm = 0, kFir = 1, kAm = 2, kUsb = 3, kAfsk = 4 };

// kAfsk: the correlator window L and the per-warp ring of tone products of
// the warp kernel (a power of two, at least L).
constexpr int kAfskMaxL = 256;

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
// same polynomial as the plain version (ops/fir_fm.py::atan2_poly).
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float t = mn / fmaxf(mx, 1e-30f);
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

// The AGC of kAm / kUsb over out (C, n_out) in place (agc.cu): chunk ends
// from state 0, a scan of them from sd_in, then out = gain*sig/sd; sd_out
// gets the state after the last output.  ends is (C, K) scratch.
int agc_chunks(long long C, long long n_out, int sms);
int agc_launch(float* out, const float* sd_in, float* sd_out, float* ends,
               long long C, long long n_out, int K, double lam, double b,
               float gain, cudaStream_t stream);

}  // namespace sdr
