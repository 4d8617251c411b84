// Polyphase filterbank channelizer (K4), with an optional FM discriminator
// bank in its epilogue.
//
// Replaces the TPU kernel libsdr_tpu/ops/pallas_pfb.py::_kernel_pfb (via
// _pfb_call and pfb_mxu).  For each stream c of C, frame t of the block is
// x[c, t, :] (M samples), and X[t] = frame t for t >= 0, hist[c, P + t] for
// -P <= t < 0 (the carried last P raw frames).  Per frame:
//
//   u[t, q]   = sum_{k=0..P} taps3[k, q] * X[t - k, q]      (the PFB MAC)
//   Y[t, ch]  = sum_q u[t, q] * exp(-2 pi i q ch / M)        (unscaled DFT)
//
// fold_commutator has put the reverse commutator into taps3.  Channel ch is
// written to lane L = lane_of_channel(ch) of the time-major (F, M) output:
// L = 128 (ch mod n2) + ch / n2 when M is n2 * 128 with n2 > 1, L = ch
// otherwise (the JAX kernel's layout, so the port's lane-layout output is
// the JAX package's array element for element).  The demod variant writes
// instead
//
//   audio[t, L] = gain * atan2poly(Im z, Re z),  z = Y[t] * conj(Y[t - 1])
//
// with Y[-1] = prev (per lane), and exports y_last = Y[F - 1] and
// y_first = Y[0] (per lane).  atan2poly is the FIR kernels' polynomial
// (fir_common.cuh), the JAX kernel's _atan2_poly.
//
// What bounds it on an H100: bytes.  At M = 1024, a 2^26-sample block reads
// 537 MB of float32 planes and writes 268 MB of audio (0.24 ms at 3.35
// TB/s); the work is ~36 operations a sample for the MAC, ~5 log2 M for a
// radix-2 FFT and ~50 for the discriminator, ~9 GFLOP (0.14 ms at the 67
// TFLOP/s float32 rate).
//
// Two routes, chosen by shape in sdr_pfb (sdr_pfb_route says which):
//
// The stream route, for M = N * N with N in {4, 8, 16, 32} (M = 16,
// 64, 256, 1024: every path's M) and P = 8, any C and F, both variants and
// plane dtypes.  Instantiated for compile-time N, so no index divides by a
// runtime value.
// * Tiles from F: a block owns TT consecutive frames of one stream, TT
//   chosen so that C x tiles fills the card's resident blocks
//   (cudaOccupancy..., found once a device), and walks them in groups of
//   G = 256 / N frames (one of 8 warps holds 32 / N frames in the FFT).
// * The frames through shared memory once: a ring of two chunks of G raw
//   frames a plane (the group's and the one before, which holds its
//   8-frame halo).  Thread 0 copies each group's frames with one
//   cp.async.bulk a plane, completing on the chunk's mbarrier; the next
//   group's copy goes out once the MAC has read the chunk it overwrites,
//   and flies during the FFT and the epilogue.  A tile's first group also
//   copies the 8 frames before it (hist for those before frame 0).
// * The MAC from a per-lane register window: a thread takes lanes q, q + 1
//   and 8 consecutive frames of the group, loads the 16 samples
//   X[t - 8 .. t + 7] of those lanes from the ring (8-byte loads of
//   float32, 4-byte of bfloat16 pairs), all before it widens any, and sums
//   each frame's 9 terms from registers, k = 0..P in order as the generic
//   route does (so a frame's u is bit-equal whichever tile or route
//   computes it).  u goes to a group buffer in shared memory, one padded
//   row of M + N a frame.
// * The FFT in registers, four-step, one N-lane slice of a warp a frame:
//   lane n2 holds the column u[n2 + N n1] (n1 < N) and runs an N-point
//   radix-2 FFT on it with W_32 constants as literals (float64 values
//   rounded once), multiplies by W_M^(n2 k1) from pfb_twiddles' table
//   staged in shared memory as [k1][n2], transposes through its frame's
//   own row (stride N + 1: no bank conflict either way), and runs the
//   second N-point FFT; Y[k1 + N k2] lands at row k2, column k1.  Only
//   warp syncs inside.
// * The epilogue reads Y at lane_of_channel's channel at offsets fixed at
//   compile time (coalesced stores), Y[t - 1] from the neighbouring
//   frame's row, from the previous group's last frame (two ping-pong rows)
//   or from prev, and writes y_first and y_last.  A tile after the first
//   recomputes the frame before it.
// * Blocks: at M = 1024 the ring (128 KB of float32 frames) leaves room
//   for one block an SM, so the block has 16 warps (the MAC and the
//   epilogue on all of them, two warps a frame's lanes; the FFT on 8);
//   below, two blocks of 8 warps.  Three block barriers a group (after the
//   MAC, before the epilogue where it reads other warps' rows, after it).
// * What bounds it at W1: the phases in series within a block; the copies,
//   the transposes and the stores alone take ~0.29 ms against the bytes'
//   0.24 ms, the MAC, the FFT and the epilogue ~0.07 each on top
//   (PERF.md).  Measured and dropped: the window loaded straight from
//   global memory (two blocks of 8 warps an SM; 0.468 ms at W1 against
//   0.404), and a warp-specialised variant of it.

// The generic route takes every other shape:
// * Tiles.  A block of 256 threads owns TT consecutive frames of one
//   stream and walks them in groups of G frames (G M ~ 2048 elements, so a
//   group fills the block also when M <= 32).  It reads its own P-frame
//   halo from the input, or from hist for the first tile; the MAC's P + 1
//   reads of each sample come from the L1/L2 caches after the first, 8
//   terms' loads in flight at a time (where no term reads hist).  At most
//   64 registers a thread, so 4 blocks share an SM: uncapped, the compiler
//   took over twice as many and 2 blocks an SM ran slower.
// * The DFT runs in shared memory in float32: a Stockham autosort FFT
//   (radix 4, one radix-2 stage where log2 is odd, after one direct stage
//   for an odd factor a in {3, 5, 7}) for M = a 2^k, a direct O(M) sum per
//   output for any other M.  Twiddles come from a table exp(-2 pi i j / M)
//   computed in float64 and rounded once (ops/pfb.py); the small DFTs' own
//   constants are entries of the same table.
// * Y[t - 1] at a tile's first frame: each tile after the first recomputes
//   the frame before it (one extra DFT per tile) and writes nothing for it.
//
// Both routes:
// * Any C >= 1 and F >= 1 (also F < P), any 1 <= M <= 8192, 1 <= P <= 32:
//   the JAX package fell back to XLA for a leading stream axis and F <= P;
//   there is no fallback here.
// * float32 or bfloat16 planes (widened on load); hist, taps, prev and
//   every sum in float32.
// * The entry point returns cudaGetLastError() after the launch, or -1
//   when the shape is outside the gate.
//
// Measurement builds (tools/pfb_times.py --knockouts), never the default:
// -DSDR_PFB_STREAM=0 sends every shape to the generic route;
// -DSDR_PFB_KO_MAC=1 takes u = X[t] (no taps), -DSDR_PFB_KO_FFT=1 skips
// the DFT's arithmetic (the stream route keeps its transposes),
// -DSDR_PFB_KO_EPI=1 writes Y at its own index (no lane permutation, no
// discriminator, no exports).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fir_common.cuh"

#ifndef SDR_PFB_STREAM
#define SDR_PFB_STREAM 1
#endif
#ifndef SDR_PFB_KO_MAC
#define SDR_PFB_KO_MAC 0
#endif
#ifndef SDR_PFB_KO_FFT
#define SDR_PFB_KO_FFT 0
#endif
#ifndef SDR_PFB_KO_EPI
#define SDR_PFB_KO_EPI 0
#endif

namespace sdr {
namespace {

constexpr int kPfbThreads = 256;
constexpr int kPfbMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kPfbMaxM = 8192;
constexpr int kPfbMaxP = 32;
constexpr int kGroupElems = 2048;  // G * M of a group, M below
constexpr int kTileFrames = 32;    // frames a tile holds at least
constexpr int kMaxStages = 16;

struct PfbParams {
  const void* xr;      // (C, F, M) planes, float32 or bfloat16
  const void* xi;
  const float* hr;     // (C, P, M) carried frames
  const float* hi;
  const float* taps;   // (P + 1, M)
  const float* twr;    // (M,) exp(-2 pi i j / M)
  const float* twi;
  const float* pr;     // (C, M) Y[-1] per lane (demod)
  const float* pi;
  float* out_r;        // (C, F, M): Y planes, or the audio in out_r
  float* out_i;
  float* ylr;          // (C, M) exports (demod)
  float* yli;
  float* y0r;
  float* y0i;
  long long C, F;
  int M, P;
  float gain;
  int demod;
  int G;               // frames per group
  long long TT;        // frames per tile
  long long tiles;     // tiles per stream
  int n2;              // lane permutation: M / 128, or 0 for the identity
  int n_stages;        // FFT stages, or -1 for the direct DFT
  int radix[kMaxStages];
};

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ int chan_of_lane(int lane, int n2) {
  return n2 ? n2 * (lane & 127) + (lane >> 7) : lane;
}

// One Stockham stage of radix R over G frames of M points in shared memory:
// butterfly j of a frame reads in[j + r M/R] (r < R), multiplies input r by
// W_M^(r k M/(ns R)) with k = j mod ns, runs the R-point DFT and writes
// out[(j / ns) ns R + k + r ns].  Starting at ns = 1 and multiplying ns by
// each stage's radix leaves the DFT in natural order.
template <int R>
__device__ void fft_stage(const float* inr, const float* ini, float* outr,
                          float* outi, const float* twr, const float* twi,
                          int M, int G, int ns) {
  const int nb = M / R;
  const int tws = M / (ns * R);
  for (int e = threadIdx.x; e < G * nb; e += blockDim.x) {
    const int g = e / nb;
    const int j = e - g * nb;
    const int jq = j / ns;
    const int k = j - jq * ns;
    const float* fr = inr + g * M;
    const float* fi = ini + g * M;
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float a = fr[j + r * nb], b = fi[j + r * nb];
      if (r == 0) {
        vr[r] = a;
        vi[r] = b;
      } else {
        const int w = r * k * tws;  // < M
        const float cr = __ldg(twr + w), ci = __ldg(twi + w);
        vr[r] = a * cr - b * ci;
        vi[r] = a * ci + b * cr;
      }
    }
    float yr[R], yi[R];
    if constexpr (R == 2) {
      yr[0] = vr[0] + vr[1];
      yi[0] = vi[0] + vi[1];
      yr[1] = vr[0] - vr[1];
      yi[1] = vi[0] - vi[1];
    } else if constexpr (R == 4) {
      const float s0r = vr[0] + vr[2], s0i = vi[0] + vi[2];
      const float d0r = vr[0] - vr[2], d0i = vi[0] - vi[2];
      const float s1r = vr[1] + vr[3], s1i = vi[1] + vi[3];
      const float d1r = vr[1] - vr[3], d1i = vi[1] - vi[3];
      yr[0] = s0r + s1r;
      yi[0] = s0i + s1i;
      yr[2] = s0r - s1r;
      yi[2] = s0i - s1i;
      // X1 = d0 - i d1, X3 = d0 + i d1 (forward transform, W4 = -i)
      yr[1] = d0r + d1i;
      yi[1] = d0i - d1r;
      yr[3] = d0r - d1i;
      yi[3] = d0i + d1r;
    } else {
      // odd R: the direct R-point DFT with W_R^m = tw[m M / R]
#pragma unroll
      for (int s = 0; s < R; ++s) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m = ((r * s) % R) * nb;
          const float cr = __ldg(twr + m), ci = __ldg(twi + m);
          ar += vr[r] * cr - vi[r] * ci;
          ai += vr[r] * ci + vi[r] * cr;
        }
        yr[s] = ar;
        yi[s] = ai;
      }
    }
    const int idx = jq * ns * R + k;
    float* gr = outr + g * M;
    float* gi = outi + g * M;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gr[idx + r * ns] = yr[r];
      gi[idx + r * ns] = yi[r];
    }
  }
}

// The direct DFT: Y[ch] = sum_q u[q] W_M^(q ch mod M), summed over q in
// order, for any M.
__device__ void dft_direct(const float* inr, const float* ini, float* outr,
                           float* outi, const float* twr, const float* twi,
                           int M, int G) {
  for (int e = threadIdx.x; e < G * M; e += blockDim.x) {
    const int g = e / M;
    const int ch = e - g * M;
    const float* fr = inr + g * M;
    const float* fi = ini + g * M;
    float ar = 0.f, ai = 0.f;
    int w = 0;
    for (int q = 0; q < M; ++q) {
      const float cr = __ldg(twr + w), ci = __ldg(twi + w);
      ar += fr[q] * cr - fi[q] * ci;
      ai += fr[q] * ci + fi[q] * cr;
      w += ch;
      if (w >= M) w -= M;
    }
    outr[e] = ar;
    outi[e] = ai;
  }
}

// The MAC's sum for lane q of frame t: terms k = 0..P added in order, the
// frames read from x (t - k >= 0) or from hist.
template <typename T>
__device__ __forceinline__ void mac(const T* xr, const T* xi,
                                    const float* hr, const float* hi,
                                    const float* taps, long long t, int q,
                                    int M, int P, float& ur, float& ui) {
  if (t >= P) {
    // every term from x: 8 terms' loads in flight before their sums
    for (int k0 = 0; k0 <= P; k0 += 8) {
      float vr[8], vi[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k0 + i <= P) {
          const long long off = (t - k0 - i) * M + q;
          vr[i] = ld(xr, off);
          vi[i] = ld(xi, off);
          w[i] = taps[(k0 + i) * M + q];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k0 + i <= P) {
          ur += w[i] * vr[i];
          ui += w[i] * vi[i];
        }
      }
    }
    return;
  }
  for (int k = 0; k <= P; ++k) {
    const long long j = t - k;  // >= -P
    float xre, xim;
    if (j >= 0) {
      xre = ld(xr, j * M + q);
      xim = ld(xi, j * M + q);
    } else {
      xre = hr[(P + j) * M + q];
      xim = hi[(P + j) * M + q];
    }
    const float w = taps[k * M + q];
    ur += w * xre;
    ui += w * xim;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPfbThreads, kPfbMinBlocks)
    pfb_kernel(PfbParams p) {
  extern __shared__ __align__(16) float smem[];
  const int M = p.M, G = p.G, P = p.P;
  const int GM = G * M;
  float* ar = smem;
  float* ai = ar + GM;
  float* br = ai + GM;
  float* bi = br + GM;
  float* prr = bi + GM;  // Y[t - 1] per lane before the group (demod)
  float* pri = prr + M;

  const long long c = blockIdx.x / p.tiles;
  const long long t0 = (blockIdx.x % p.tiles) * p.TT;
  const long long t_end = t0 + p.TT < p.F ? t0 + p.TT : p.F;
  // the demod recomputes the frame before a later tile (written nowhere)
  const long long s = (p.demod && t0 > 0) ? t0 - 1 : t0;
  const T* xr = static_cast<const T*>(p.xr) + c * p.F * M;
  const T* xi = static_cast<const T*>(p.xi) + c * p.F * M;
  const float* hr = p.hr + c * P * M;
  const float* hi = p.hi + c * P * M;
  float* out_r = p.out_r + c * p.F * M;
  float* out_i = p.out_i ? p.out_i + c * p.F * M : nullptr;

  if (p.demod && t0 == 0) {
    for (int l = threadIdx.x; l < M; l += blockDim.x) {
      prr[l] = p.pr[c * M + l];
      pri[l] = p.pi[c * M + l];
    }
  }
  for (long long g0 = s; g0 < t_end; g0 += G) {
    // ---- the MAC of G frames into (ar, ai), frame g at [g M, (g + 1) M)
    for (int e = threadIdx.x; e < GM; e += blockDim.x) {
      const int g = e / M;
      const int q = e - g * M;
      const long long t = g0 + g;
      float ur = 0.f, ui = 0.f;
#if SDR_PFB_KO_MAC
      if (t < t_end) {
        ur = ld(xr, t * M + q);
        ui = ld(xi, t * M + q);
      }
#else
      if (t < t_end) mac(xr, xi, hr, hi, p.taps, t, q, M, P, ur, ui);
#endif
      ar[e] = ur;
      ai[e] = ui;
    }
    __syncthreads();

    // ---- the DFT of each frame; the result in (yr, yi)
    float *inr = ar, *ini = ai, *outr = br, *outi = bi;
    if (SDR_PFB_KO_FFT) {
    } else if (p.n_stages < 0) {
      dft_direct(inr, ini, outr, outi, p.twr, p.twi, M, G);
      __syncthreads();
      inr = outr;
      ini = outi;
    } else {
      int ns = 1;
      for (int st = 0; st < p.n_stages; ++st) {
        const int R = p.radix[st];
        switch (R) {
          case 2: fft_stage<2>(inr, ini, outr, outi, p.twr, p.twi, M, G, ns);
            break;
          case 3: fft_stage<3>(inr, ini, outr, outi, p.twr, p.twi, M, G, ns);
            break;
          case 4: fft_stage<4>(inr, ini, outr, outi, p.twr, p.twi, M, G, ns);
            break;
          case 5: fft_stage<5>(inr, ini, outr, outi, p.twr, p.twi, M, G, ns);
            break;
          default:
            fft_stage<7>(inr, ini, outr, outi, p.twr, p.twi, M, G, ns);
        }
        __syncthreads();
        float* tr = inr;
        float* ti = ini;
        inr = outr;
        ini = outi;
        outr = tr;
        outi = ti;
        ns *= R;
      }
    }
    const float* yr = inr;
    const float* yi = ini;

    // ---- the epilogue, lane by lane (coalesced stores)
    for (int e = threadIdx.x; e < GM; e += blockDim.x) {
      const int g = e / M;
      const int l = e - g * M;
      const long long t = g0 + g;
      if (t < t0 || t >= t_end) continue;
#if SDR_PFB_KO_EPI
      out_r[t * M + l] = yr[e];
      if (!p.demod) out_i[t * M + l] = yi[e];
      continue;
#endif
      const int ch = g * M + chan_of_lane(l, p.n2);
      const float vr = yr[ch], vi = yi[ch];
      if (!p.demod) {
        out_r[t * M + l] = vr;
        out_i[t * M + l] = vi;
        continue;
      }
      float qr, qi;
      if (g == 0) {
        qr = prr[l];
        qi = pri[l];
      } else {
        qr = yr[ch - M];
        qi = yi[ch - M];
      }
      const float zr = vr * qr + vi * qi;
      const float zi = vi * qr - vr * qi;
      out_r[t * M + l] = p.gain * atan2_poly(zi, zr);
      if (t == 0) {
        p.y0r[c * M + l] = vr;
        p.y0i[c * M + l] = vi;
      }
      if (t == p.F - 1) {
        p.ylr[c * M + l] = vr;
        p.yli[c * M + l] = vi;
      }
    }
    if (p.demod && !SDR_PFB_KO_EPI) {
      __syncthreads();
      const long long last = (t_end - g0 < G ? t_end - g0 : G) - 1;
      for (int l = threadIdx.x; l < M; l += blockDim.x) {
        const int ch = (int)last * M + chan_of_lane(l, p.n2);
        prr[l] = yr[ch];
        pri[l] = yi[ch];
      }
    }
    __syncthreads();
  }
}

// ---- the stream route --------------------------------------------------

constexpr int kStreamP = 8;                   // P the route takes
constexpr int kStreamSub = 8;                 // frames of one MAC item
constexpr int kStreamWarps = kPfbThreads / 32;
constexpr int kStreamV = 2;                   // lanes of one MAC load

// Two lanes as the raw words of their type (a float2; two bfloat16 as 32
// bits) and their widening to float32, so that a window's loads go out
// together before any is widened.  One lane a load measured 1.7x slower
// at W1 (PERF.md).
template <typename T>
struct Raw {
  using type = float2;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned;
};

template <typename T>
__device__ __forceinline__ typename Raw<T>::type ld_raw(const T* p,
                                                        long long i) {
  return *reinterpret_cast<const typename Raw<T>::type*>(p + i);
}

__device__ __forceinline__ void widen(float2 v, float (&o)[2]) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void widen(unsigned v, float (&o)[2]) {
  o[0] = __uint_as_float(v << 16);
  o[1] = __uint_as_float(v & 0xffff0000u);
}

// W_32^j = exp(-2 pi i j / 32), j < 16: the float64 values rounded once
// (ops/pfb.py::W32 holds the same numbers; j = 0 and 8 are exact).
__device__ __forceinline__ float w32_re(int j) {
  switch (j) {
    case 1: return 0.9807852804032304f;
    case 2: return 0.9238795325112867f;
    case 3: return 0.8314696123025452f;
    case 4: return 0.7071067811865476f;
    case 5: return 0.5555702330196023f;
    case 6: return 0.38268343236508984f;
    case 7: return 0.19509032201612833f;
    case 9: return -0.1950903220161282f;
    case 10: return -0.3826834323650897f;
    case 11: return -0.555570233019602f;
    case 12: return -0.7071067811865475f;
    case 13: return -0.8314696123025453f;
    case 14: return -0.9238795325112867f;
    default: return -0.9807852804032304f;  // 15
  }
}

__device__ __forceinline__ float w32_im(int j) {
  switch (j) {
    case 1: return -0.19509032201612825f;
    case 2: return -0.3826834323650898f;
    case 3: return -0.5555702330196022f;
    case 4: return -0.7071067811865475f;
    case 5: return -0.8314696123025452f;
    case 6: return -0.9238795325112867f;
    case 7: return -0.9807852804032304f;
    case 9: return -0.9807852804032304f;
    case 10: return -0.9238795325112867f;
    case 11: return -0.8314696123025455f;
    case 12: return -0.7071067811865476f;
    case 13: return -0.5555702330196022f;
    case 14: return -0.3826834323650899f;
    default: return -0.1950903220161286f;  // 15
  }
}

template <int LOGN>
__host__ __device__ constexpr int bitrev(int r) {
  int v = 0;
  for (int b = 0; b < LOGN; ++b) v |= ((r >> b) & 1) << (LOGN - 1 - b);
  return v;
}

// The N-point forward DFT of (re, im) in registers, radix-2 decimation in
// frequency: on return register r holds output bitrev(r).  Stage st pairs
// registers h = N / 2^(st+1) apart; the difference of pair i of a block
// is multiplied by W_(2h)^i = W_32^(i 16 / h) (1 and -i without a
// product).
template <int LOGN>
__device__ __forceinline__ void fft_reg(float (&re)[1 << LOGN],
                                        float (&im)[1 << LOGN]) {
  constexpr int N = 1 << LOGN;
#pragma unroll
  for (int st = 0; st < LOGN; ++st) {
    const int h = (N / 2) >> st;
#pragma unroll
    for (int b = 0; b < N / 2; ++b) {
      const int i = b % h;
      const int lo = (b / h) * 2 * h + i, hi = lo + h;
      const float ar = re[lo], ai = im[lo], br = re[hi], bi = im[hi];
      re[lo] = ar + br;
      im[lo] = ai + bi;
      const float dr = ar - br, di = ai - bi;
      const int j = i * (16 / h);
      if (j == 0) {
        re[hi] = dr;
        im[hi] = di;
      } else if (j == 8) {
        re[hi] = di;
        im[hi] = -dr;
      } else {
        const float c = w32_re(j), s = w32_im(j);
        re[hi] = dr * c - di * s;
        im[hi] = dr * s + di * c;
      }
    }
  }
}

// The stream route's shapes, for N = 2^LOGN.
template <int LOGN>
struct Stream {
  static constexpr int N = 1 << LOGN, M = N * N, LOGM = 2 * LOGN;
  static constexpr int FPW = 32 / N;            // frames a warp
  static constexpr int G = kStreamWarps * FPW;  // frames a group
  static constexpr int RS = M + N;              // a frame's row
  static constexpr int N2 = (M % 128 == 0 && M > 128) ? M / 128 : 0;
};

// Where a block's operands start, for stream c.
template <typename T>
struct StreamPtrs {
  const T* xr;
  const T* xi;
  const float* hr;
  const float* hi;
  float* out_r;
  float* out_i;
};

// The MAC of the group at g0 into the group buffer, by threads first,
// first + count, ...: item (lanes q .. q + V - 1, frames g0 + 8 sub .. +
// 7) from the window X[f0 - 8 .. f0 + 7] of those lanes, read once from
// the ring, where frame g0 + r of the group with parity cur sits at slot
// (cur G + r) mod 2G of each plane (frames before 0 from hist).
template <typename T, int LOGN>
__device__ __forceinline__ void stream_mac(const StreamPtrs<T>& a,
                                           const T* ring, int cur,
                                           const float* taps, float* ubr,
                                           float* ubi, long long g0,
                                           long long t_end, int first,
                                           int count) {
  using S = Stream<LOGN>;
  constexpr int M = S::M, RS = S::RS, V = kStreamV, G = S::G;
  constexpr int P = kStreamP, W = kStreamSub + kStreamP;
  const T* sr = ring;
  const T* si = ring + 2 * G * M;
  for (int it = first; it < (G / kStreamSub) * (M / V); it += count) {
    const int q = (it & (M / V - 1)) * V, sub = it / (M / V);
    const long long f0 = g0 + sub * kStreamSub;
    // where window frame j (at or after frame 0) sits in sr and si
    auto at = [&](int j) {
      return ((cur * G + sub * kStreamSub - P + j) & (2 * G - 1)) * M + q;
    };
    float wr[W][V], wi[W][V];
    if (f0 >= P && f0 + kStreamSub <= t_end) {  // no frame from hist
      typename Raw<T>::type rr[W], ri[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        rr[j] = ld_raw(sr, at(j));
        ri[j] = ld_raw(si, at(j));
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        widen(rr[j], wr[j]);
        widen(ri[j], wi[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const long long f = f0 - P + j;
        if (f < 0) {
          widen(ld_raw(a.hr, (P + f) * M + q), wr[j]);
          widen(ld_raw(a.hi, (P + f) * M + q), wi[j]);
        } else if (f < t_end) {
          widen(ld_raw(sr, at(j)), wr[j]);
          widen(ld_raw(si, at(j)), wi[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) wr[j][v] = wi[j][v] = 0.f;
        }
      }
    }
    float tk[P + 1][V];
#pragma unroll
    for (int k = 0; k <= P; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) tk[k][v] = __ldg(taps + k * M + q + v);
    }
    float* ur = ubr + sub * kStreamSub * RS + q;
    float* ui = ubi + sub * kStreamSub * RS + q;
#pragma unroll
    for (int i = 0; i < kStreamSub; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
#if SDR_PFB_KO_MAC
        const float sr = wr[i + P][v], si = wi[i + P][v];
#else
        float sr = 0.f, si = 0.f;
#pragma unroll
        for (int k = 0; k <= P; ++k) {
          sr += tk[k][v] * wr[i + P - k][v];
          si += tk[k][v] * wi[i + P - k][v];
        }
#endif
        ur[i * RS + v] = sr;
        ui[i * RS + v] = si;
      }
    }
  }
}

// The FFT of warp w's frames, in place in their rows: lanes [N j, N j + N)
// hold frame w FPW + j, lane n2 = col its column; Y[k1 + N k2] ends at
// row k2, column k1 of the frame's row.
template <int LOGN>
__device__ __forceinline__ void stream_fft(float* ubr, float* ubi,
                                           const float* twr,
                                           const float* twi, int w,
                                           int lane) {
  using S = Stream<LOGN>;
  constexpr int N = S::N;
  const int col = lane & (N - 1);
  float* sr = ubr + (w * S::FPW + (lane >> LOGN)) * S::RS;
  float* si = ubi + (w * S::FPW + (lane >> LOGN)) * S::RS;
  float ar[N], ai[N];
#pragma unroll
  for (int n1 = 0; n1 < N; ++n1) {
    ar[n1] = sr[col + N * n1];
    ai[n1] = si[col + N * n1];
  }
#if !SDR_PFB_KO_FFT
  fft_reg<LOGN>(ar, ai);
#pragma unroll
  for (int r = 0; r < N; ++r) {  // A[k1] W_M^(col k1)
    const int k1 = bitrev<LOGN>(r);
    const float cr = twr[k1 * N + col], ci = twi[k1 * N + col];
    const float vr = ar[r] * cr - ai[r] * ci;
    ai[r] = ar[r] * ci + ai[r] * cr;
    ar[r] = vr;
  }
#endif
  __syncwarp();
#pragma unroll
  for (int r = 0; r < N; ++r) {  // row col, column k1
    const int k1 = SDR_PFB_KO_FFT ? r : bitrev<LOGN>(r);
    sr[col * (N + 1) + k1] = ar[r];
    si[col * (N + 1) + k1] = ai[r];
  }
  __syncwarp();
#pragma unroll
  for (int n2 = 0; n2 < N; ++n2) {  // column col = k1 now
    ar[n2] = sr[n2 * (N + 1) + col];
    ai[n2] = si[n2 * (N + 1) + col];
  }
#if !SDR_PFB_KO_FFT
  fft_reg<LOGN>(ar, ai);
#endif
  __syncwarp();
#pragma unroll
  for (int r = 0; r < N; ++r) {  // Y[k1 + N k2] at row k2, column k1
    const int k2 = SDR_PFB_KO_FFT ? r : bitrev<LOGN>(r);
    sr[k2 * (N + 1) + col] = ar[r];
    si[k2 * (N + 1) + col] = ai[r];
  }
}

// The epilogue of one output: lane l of frame fl (at time t) takes Y from
// the frame's row at pos, the demod's Y[t - 1] from the row before or,
// for the group's first frame, from ping-pong row par ^ 1; the group's
// last frame leaves its Y in row par.  The atan2's ratio from the fast
// division (2 ulp, ~1e-7 rad), as fir_tc.cu's: with the IEEE division's
// slow path in each of the 32 unrolled outputs W1 took 0.695 ms, with
// this one 0.475 (PERF.md).
template <int LOGN, bool DEMOD>
__device__ __forceinline__ void stream_out(
    const PfbParams& p, long long c, float* out_r, float* out_i,
    const float* ubr, const float* ubi, float* pvr, float* pvi, int par,
    long long t, int fl, int last, int l, int pos) {
  constexpr int M = Stream<LOGN>::M, RS = Stream<LOGN>::RS;
#if SDR_PFB_KO_EPI
  out_r[t * M + l] = ubr[fl * RS + l];
  if (!DEMOD) out_i[t * M + l] = ubi[fl * RS + l];
  return;
#endif
  const float vr = ubr[pos], vi = ubi[pos];
  if (!DEMOD) {
    out_r[t * M + l] = vr;
    out_i[t * M + l] = vi;
    return;
  }
  float qr, qi;
  if (fl == 0) {
    qr = pvr[(par ^ 1) * M + l];
    qi = pvi[(par ^ 1) * M + l];
  } else {
    qr = ubr[pos - RS];
    qi = ubi[pos - RS];
  }
  const float zr = vr * qr + vi * qi;
  const float zi = vi * qr - vr * qi;
  out_r[t * M + l] = p.gain * atan2_poly<true>(zi, zr);
  if (fl == last) {
    pvr[par * M + l] = vr;
    pvi[par * M + l] = vi;
  }
  if (t == 0) {
    p.y0r[c * M + l] = vr;
    p.y0i[c * M + l] = vi;
  }
  if (t == p.F - 1) {
    p.ylr[c * M + l] = vr;
    p.yli[c * M + l] = vi;
  }
}

// The epilogue over warp w's frames of the group at g0, part h of H (the
// lanes l = lane + 32 i with i in [h K, h K + K), K = M / 32 / H).  Lane
// l's channel ch = chan_of_lane(l) sits at pos = ch + ch / N of the
// frame's row; for M >= 64 that is a part of the lane plus a constant of i
// (the lane permutation n2 (l mod 128) + l / 128 and the row's pad both
// split so; K is a multiple of 4), so the unrolled loop reads at fixed
// offsets.
template <int LOGN, bool DEMOD, int H>
__device__ __forceinline__ void stream_epilogue(
    const PfbParams& p, long long c, float* out_r, float* out_i,
    const float* ubr, const float* ubi, float* pvr, float* pvi, int par,
    long long g0, long long t0, long long t_end, int w, int h, int lane) {
  using S = Stream<LOGN>;
  constexpr int M = S::M, RS = S::RS, N = S::N, N2 = S::N2;
  constexpr int K = M / 32 / H;
  const int last = (int)(t_end - g0 < S::G ? t_end - g0 : S::G) - 1;
  if constexpr (M >= 64) {
    static_assert(H == 1 || (N2 > 0 && K % 4 == 0), "parts of 4 i");
    constexpr int D = 128 / N;  // lanes of one row column (N2 > 0)
    const int base = (N2 ? N2 * lane + lane / D : lane + (lane >> LOGN)) +
                     h * (K / 4);
#pragma unroll
    for (int j = 0; j < S::FPW; ++j) {
      const int fl = w * S::FPW + j;
      const long long t = g0 + fl;
      if (t < t0 || t >= t_end) continue;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int off = N2 ? N2 * 32 * (i & 3) + (i >> 2) + 32 * (i & 3) / D
                           : 32 * i + ((32 * i) >> LOGN);
        stream_out<LOGN, DEMOD>(p, c, out_r, out_i, ubr, ubi, pvr, pvi, par,
                                t, fl, last, lane + 32 * (h * K + i),
                                fl * RS + base + off);
      }
    }
  } else {
    static_assert(H == 1, "one part below M = 64");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = lane + 32 * i;
      const int fl = w * S::FPW + (e >> S::LOGM);
      const int l = e & (M - 1);
      const long long t = g0 + fl;
      if (t < t0 || t >= t_end) continue;
      stream_out<LOGN, DEMOD>(p, c, out_r, out_i, ubr, ubi, pvr, pvi, par, t,
                              fl, last, l, fl * RS + l + (l >> LOGN));
    }
  }
}

// Shared memory of the stream route: the ring first (two planes of 2G raw
// frames: the group's and the one before), then in floats the group
// buffer's two planes (G rows of M + N), the twiddle table's two planes (M
// each), for the demod two ping-pong rows of Y per plane, and the ring's
// two mbarriers.  Blocks a SM: 2 of 8 warps where two
// fit, else 1 of 16 warps (at most 128 registers a thread either way): the
// FFT runs on 8 warps, the MAC on all, the epilogue on all (two warps a
// frame's lanes with 16).
template <typename T, int LOGN, bool DEMOD>
struct StreamSmem {
  using S = Stream<LOGN>;
  static constexpr size_t kRing = 4 * (size_t)S::G * S::M * sizeof(T);
  static constexpr size_t kFloats =
      2 * (size_t)S::G * S::RS + 2 * S::M + (DEMOD ? 4 * S::M : 0);
  static constexpr size_t kBars = kRing + kFloats * sizeof(float);
  static constexpr size_t kBytes = kBars + 16;
  static constexpr int kMinBlocks = kBytes <= 113 * 1024 ? 2 : 1;
  static constexpr int kThreads = kPfbThreads * (3 - kMinBlocks);
};

// Thread 0: the bulk copies of the group at g0 (frames g0 .. up to g0 + G
// - 1 before t_end) of both planes into chunk `chunk` of the ring, and with
// halo the P frames before it (those at or after 0) into the other chunk's
// last slots, all completing on the mbarrier at bar.  Every copy is whole
// frames: 16-byte aligned and a multiple of 16 bytes (M sizeof(T) >= 32, the
// planes 16-byte aligned by the wrapper).
template <typename T, int LOGN>
__device__ __forceinline__ void ring_fetch(const StreamPtrs<T>& a, T* ring,
                                           uint32_t bar, long long g0,
                                           long long t_end, int chunk,
                                           bool halo) {
  using S = Stream<LOGN>;
  constexpr int M = S::M, G = S::G;
  constexpr uint32_t FB = M * sizeof(T);  // bytes a frame
  const int n = (int)(t_end - g0 < G ? t_end - g0 : G);
  const int nh = halo ? (int)(g0 < kStreamP ? g0 : kStreamP) : 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(2 * (n + nh) * FB)
               : "memory");
  for (int pl = 0; pl < 2; ++pl) {
    const T* src = pl ? a.xi : a.xr;
    T* plane = ring + pl * 2 * G * M;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(plane + chunk * G * M)),
        "l"(src + g0 * M), "r"(n * FB), "r"(bar)
        : "memory");
    if (nh) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(plane + (2 * G - nh) * M)),
          "l"(src + (g0 - nh) * M), "r"(nh * FB), "r"(bar)
          : "memory");
    }
  }
}

// A block's start: its stream, tile and operands; thread 0 sets up the
// two mbarriers and starts the first group's copy (with its halo) before
// the block stages the twiddle table as [k1][n2] = W_M^(n2 k1) and prev in
// ping-pong row 1 for the first tile (its first group reads row par ^ 1 =
// 1).  Kept as a function, and the MAC's threads
// as arguments (blockDim.x, not a constant): with this written into the
// kernel or the MAC's thread range fixed inside it, ptxas spilled 316
// bytes in the M = 1024 demod instantiation at the 128-register cap and
// W1 took 1.00-1.03 ms against 0.47 (PERF.md).
template <typename T, int LOGN, bool DEMOD>
__device__ __forceinline__ StreamPtrs<T> stream_start(
    const PfbParams& p, T* ring, uint32_t bar, float* twr, float* twi,
    float* pvr, float* pvi, long long* c, long long* t0, long long* t_end) {
  using S = Stream<LOGN>;
  constexpr int M = S::M, P = kStreamP;
  *c = blockIdx.x / p.tiles;
  *t0 = (blockIdx.x % p.tiles) * p.TT;
  *t_end = *t0 + p.TT < p.F ? *t0 + p.TT : p.F;
  StreamPtrs<T> a;
  a.xr = static_cast<const T*>(p.xr) + *c * p.F * M;
  a.xi = static_cast<const T*>(p.xi) + *c * p.F * M;
  a.hr = p.hr + *c * P * M;
  a.hi = p.hi + *c * P * M;
  a.out_r = p.out_r + *c * p.F * M;
  a.out_i = DEMOD ? nullptr : p.out_i + *c * p.F * M;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       bar + 8 * k),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long s = (DEMOD && *t0 > 0) ? *t0 - 1 : *t0;
    ring_fetch<T, LOGN>(a, ring, bar, s, *t_end, 0, true);
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int w = (i & (S::N - 1)) * (i >> LOGN);
    twr[i] = p.twr[w];
    twi[i] = p.twi[w];
    if (DEMOD && *t0 == 0) {
      pvr[M + i] = p.pr[*c * M + i];
      pvi[M + i] = p.pi[*c * M + i];
    }
  }
  return a;
}

// A block walks its tile in groups: wait for the group's frames, MAC,
// barrier, the next group's copy, FFT, barrier (demod or 16 warps: other
// warps' rows), epilogue, barrier.
template <typename T, int LOGN, bool DEMOD>
__global__ void __launch_bounds__(StreamSmem<T, LOGN, DEMOD>::kThreads,
                                  StreamSmem<T, LOGN, DEMOD>::kMinBlocks)
    pfb_stream_kernel(PfbParams p) {
  using S = Stream<LOGN>;
  using Z = StreamSmem<T, LOGN, DEMOD>;
  constexpr int H = Z::kThreads / kPfbThreads;  // warps a frame's epilogue
  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* ubr = smem + Z::kRing / sizeof(float);
  float* ubi = ubr + S::G * S::RS;
  float* twr = ubi + S::G * S::RS;
  float* twi = twr + S::M;
  float* pvr = twi + S::M;
  float* pvi = pvr + 2 * S::M;
  const uint32_t bar = smem_addr(reinterpret_cast<char*>(smem) + Z::kBars);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long c, t0, t_end;
  const StreamPtrs<T> a = stream_start<T, LOGN, DEMOD>(
      p, ring, bar, twr, twi, pvr, pvi, &c, &t0, &t_end);
  const long long s = (DEMOD && t0 > 0) ? t0 - 1 : t0;
  __syncthreads();  // the mbarriers set up before any waits
  int par = 0;
  uint32_t phase = 0;  // of mbarrier par: the group's index / 2, mod 2
  for (long long g0 = s; g0 < t_end; g0 += S::G, par ^= 1) {
    bar_wait(bar + 8 * par, phase);
    phase ^= par;
    stream_mac<T, LOGN>(a, ring, par, p.taps, ubr, ubi, g0, t_end,
                        threadIdx.x, blockDim.x);
    __syncthreads();
    // the next group's frames into the chunk the MAC has just read last
    if (threadIdx.x == 0 && g0 + S::G < t_end) {
      ring_fetch<T, LOGN>(a, ring, bar + 8 * (par ^ 1), g0 + S::G, t_end,
                          par ^ 1, false);
    }
    if (warp < kStreamWarps) stream_fft<LOGN>(ubr, ubi, twr, twi, warp, lane);
    if (DEMOD || H > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    stream_epilogue<LOGN, DEMOD, H>(p, c, a.out_r, a.out_i, ubr, ubi, pvr,
                                    pvi, par, g0, t0, t_end,
                                    warp % kStreamWarps, warp / kStreamWarps,
                                    lane);
    __syncthreads();
  }
}

// log2 N of the stream route for (M, P), or 0 for the generic route.
int stream_log2n(int M, int P) {
  if (!SDR_PFB_STREAM || P != kStreamP) return 0;
  switch (M) {
    case 16: return 2;
    case 64: return 3;
    case 256: return 4;
    case 1024: return 5;
    default: return 0;
  }
}

constexpr int kPfbMaxDevices = 64;

// One launch of the stream route: the tile from F, so that C x tiles
// fills the blocks the card holds at once.  Those (SMs x blocks a SM) are
// found, and the shared memory attribute set, at a device's first launch
// of each instantiation.
template <typename T, int LOGN, bool DEMOD>
int launch_stream(PfbParams& p, cudaStream_t stream) {
  constexpr int G = Stream<LOGN>::G;
  constexpr int threads = StreamSmem<T, LOGN, DEMOD>::kThreads;
  constexpr size_t smem = StreamSmem<T, LOGN, DEMOD>::kBytes;
  static std::atomic<long long> resident[kPfbMaxDevices];
  auto kern = pfb_stream_kernel<T, LOGN, DEMOD>;
  int dev = 0, e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  if (dev < 0 || dev >= kPfbMaxDevices) return -1;
  long long want = resident[dev].load(std::memory_order_relaxed);
  if (want == 0) {
    e = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != 0) return e;
    int sms = 0, per_sm = 0;
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (e != 0) return e;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                           threads, smem);
    if (e != 0) return e;
    want = (long long)sms * (per_sm > 0 ? per_sm : 1);
    resident[dev].store(want, std::memory_order_relaxed);
  }
  const long long tiles = (want + p.C - 1) / p.C;
  const long long per = (p.F + tiles - 1) / tiles;
  const long long dm = DEMOD ? 1 : 0;  // a later tile's recomputed frame
  p.G = G;
  p.TT = ((per + dm + G - 1) / G) * G - dm;
  p.tiles = (p.F + p.TT - 1) / p.TT;
  if (p.C * p.tiles > 0x7fffffffLL) return -1;
  kern<<<(unsigned)(p.C * p.tiles), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool DEMOD>
int launch_stream_n(PfbParams& p, int logn, cudaStream_t stream) {
  switch (logn) {
    case 2: return launch_stream<T, 2, DEMOD>(p, stream);
    case 3: return launch_stream<T, 3, DEMOD>(p, stream);
    case 4: return launch_stream<T, 4, DEMOD>(p, stream);
    default: return launch_stream<T, 5, DEMOD>(p, stream);
  }
}

template <typename T>
int launch_stream_any(PfbParams& p, int logn, cudaStream_t stream) {
  return p.demod ? launch_stream_n<T, true>(p, logn, stream)
                 : launch_stream_n<T, false>(p, logn, stream);
}

// The FFT's stages for M = a 2^k, a in {1, 3, 5, 7}; 0 and no stages for
// M = 1; -1 for any other M (the direct DFT).
int plan_stages(int M, int* radix) {
  int a = M;
  while (a % 2 == 0) a /= 2;
  if (a != 1 && a != 3 && a != 5 && a != 7) return -1;
  int n = 0;
  if (a > 1) radix[n++] = a;
  int k = M / a;
  while (k >= 4) {
    radix[n++] = 4;
    k /= 4;
  }
  if (k == 2) radix[n++] = 2;
  return n;
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// The route sdr_pfb takes for (M, P): 1 the stream route, 0 the generic
// one (the shape alone decides).
int sdr_pfb_route(int M, int P) { return stream_log2n(M, P) != 0; }

// The PFB over x (C, F, M) planes (float32, or bfloat16 when bf16 != 0).
// All pointers are device pointers: hist planes (C, P, M), taps (P + 1, M),
// the twiddle table (M,) and prev (C, M) (demod) float32.  Writes the
// lane-layout Y planes (C, F, M) to out_r / out_i, or with demod != 0 the
// audio to out_r and y_last / y_first (C, M) to ylr, yli / y0r, y0i.
// Writes the route taken to *route (as sdr_pfb_route) when route is not
// null.  Returns 0, -1 when the shape is outside the gate (1 <= M <= 8192,
// 1 <= P <= 32, C >= 1, F >= 1), else a cudaError_t.
int sdr_pfb(const void* xr, const void* xi, const float* hr, const float* hi,
            const float* taps, const float* twr, const float* twi,
            const float* pr, const float* pi, float* out_r, float* out_i,
            float* ylr, float* yli, float* y0r, float* y0i, long long C,
            long long F, int M, int P, float gain, int demod, int bf16,
            void* stream, int* route) {
  if (M < 1 || M > kPfbMaxM || P < 1 || P > kPfbMaxP || C < 1 || F < 1 ||
      !xr || !xi || !hr || !hi || !taps || !twr || !twi || !out_r ||
      (demod && (!pr || !pi || !ylr || !yli || !y0r || !y0i)) ||
      (!demod && !out_i)) {
    return -1;
  }
  PfbParams p{};
  p.xr = xr;
  p.xi = xi;
  p.hr = hr;
  p.hi = hi;
  p.taps = taps;
  p.twr = twr;
  p.twi = twi;
  p.pr = pr;
  p.pi = pi;
  p.out_r = out_r;
  p.out_i = out_i;
  p.ylr = ylr;
  p.yli = yli;
  p.y0r = y0r;
  p.y0i = y0i;
  p.C = C;
  p.F = F;
  p.M = M;
  p.P = P;
  p.gain = gain;
  p.demod = demod;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int logn = stream_log2n(M, P);
  if (route) *route = logn != 0;
  if (logn) {
    return bf16 ? launch_stream_any<__nv_bfloat16>(p, logn, s)
                : launch_stream_any<float>(p, logn, s);
  }
  p.G = M < kGroupElems ? kGroupElems / M : 1;
  p.TT = p.G >= kTileFrames ? p.G
                            : ((kTileFrames + p.G - 1) / p.G) * p.G;
  p.tiles = (F + p.TT - 1) / p.TT;
  p.n2 = (M % 128 == 0 && M > 128) ? M / 128 : 0;
  p.n_stages = plan_stages(M, p.radix);
  if (C * p.tiles > 0x7fffffffLL) return -1;
  const size_t smem = (size_t)(4 * p.G * M + 2 * M) * sizeof(float);
  int e;
  if (bf16) {
    e = (int)cudaFuncSetAttribute(pfb_kernel<__nv_bfloat16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e != 0) return e;
    pfb_kernel<__nv_bfloat16><<<(unsigned)(C * p.tiles), kPfbThreads, smem,
                                s>>>(p);
  } else {
    e = (int)cudaFuncSetAttribute(pfb_kernel<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e != 0) return e;
    pfb_kernel<float><<<(unsigned)(C * p.tiles), kPfbThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
