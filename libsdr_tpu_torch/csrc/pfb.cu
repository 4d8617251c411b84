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
// Design (right and simple first; the TPU kernel's n2-point stage,
// Karatsuba split-bf16 matmul, manual DMA and step-to-step history copies
// do not carry over: blocks run in no order here, so nothing carries from
// one block to the next):
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
// * Any C >= 1 and F >= 1 (also F < P), any 1 <= M <= 8192, 1 <= P <= 32:
//   the JAX package fell back to XLA for a leading stream axis and F <= P;
//   there is no fallback here.
// * float32 or bfloat16 planes (widened on load); hist, taps, prev and
//   every sum in float32.
// * The entry point returns cudaGetLastError() after the launch, or -1
//   when the shape is outside the gate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_common.cuh"

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
  int TT;              // frames per tile (a multiple of G)
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
  extern __shared__ float smem[];
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
      if (t < t_end) mac(xr, xi, hr, hi, p.taps, t, q, M, P, ur, ui);
      ar[e] = ur;
      ai[e] = ui;
    }
    __syncthreads();

    // ---- the DFT of each frame; the result in (yr, yi)
    float *inr = ar, *ini = ai, *outr = br, *outi = bi;
    if (p.n_stages < 0) {
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
    if (p.demod) {
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

// The PFB over x (C, F, M) planes (float32, or bfloat16 when bf16 != 0).
// All pointers are device pointers: hist planes (C, P, M), taps (P + 1, M),
// the twiddle table (M,) and prev (C, M) (demod) float32.  Writes the
// lane-layout Y planes (C, F, M) to out_r / out_i, or with demod != 0 the
// audio to out_r and y_last / y_first (C, M) to ylr, yli / y0r, y0i.
// Returns 0, -1 when the shape is outside the gate (1 <= M <= 8192,
// 1 <= P <= 32, C >= 1, F >= 1), else a cudaError_t.
int sdr_pfb(const void* xr, const void* xi, const float* hr, const float* hi,
            const float* taps, const float* twr, const float* twi,
            const float* pr, const float* pi, float* out_r, float* out_i,
            float* ylr, float* yli, float* y0r, float* y0i, long long C,
            long long F, int M, int P, float gain, int demod, int bf16,
            void* stream) {
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
  p.G = M < kGroupElems ? kGroupElems / M : 1;
  p.TT = p.G >= kTileFrames ? p.G
                            : ((kTileFrames + p.G - 1) / p.G) * p.G;
  p.tiles = (F + p.TT - 1) / p.TT;
  p.n2 = (M % 128 == 0 && M > 128) ? M / 128 : 0;
  p.n_stages = plan_stages(M, p.radix);
  if (C * p.tiles > 0x7fffffffLL) return -1;
  const size_t smem = (size_t)(4 * p.G * M + 2 * M) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
