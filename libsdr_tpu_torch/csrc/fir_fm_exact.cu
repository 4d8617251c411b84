// Fused decimating complex FIR + demodulator: the receive chains' front end
// in one pass over the raw IQ planes.  The modes (fir_common.cuh) are
//
//   kFm   FIR + quadrature FM discriminator (+ first-order de-emphasis)
//   kFir  FIR alone, both planes of y
//   kAm   FIR + envelope |y| (+ AGC)
//   kUsb  FIR + exact per-output NCO rotation + (re+im)/2 (+ AGC)
//   kAfsk FIR + FM discriminator + dual-tone FSK correlator (fir_common.cuh)
//
// Replaces the TPU kernel libsdr_tpu/ops/pallas_fir_mxu.py::_kernel_fm2 in
// its modes 'fm' (entry fir_fm_exact), 'fir' (entry fir_exact), 'am',
// 'usb' and 'afsk' (entry fir_afsk_exact), which ran the FIR as
// block-Toeplitz frame matmuls on the TPU's matrix unit and the
// correlator's window sums as banded matmuls.  With a window start of the
// caller's (fir_common.cuh) the same kernels replace the v1 TPU kernels
// pallas_fir_mxu.py::_kernel (K5: mode 'fir', entry sdr_fir_mxu, whose
// output planes ops/fir_mxu.py::fir_mxu and fir_overlap_save read) and
// ::_kernel_fm (K6: modes 'fm' and 'am', entry sdr_fir_fm_mxu).  These
// kernels compute the same functions directly:
//
//   xc      = concat(tail, x)                         (tail: last T-1 samples)
//   y[j]    = sum_i g[i] * xc[j*D + D-1 + i]          (correlation form, no conj;
//                                                      K5/K6: window start s0)
//   z[j]    = y[j] * conj(y[j-1]) * rot               (y[-1] = prev)
//   audio   = gain * atan2poly(Im z, Re z)
//   out[j]  = a*out[j-1] + b*audio[j]                 (out[-1] = dstate; optional)
//
// and in mode kFm export y_last = y[B/D - 1].  The caller carries
// tail' = x[B-(T-1):], prev' = y_last and dstate' = out[B/D - 1].
//
// What bounds it on an H100: per complex input sample it reads 8 bytes (f32
// planes) or 4 bytes (bf16 planes) and writes 4/D bytes (8/D for kFir), and
// it runs about 4*T/D real FMAs (67 at T=67, D=4).  At 3.35 TB/s and
// 67 TFLOP/s f32 the two bounds are close at D = 4, so neither can be
// ignored; at the rx app's strides (D >= 40, T/D < 2) HBM bounds it.
//
// Three kernels share the work by shape (route_of below): every mode of K1,
// K5 (mode kFir from any window start) and kFm and kAm of K6 take the
// tensor-core kernel of fir_tc.cu at the strides of its cut
// (fir_common.cuh: tc_stride); every other launch (strides or tap counts
// outside the cut) takes the staged kernel below at strides up to
// staged_max_d(mode) and the warp kernel of fir_warp.cu above, which
// stages a few windows per warp instead of D polyphase rows per block.
//
// Design of the staged kernel:
// * Each channel's B/D outputs are cut into K chunks, K from the occupancy
//   API so that all C*K blocks are resident at once (sdr_fir_chunks; at 64
//   channels one chunk per channel would fill only 64 of the 132 SMs).  One
//   block of 256 threads walks its chunk in segments of 256*R outputs; block
//   order does not matter.
// * The FIR needs no carry: each segment stages its inputs plus the T-1
//   sample halo (from the tail carry at the start of the block) in shared
//   memory, polyphase (sample m at [m % D][m / D]) as complex pairs.  Each
//   thread computes R = 4 consecutive outputs (2 or 1 where shared memory
//   is short); for one phase they slide over one window of R samples held in
//   registers, so each tap costs one shared load of a sample and one of the
//   tap (taps are stored by phase) for R complex FMAs, all at constant
//   offsets.  A pad slot after every R samples keeps the lanes' loads
//   (stride R) free of bank conflicts.
// * With float32 planes the next segment's samples are loaded into
//   registers while the current one computes, hiding the load latency.
// * kFm: the discriminator takes y[j-1] from the previous lane (shuffle),
//   the previous warp (shared memory), the previous segment, or for a
//   chunk's first output a y recomputed from the chunk's halo.
// * kFm: the de-emphasis IIR is the only true sequential dependency.  Inside
//   a block it is a chunked scan (per-thread pass from state 0, a scan of
//   the thread ends with shuffles, a fix-up out += a^(r+1) * state_in),
//   carried across segments in shared memory.  Across chunks, every chunk
//   but the first starts from state 0; deemph_chunk_scan turns the
//   chunk-end values into each chunk's true entry state and
//   deemph_chunk_fixup adds a^(n+1) * state to the chunk's head until the
//   power underflows.
// * kFir, kAm and kUsb write their per-output values and need no carry but
//   the tail.  The AGC's output gain*sig/sd is not linear in the state, and
//   its time constant spans tens of thousands of outputs, so no fix-up can
//   carry it across chunks: the kernel writes sig and agc.cu runs the AGC
//   in a second pass (8/D bytes per input sample).
// * kAfsk: the audio of each segment is multiplied by the tone templates
//   and the products u (4 floats) go to a shared-memory history behind the
//   last L-1 products of the previous segment (or, at the block's start,
//   the carried ones); each thread sums the L products of each of its R
//   outputs in one fixed order, oldest first (a running add-and-subtract
//   sum would drift in float32), reading each product once for its R
//   outputs.  A chunk after the first starts L outputs early: those outputs
//   only fill the history (the first has no true y[j-1]), so no chunk
//   needs another's products and no y is recomputed by another path.
//   Per output that adds 4L additions to the FIR's 4T FMAs (L = 40, T = 51
//   on the AX.25 bank), and 16*(L-1 + 256R) bytes of shared memory.
// * The window start is a parameter (fir_common.cuh): K1 starts window j
//   at x[j*D + D - T], K5/K6 wherever the caller says.  A segment's loads
//   that lie inside the block read x directly; only the segments at the
//   block's edges (the tail, the v1 contract's clamped last frame) take the
//   index compares, so the parameter costs K1 nothing per load.
// * bf16 planes are read as bf16 and widened in registers; all arithmetic is
//   f32.  Offsets into the (C, B) planes are 64-bit.
// * The kernels allocate nothing and do not synchronise; the entry points
//   return cudaGetLastError() after the launches, or -1 when the shape is
//   outside the gate (see ops/fir_fm.py).

#include "fir_common.cuh"

namespace sdr {
namespace {

constexpr int kLoads = 8;  // global loads in flight per plane and thread

// Skewed column of polyphase sample q: one pad slot after every R samples,
// so that the lanes of a warp, reading q = lane*R + c, hit distinct bank
// pairs.  skew(a + v) = skew(a) + skew(v) when R divides a.
template <int R>
__host__ __device__ __forceinline__ constexpr int skew(int q) {
  return R == 1 ? q : q + q / R;
}

// kAfsk's history of tone products (float4, skewed like the input): the
// last L-1 products before the segment, then the segment's 256*R; none in
// the other modes (L = 0).
template <int R>
__host__ __device__ __forceinline__ size_t u_bytes(int L) {
  return L ? 16 * ((size_t)skew<R>(L - 1 + kThreads * R - 1) + 1) : 0;
}

// Shared memory: kAfsk's history (16-byte aligned at the base), taps by
// phase (D rows of ceil(T/D) float2), the polyphase input (D rows of Qs
// complex samples), then per-warp scratch and the block state (floats).
template <typename Tin, int R>
size_t smem_bytes(int T, int D, int Q, int L) {
  const size_t taps = 8 * (size_t)D * ((T + D - 1) / D);
  const size_t qs = (size_t)skew<R>(Q - 1) + 1;
  const size_t x = (size_t)D * qs * sizeof(typename Cplx<Tin>::type);
  return u_bytes<R>(L) + taps + ((x + 7) / 8) * 8 +
         (4 * kWarps + 4) * sizeof(float);
}

template <int MODE, typename Tin, int R>
__global__ void __launch_bounds__(kThreads)
fir_fm_exact_kernel(const Params p) {
  using CT = typename Cplx<Tin>::type;
  constexpr int N = kThreads * R;  // outputs per segment
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, D = p.D, Q = p.Q;
  const int Qs = skew<R>(Q - 1) + 1;
  const int Tq = (T + D - 1) / D;  // taps per phase, at most
  const int ell = MODE == kAfsk ? p.L : 0;  // kAfsk: the window
  float4* s_u = reinterpret_cast<float4*>(smem);  // kAfsk: the history
  unsigned char* base = smem + u_bytes<R>(ell);
  float2* s_g = reinterpret_cast<float2*>(base);  // [ph][qi] = g[qi*D + ph]
  CT* s_x = reinterpret_cast<CT*>(base + 8 * (size_t)D * Tq);
  float* s_wtot = reinterpret_cast<float*>(
      base + 8 * (size_t)D * Tq +
      (((size_t)D * Qs * sizeof(CT) + 7) / 8) * 8);
  float* s_wpre = s_wtot + kWarps;
  float* s_wy = s_wpre + kWarps;        // last y of each warp (re, im)
  float* s_state = s_wy + 2 * kWarps;   // [y_prev re, y_prev im, dstate, -]

  const long long c = blockIdx.x / p.K;
  const int k = blockIdx.x % p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_out = p.n_out;
  const long long j_begin = k * p.chunk;
  const long long j_end = min(n_out, j_begin + p.chunk);
  const Tin* xr = static_cast<const Tin*>(p.xr) + c * p.B;
  const Tin* xi = static_cast<const Tin*>(p.xi) + c * p.B;
  // no tail where no window starts before the block (K5/K6)
  const Tin* tr = p.s0 < 0 ? static_cast<const Tin*>(p.tail_r) + c * (T - 1)
                           : nullptr;
  const Tin* ti = p.s0 < 0 ? static_cast<const Tin*>(p.tail_i) + c * (T - 1)
                           : nullptr;
  float* orow = p.out + c * n_out;
  float ph_r = 0.f, ph_i = 0.f;  // kUsb: the block's unit phasor a0
  if constexpr (MODE == kUsb) {
    ph_r = p.ph_r[0];
    ph_i = p.ph_i[0];
  }
  // kAfsk: a later chunk starts L outputs early to fill its history.
  const long long j_start = MODE == kAfsk && k > 0 ? j_begin - ell : j_begin;

  for (int i = tid; i < T; i += kThreads) {
    s_g[(i % D) * Tq + i / D] = make_float2(p.taps_r[i], p.taps_i[i]);
  }
  if constexpr (MODE == kFm) {
    if (k == 0) {
      if (tid == 0) {
        s_state[0] = p.prev_r[c];
        s_state[1] = p.prev_i[c];
        s_state[2] = p.deemph ? p.dstate[c] : 0.f;
      }
    } else if (warp == 0) {
      // A later chunk starts from y[j_begin - 1], recomputed here, and from
      // de-emphasis state 0 (deemph_chunk_fixup adds the true state later).
      const float2 y =
          warp_y_at<0>(xr, xi, tr, ti, (j_begin - 1) * D + p.s0, p, lane);
      if (lane == 0) {
        s_state[0] = y.x;
        s_state[1] = y.y;
        s_state[2] = 0.f;
      }
    }
  }
  if constexpr (MODE == kAfsk) {
    // The first chunk starts from the carried y[-1] and products; a later
    // one from zeros, which only reach outputs it does not write.
    if (tid == 0) {
      s_state[0] = k == 0 ? p.prev_r[c] : 0.f;
      s_state[1] = k == 0 ? p.prev_i[c] : 0.f;
    }
    if (tid < ell - 1) {
      const long long o = c * (ell - 1) + tid;
      s_u[skew<R>(tid)] =
          k == 0 ? make_float4(p.u_in[0][o], p.u_in[1][o], p.u_in[2][o],
                               p.u_in[3][o])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const DeemphScan<R> deemph(p.a, p.b, lane);
  // Polyphase position of sample m = tid + u*kThreads, advanced per u.
  const int dq = kThreads / D, dp = kThreads % D;
  const int p0 = tid % D, q0 = tid / D;
  const int jb = tid * R;  // this thread's first output in a segment
  // Software pipeline (float32 planes): the first kPre samples per plane
  // and thread of the next segment are loaded into registers while this
  // segment computes.  bf16 planes stage synchronously: packing two bf16
  // loads into one register waits for them, and unpacked they cost twice
  // the registers (measured slower either way).
  constexpr int kPre = sizeof(Tin) == 4 ? 4 * R + 1 : 0;
  CT fx[kPre > 0 ? kPre : 1];
  auto prefetch = [&](long long js) {
    const int nvs = (int)min((long long)N, j_end - js);
    const int Ls = (nvs - 1) * D + T;
    const long long bs = js * D + p.s0;
    auto run = [&](auto inner) {
      using In = decltype(inner);
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const long long n = bs + u * kThreads + tid;
        if (u * kThreads + tid < Ls) {
          fx[u] = Cplx<Tin>::make(sample<In>(xr, tr, n, p),
                                  sample<In>(xi, ti, n, p));
        }
      }
    };
    if (inner_run(bs, Ls, p)) {
      run(Inside{});
    } else {
      run(Edge{});
    }
  };
  prefetch(j_start);
  __syncthreads();

  for (long long j0 = j_start; j0 < j_end; j0 += N) {
    const int nv = (int)(j_end - j0 < N ? j_end - j0 : N);
    const int L = (nv - 1) * D + T;
    // Stage samples [base, base + L) as [m % D][skew(m / D)]: the prefetched
    // ones, then any rest with kLoads global loads in flight per plane and
    // thread.  Negative x indices are the tail (sample_at).
    const long long base = j0 * D + p.s0;
    const bool inner = inner_run(base, L, p);
    int pp = p0, qq = q0;
    auto advance = [&]() {
      pp += dp;
      qq += dq;
      if (pp >= D) {
        pp -= D;
        ++qq;
      }
    };
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      if (u * kThreads + tid < L) {
        s_x[pp * Qs + skew<R>(qq)] = fx[u];
      }
      advance();
    }
    for (int m0 = kPre * kThreads; m0 < L; m0 += kThreads * kLoads) {
      Tin vr[kLoads], vi[kLoads];
      auto run = [&](auto in) {
        using In = decltype(in);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int m = m0 + u * kThreads + tid;
          if (m < L) {
            vr[u] = sample<In>(xr, tr, base + m, p);
            vi[u] = sample<In>(xi, ti, base + m, p);
          }
        }
      };
      if (inner) {
        run(Inside{});
      } else {
        run(Edge{});
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (m0 + u * kThreads + tid < L) {
          s_x[pp * Qs + skew<R>(qq)] = Cplx<Tin>::make(vr[u], vi[u]);
        }
        advance();
      }
    }
    __syncthreads();
    if (j0 + N < j_end) prefetch(j0 + N);

    // FIR: this thread computes the R consecutive outputs jb + r.  Tap
    // i = qi*D + ph of output jb + r reads staged sample [ph][jb + r + qi],
    // so for one phase the R outputs slide over one window of R samples:
    // each step loads one new sample and one tap for R complex FMAs.  The
    // window is a ring indexed (qi + r) % R, static once qi's loop is
    // unrolled by R.
    // kAfsk sums each y without rounding its products and partial sums
    // (their errors gathered in er, ei; acc_exact): the discriminator
    // divides by |y|, so at a deep fade the FIR's float32 rounding would
    // otherwise dominate disc (the plain version sums y in float64).
    float yr[R], yi[R], er[R], ei[R];
#pragma unroll
    for (int r = 0; r < R; ++r) yr[r] = yi[r] = er[r] = ei[r] = 0.f;
    for (int ph = 0; ph < D; ++ph) {
      const int n_taps = (T - ph + D - 1) / D;
      // Window base and taps of step qb, advanced by R steps per iteration;
      // inside an iteration every offset is a compile-time constant.
      const CT* xb = s_x + ph * Qs + skew<R>(jb);
      const float2* gb = s_g + ph * Tq;
      float wr[R], wi[R];
#pragma unroll
      for (int u = 0; u < R - 1; ++u) {
        const float2 v = Cplx<Tin>::widen(xb[skew<R>(u)]);
        wr[u] = v.x;
        wi[u] = v.y;
      }
      auto step = [&](int u) {
        const float2 v = Cplx<Tin>::widen(xb[skew<R>(u + R - 1)]);
        wr[(u + R - 1) % R] = v.x;
        wi[(u + R - 1) % R] = v.y;
        const float2 g = gb[u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int w = (u + r) % R;
          if constexpr (MODE == kAfsk) {
            acc_exact(yr[r], er[r], g.x, wr[w]);
            acc_exact(yr[r], er[r], -g.y, wi[w]);
            acc_exact(yi[r], ei[r], g.x, wi[w]);
            acc_exact(yi[r], ei[r], g.y, wr[w]);
          } else {
            yr[r] = fmaf(g.x, wr[w], yr[r]);
            yr[r] = fmaf(-g.y, wi[w], yr[r]);
            yi[r] = fmaf(g.x, wi[w], yi[r]);
            yi[r] = fmaf(g.y, wr[w], yi[r]);
          }
        }
      };
      int qb = 0;
      for (; qb + R <= n_taps; qb += R) {
#pragma unroll
        for (int u = 0; u < R; ++u) step(u);
        xb += skew<R>(R);
        gb += R;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (qb + u < n_taps) step(u);
      }
    }

    if constexpr (MODE == kAfsk) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        yr[r] = __fadd_rn(yr[r], er[r]);
        yi[r] = __fadd_rn(yi[r], ei[r]);
      }
    }

    if constexpr (MODE != kFm && MODE != kAfsk) {
      // Per-output epilogues: no state crosses outputs.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (jb + r < nv) {
          const long long j = j0 + jb + r;
          if constexpr (MODE == kFir) {
            orow[j] = yr[r];
            p.out_i[c * n_out + j] = yi[r];
          } else if constexpr (MODE == kAm) {
            orow[j] = p.gain * sqrtf(yr[r] * yr[r] + yi[r] * yi[r]);
          } else {
            orow[j] = p.gain * usb_sig(yr[r], yi[r], ph_r, ph_i,
                                       p.ramp_r[j], p.ramp_i[j]);
          }
        }
      }
      __syncthreads();  // every read of s_x is done
      continue;  // the rest of the loop is modes kFm's and kAfsk's
    }

    // Discriminator over the thread's outputs; y[jb - 1] comes from the
    // previous lane, the previous warp or the previous segment.
    if (lane == 31) {
      s_wy[2 * warp] = yr[R - 1];
      s_wy[2 * warp + 1] = yi[R - 1];
    }
    __syncthreads();
    float pr = __shfl_up_sync(0xffffffffu, yr[R - 1], 1);
    float pi = __shfl_up_sync(0xffffffffu, yi[R - 1], 1);
    if (lane == 0) {
      pr = warp == 0 ? s_state[0] : s_wy[2 * warp - 2];
      pi = warp == 0 ? s_state[1] : s_wy[2 * warp - 1];
    }
    float loc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      loc[r] = MODE == kAfsk && kAfskKoDisc
                   ? yr[r]
                   : fm_audio(yr[r], yi[r], pr, pi, p);
      pr = yr[r];
      pi = yi[r];
    }

    if constexpr (MODE == kAfsk && !kAfskKoTone) {
      // Tone products of this thread's outputs into the history, then each
      // output's window sum over the L products ending at it.
      int tix = (int)((*p.n0 + j0 + jb) % ell);
      float um_x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        um_x[r] = loc[r] * p.tpl[0][tix];
        if (jb + r < nv) {
          const float a = loc[r];
          s_u[skew<R>(ell - 1 + jb + r)] =
              make_float4(a * p.tpl[0][tix], a * p.tpl[1][tix],
                          a * p.tpl[2][tix], a * p.tpl[3][tix]);
        }
        tix = tix + 1 == ell ? 0 : tix + 1;
      }
      __syncthreads();
      if constexpr (kAfskKoSum) {
#pragma unroll
        for (int r = 0; r < R; ++r) loc[r] = um_x[r];
      } else {
      float4 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      // Output r sums history slots jb + r .. jb + r + L - 1.
      const float4* hb = s_u + skew<R>(jb);
      for (int q = 0; q < ell + R - 1; ++q) {
        const float4 v = hb[skew<R>(q)];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (q >= r && q < r + ell) {
            acc[r].x += v.x;
            acc[r].y += v.y;
            acc[r].z += v.z;
            acc[r].w += v.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        loc[r] = (acc[r].x * acc[r].x + acc[r].y * acc[r].y) -
                 (acc[r].z * acc[r].z + acc[r].w * acc[r].w);
      }
      }
    }

    if (p.deemph) {  // uniform across the block: the barriers are safe
      deemph.run(loc, s_wtot, s_wpre, s_state + 2, lane, warp);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (jb + r < nv && j0 + jb + r >= j_begin) orow[j0 + jb + r] = loc[r];
      if (p.ends && jb + r == nv - 1 && j0 + nv == j_end) {
        p.ends[blockIdx.x] = loc[r];
      }
    }
    __syncthreads();  // every read of s_x, s_wy, s_state and s_u is done
    if constexpr (MODE == kAfsk && !kAfskKoTone) {
      // The last L-1 products move to the front of the history; after the
      // block's last segment they are the carry.
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < ell - 1) h = s_u[skew<R>(nv + tid)];
      __syncthreads();
      if (tid < ell - 1) {
        s_u[skew<R>(tid)] = h;
        if (k == p.K - 1 && j0 + nv == j_end) {
          const long long o = c * (ell - 1) + tid;
          p.u_out[0][o] = h.x;
          p.u_out[1][o] = h.y;
          p.u_out[2][o] = h.z;
          p.u_out[3][o] = h.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (jb + r == nv - 1) {
        s_state[0] = yr[r];
        s_state[1] = yi[r];
      }
    }
  }
  if constexpr (MODE == kFm || MODE == kAfsk) {
    __syncthreads();
    if (tid == 0 && k == p.K - 1) {
      p.ylast_r[c] = s_state[0];
      p.ylast_i[c] = s_state[1];
    }
  }
}

// One thread per channel: turn the chunk-end values, computed from state 0
// for every chunk but the first, into the true state entering each chunk:
// S_in[k] = a^len[k-1] * S_in[k-1] + end[k-1], written over ends[k].
__global__ void deemph_chunk_scan(const Params p, long long C) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long n_out = p.n_out;
  float* e = p.ends + c * p.K;
  float S = e[0];
  for (int k = 1; k < p.K; ++k) {
    const long long len = min(n_out, (k + 1) * p.chunk) - k * p.chunk;
    const float E = e[k];
    e[k] = S;
    S = fmaf(powf(p.a, (float)len), S, E);
  }
}

// One block per chunk k >= 1: out[j] += a^(j - j_begin + 1) * S_in[k], up to
// where the power underflows to 0 (a^n falls below float32's range after a
// few thousand outputs at the usual time constants).
__global__ void deemph_chunk_fixup(const Params p) {
  const long long c = blockIdx.x / (p.K - 1);
  const int k = 1 + blockIdx.x % (p.K - 1);
  const long long n_out = p.n_out;
  const long long j0 = k * p.chunk;
  const long long len = min(n_out, j0 + p.chunk) - j0;
  const float S = p.ends[c * p.K + k];
  float* o = p.out + c * n_out + j0;
  for (long long n = threadIdx.x; n < len; n += blockDim.x) {
    const float f = powf(p.a, (float)(n + 1));
    if (f == 0.f) break;
    o[n] = fmaf(f, S, o[n]);
  }
}

// Picks the largest R whose segment fits in shared memory, then either
// reports how many blocks of that kernel an SM holds (per_sm != nullptr) or
// launches the kernel.
template <int MODE, typename Tin, int R>
int dispatch(const Params& p, long long C, cudaStream_t stream, int smem_max,
             int* per_sm) {
  constexpr int N = kThreads * R;
  Params q = p;
  q.Q = N + (p.T - 1) / p.D;
  const size_t bytes =
      smem_bytes<Tin, R>(p.T, p.D, q.Q, MODE == kAfsk ? p.L : 0);
  if (bytes > (size_t)smem_max) {
    if constexpr (R > 1) {
      return dispatch<MODE, Tin, R / 2>(p, C, stream, smem_max, per_sm);
    } else {
      return -1;
    }
  }
  auto kernel = fir_fm_exact_kernel<MODE, Tin, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kThreads, bytes);
  }
  kernel<<<(unsigned)(C * p.K), kThreads, bytes, stream>>>(q);
  return (int)cudaGetLastError();
}

template <int MODE>
int staged(const Params& p, long long C, int bf16, cudaStream_t stream,
           int smem_max, int* per_sm) {
  return bf16 ? dispatch<MODE, __nv_bfloat16, 4>(p, C, stream, smem_max,
                                                 per_sm)
              : dispatch<MODE, float, 4>(p, C, stream, smem_max, per_sm);
}

int staged_mode(int mode, const Params& p, long long C, int bf16,
                cudaStream_t stream, int smem_max, int* per_sm) {
  switch (mode) {
    case kFm: return staged<kFm>(p, C, bf16, stream, smem_max, per_sm);
    case kFir: return staged<kFir>(p, C, bf16, stream, smem_max, per_sm);
    case kAm: return staged<kAm>(p, C, bf16, stream, smem_max, per_sm);
    case kUsb: return staged<kUsb>(p, C, bf16, stream, smem_max, per_sm);
    case kAfsk: return staged<kAfsk>(p, C, bf16, stream, smem_max, per_sm);
  }
  return -1;
}

int device_limits(int* smem_max, int* smem_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return (int)e;
}

constexpr long long kMinChunk = 4096;  // staged: outputs per chunk, at least

bool bad_shape(long long C, long long n_out, int T, int D) {
  return C <= 0 || T < 1 || D < 1 || n_out < 1;
}

// Whether K chunks of ceil(n_out/K) outputs leave none empty.
bool bad_chunks(long long n_out, long long C, int K) {
  return K < 1 || K > n_out || C * K > 0x7fffffffLL ||
         (K - 1) * ((n_out + K - 1) / K) >= n_out;
}

// Whether a window form reads outside what it has: before the tail, or past
// the block further than `wrap` (0 <= wrap <= B) maps back into it.
bool bad_window(long long B, long long s0, long long n_out, int T, int D,
                long long wrap) {
  const long long last = s0 + (n_out - 1) * D + T - 1;  // last sample read
  return B < 1 || s0 < 1 - T || wrap < 0 || wrap > B || last >= B + wrap;
}

// Whether the IIR arguments are missing what mode kFm's de-emphasis (ends
// when K > 1) or the AGC of modes kAm and kUsb needs.
bool bad_iir(int mode, int iir, long long n_out, long long C, int K,
             int K_agc, const float* s_in, const float* s_out,
             const float* ends) {
  if (!iir) return false;
  if (mode == kFm) return !s_in || (K > 1 && !ends);
  if (mode == kAm || mode == kUsb) {
    return !s_in || !s_out || !ends || bad_chunks(n_out, C, K_agc);
  }
  return true;
}

// The kernel that runs a launch, by shape alone.  cut_mode is the mode
// whose cut of the tensor-core kernel the entry takes (K1 its own mode, K5
// kFir's, K6 kFm's for both its modes kFm and kAm): strides in that cut
// (tc_stride) take it where its plan fits in shared memory (kAfsk's with
// its window L); every other launch takes the staged kernel up to
// staged_max_d and the warp kernel above.
int route_of(int mode, int cut_mode, int T, int D, int L, int bf16, int fast,
             int smem_max, int smem_sm) {
  if (tc_stride(cut_mode, bf16, D) &&
      tc_fits(T, D, mode == kAfsk ? L : 0, bf16, fast, smem_max, smem_sm)) {
    return kRouteTc;
  }
  return D > staged_max_d(mode) ? kRouteWarp : kRouteStaged;
}

// Launches the FIR kernel of the shape's route for one mode.
int launch(int mode, int cut_mode, const Params& p, long long C, int bf16,
           int fast, cudaStream_t stream, int smem_max, int smem_sm) {
  switch (route_of(mode, cut_mode, p.T, p.D, p.L, bf16, fast, smem_max,
                   smem_sm)) {
    case kRouteTc:
      return tc_launch(mode, p, C, bf16, fast, stream, smem_max, smem_sm);
    case kRouteWarp:
      return warp_launch(mode, p, C, bf16, stream, smem_max);
  }
  return staged_mode(mode, p, C, bf16, stream, smem_max, nullptr);
}

// One mode on one block: the FIR kernel with its epilogue, then mode kFm's
// de-emphasis across chunks, or the AGC of modes kAm and kUsb (lam = a, b)
// from s_in into s_out.  p holds the operands and the window form; cut_mode
// and fast are route_of's.
int run(int mode, int cut_mode, Params p, long long C, int K, int K_agc,
        float gain, const float* s_in, float* s_out, float* ends, double a,
        double b, int iir, int fast, int bf16, void* stream) {
  int smem_max = 0, smem_sm = 0, sms = 0;
  int e = device_limits(&smem_max, &smem_sm, &sms);
  if (e != 0) return e;
  const bool agc = iir && (mode == kAm || mode == kUsb);
  const long long n_out = p.n_out;
  p.dstate = s_in;
  p.ends = mode == kFm ? ends : nullptr;
  p.chunk = (n_out + K - 1) / K;
  p.K = K;
  p.gain = agc ? 1.f : gain;  // with the AGC the kernel writes sig
  p.a = (float)a;
  p.b = (float)b;
  p.deemph = mode == kFm && iir;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch(mode, cut_mode, p, C, bf16, fast, s, smem_max, smem_sm);
  if (e != 0 || !iir) return e;
  if (agc) {
    return agc_launch(p.out, s_in, s_out, ends, C, n_out, K_agc, a, b, gain,
                      s);
  }
  if (K == 1) return 0;
  return deemph_chunks_launch(p, C, s);
}

}  // namespace

int deemph_chunks_launch(const Params& p, long long C, cudaStream_t stream) {
  deemph_chunk_scan<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(p, C);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  deemph_chunk_fixup<<<(unsigned)(C * (p.K - 1)), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sdr

using namespace sdr;

extern "C" {

// Chunks per channel for a launch of `mode` with n_out outputs a channel:
// as many as fill the resident block slots of the card in one wave, with a
// least chunk length per route.  cut_mode and fast as for route_of;
// *route gets the route (kRouteStaged, kRouteWarp or kRouteTc).
// Returns K >= 1, -1 if the shape is outside the kernel's gate, or
// -2 - cudaError_t.
int sdr_fir_chunks(int mode, int cut_mode, long long C, long long n_out,
                   int T, int D, int L, int bf16, int fast, int* route) {
  if (bad_shape(C, n_out, T, D) || mode < kFm || mode > kAfsk ||
      cut_mode < kFm || cut_mode > kAfsk ||
      (mode == kAfsk && (L < 2 || L > kAfskMaxL))) {
    return -1;
  }
  int smem_max = 0, smem_sm = 0, sms = 0, per_sm = 0;
  int e = device_limits(&smem_max, &smem_sm, &sms);
  if (e != 0) return -2 - e;
  const int r =
      route_of(mode, cut_mode, T, D, L, bf16, fast, smem_max, smem_sm);
  if (route) *route = r;
  if (r == kRouteTc) {
    return tc_chunks(mode, C, n_out, T, D, mode == kAfsk ? L : 0, bf16, fast,
                     smem_max, smem_sm, sms);
  }
  if (r == kRouteWarp) {
    return warp_chunks(mode, C, n_out, T, D, L, bf16, smem_max, sms);
  }
  Params p{};
  p.T = T;
  p.D = D;
  p.L = L;
  e = staged_mode(mode, p, C, bf16, nullptr, smem_max, &per_sm);
  if (e != 0) return e == -1 ? -1 : -2 - e;
  const long long k = (long long)sms * per_sm / C;
  const long long most = n_out / kMinChunk;
  return fit_chunks(n_out, k < most ? k : most);
}

// Chunks per channel of the AGC passes over (C, n_out) outputs.
int sdr_agc_chunks(long long C, long long n_out) {
  int smem_max = 0, smem_sm = 0, sms = 0;
  const int e = device_limits(&smem_max, &smem_sm, &sms);
  if (e != 0) return -2 - e;
  return agc_chunks(C, n_out, sms);
}

// K1: runs one mode on one block with windows that end at x[(j+1)D-1].
// Returns 0 on success, -1 if the shape or the arguments are outside the
// kernel's gate, else a cudaError_t.  All pointers are device pointers;
// planes are row-major (C, B) and (C, T-1) of float (bf16 == 0) or
// __nv_bfloat16 (bf16 == 1); out is (C, B/D) float, out_i (kFir) too.  By
// mode:
//   kFm   prev_r/prev_i (C,) is y[-1] and ylast_r/ylast_i (C,) get y[B/D-1];
//         with iir != 0 the de-emphasis out = a*out[-1] + b*audio runs from
//         s_in (C,), with ends (C, K) scratch when K > 1;
//   every mode takes the tensor-core kernel where route_of says so, in one
//         bf16 pass when fast != 0 (set_mxu_precision('fast')), else
//         f32-accurate;
//   kUsb  ramp_r/ramp_i are (B/D,) and ph_r/ph_i point at one float each;
//   kAm, kUsb with iir != 0: the AGC with lam = a (and 1 - lam; b is not
//         read) from s_in (C,) into s_out (C,), ends (C, K_agc) scratch; out
//         then holds gain*sig/sd, else gain*sig;
//   kAfsk as kFm without de-emphasis, with afsk pointing at 13 device
//         pointers: the (L,) templates mark re/im and space re/im, the
//         template phase n0 (one int32), the carried (C, L-1) products
//         u_m re/im and u_s re/im, and their (C, L-1) exports in the same
//         order; 2 <= L <= kAfskMaxL.
int sdr_fir_exact(int mode, const void* xr, const void* xi,
                  const void* tail_r, const void* tail_i, const float* taps_r,
                  const float* taps_i, const float* prev_r,
                  const float* prev_i, const float* ramp_r,
                  const float* ramp_i, const float* ph_r, const float* ph_i,
                  float* out, float* out_i, float* ylast_r, float* ylast_i,
                  const float* s_in, float* s_out, float* ends, long long C,
                  long long B, int T, int D, int K, int K_agc, float rot_r,
                  float rot_i, float gain, double a, double b, int iir,
                  const void* const* afsk, int L, int fast, int bf16,
                  void* stream) {
  const long long n_out = D > 0 ? B / D : 0;
  const bool disc = mode == kFm || mode == kAfsk;
  bool afsk_ok = mode == kAfsk && afsk && !iir && L >= 2 && L <= kAfskMaxL;
  for (int i = 0; afsk_ok && i < 13; ++i) afsk_ok = afsk[i] != nullptr;
  if (bad_shape(C, n_out, T, D) || B % D || bad_chunks(n_out, C, K) ||
      !out || mode < kFm || mode > kAfsk ||
      (mode == kFir && (!out_i || iir)) ||
      (disc && !(prev_r && prev_i && ylast_r && ylast_i)) ||
      (mode == kAfsk && (!afsk_ok || (K > 1 && (n_out + K - 1) / K < L))) ||
      (mode == kUsb && !(ramp_r && ramp_i && ph_r && ph_i)) ||
      bad_iir(mode, iir, n_out, C, K, K_agc, s_in, s_out, ends)) {
    return -1;
  }
  Params p{};
  p.xr = xr;
  p.xi = xi;
  p.tail_r = tail_r;
  p.tail_i = tail_i;
  p.taps_r = taps_r;
  p.taps_i = taps_i;
  p.prev_r = prev_r;
  p.prev_i = prev_i;
  p.ramp_r = ramp_r;
  p.ramp_i = ramp_i;
  p.ph_r = ph_r;
  p.ph_i = ph_i;
  p.out = out;
  p.out_i = out_i;
  p.ylast_r = ylast_r;
  p.ylast_i = ylast_i;
  p.B = B;
  p.s0 = D - T;
  p.n_out = n_out;
  p.T = T;
  p.D = D;
  p.rot_r = rot_r;
  p.rot_i = rot_i;
  if (mode == kAfsk) {
    for (int i = 0; i < 4; ++i) {
      p.tpl[i] = static_cast<const float*>(afsk[i]);
      p.u_in[i] = static_cast<const float*>(afsk[5 + i]);
      p.u_out[i] = static_cast<float*>(const_cast<void*>(afsk[9 + i]));
    }
    p.n0 = static_cast<const int*>(afsk[4]);
    p.L = L;
  }
  // the AGC of K1 is lam's own: b = 1 - lam
  const bool agc = mode == kAm || mode == kUsb;
  return run(mode, mode, p, C, K, K_agc, gain, s_in, s_out, ends, a,
             agc ? 1.0 - a : b, iir, fast, bf16, stream);
}

// K5: the complex FIR alone (out, out_i: the planes of y, (C, n_out)) with
// windows from x[s0 + j*D] for j < n_out, where s0 >= 1 - T; indices
// below 0 read the (C, T-1) tail (which may be null when s0 >= 0), and
// indices n >= B read x[n - wrap], 0 <= wrap <= B (fir_common.cuh).  It
// takes the tensor-core kernel at the strides of mode kFir's cut, so that
// at K1b's window start (s0 = D - T, wrap 0) it is K1b (fast as for
// sdr_fir_exact).  Returns 0, -1 outside the gate, else a cudaError_t.
int sdr_fir_mxu(const void* xr, const void* xi, const void* tail_r,
                const void* tail_i, const float* taps_r, const float* taps_i,
                float* out, float* out_i, long long C, long long B, int T,
                int D, long long s0, long long n_out, long long wrap, int K,
                int fast, int bf16, void* stream) {
  if (bad_shape(C, n_out, T, D) || bad_chunks(n_out, C, K) || !out ||
      !out_i || bad_window(B, s0, n_out, T, D, wrap) ||
      (s0 < 0 && !(tail_r && tail_i))) {
    return -1;
  }
  Params p{};
  p.xr = xr;
  p.xi = xi;
  p.tail_r = tail_r;
  p.tail_i = tail_i;
  p.taps_r = taps_r;
  p.taps_i = taps_i;
  p.out = out;
  p.out_i = out_i;
  p.B = B;
  p.s0 = s0;
  p.n_out = n_out;
  p.wrap = wrap;
  p.T = T;
  p.D = D;
  return run(kFir, kFir, p, C, K, 0, 1.f, nullptr, nullptr, nullptr, 0.0,
             0.0, 0, fast, bf16, stream);
}

// K6: the v1 FIR with windows from x[s0 + j*D], s0 >= 0, over a block of
// whole 128-output frames (B a multiple of 128*D, n_out = B/D), the last
// frame reading past the block into the frame before it (wrap = 128*D), and
// then mode kFm (y[-1] = prev (C,), y[n_out-1] into ylast (C,); with
// iir != 0 the de-emphasis (a, b) from s_in (C,), ends (C, K) scratch when
// K > 1) or kAm (with iir != 0 the AGC sd = a*sd + b*|y| from s_in (C,), its
// last state into s_out (C,), ends (C, K_agc) scratch).  out is (C, n_out).
// Both modes take the tensor-core kernel where route_of says so (fast as
// for sdr_fir_exact).  Returns 0, -1 outside the gate, else a cudaError_t.
int sdr_fir_fm_mxu(int mode, const void* xr, const void* xi,
                   const float* taps_r, const float* taps_i,
                   const float* prev_r, const float* prev_i, float* out,
                   float* ylast_r, float* ylast_i, const float* s_in,
                   float* s_out, float* ends, long long C, long long B,
                   int T, int D, long long s0, int K, int K_agc, float rot_r,
                   float rot_i, float gain, double a, double b, int iir,
                   int fast, int bf16, void* stream) {
  const long long sd = 128LL * D;
  const long long n_out = D > 0 ? B / D : 0;
  if (bad_shape(C, n_out, T, D) || (mode != kFm && mode != kAm) ||
      B % sd || s0 < 0 || bad_window(B, s0, n_out, T, D, sd) ||
      bad_chunks(n_out, C, K) || !out ||
      (mode == kFm && !(prev_r && prev_i && ylast_r && ylast_i)) ||
      bad_iir(mode, iir, n_out, C, K, K_agc, s_in, s_out, ends)) {
    return -1;
  }
  Params p{};
  p.xr = xr;
  p.xi = xi;
  p.taps_r = taps_r;
  p.taps_i = taps_i;
  p.prev_r = prev_r;
  p.prev_i = prev_i;
  p.out = out;
  p.ylast_r = ylast_r;
  p.ylast_i = ylast_i;
  p.B = B;
  p.s0 = s0;
  p.n_out = n_out;
  p.wrap = sd;
  p.T = T;
  p.D = D;
  p.rot_r = rot_r;
  p.rot_i = rot_i;
  return run(mode, kFm, p, C, K, K_agc, gain, s_in, s_out, ends, a, b, iir,
             fast, bf16, stream);
}

const char* sdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
