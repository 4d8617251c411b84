// Warp-per-output variant of the fused decimating FIR + demodulator, for
// strides above staged_max_d (all modes of fir_common.cuh).  It replaces the
// same TPU kernel as fir_fm_exact.cu (pallas_fir_mxu.py::_kernel_fm2) at the
// rx app's large strides (AM 40 and 100, NFM 100, USB/LSB 80 and 200;
// T = order + D - 1 = 71..263 taps).
//
// Why a second kernel: the staged kernel holds D polyphase rows of
// 256*R + (T-1)/D samples in shared memory, about 411 KB at D = 200 even at
// R = 1, over the 227 KB a block may have.  At these strides each input
// sample feeds only ceil(T/D) <= 2 outputs, so the staged kernel's reuse
// buys little, and the pass has few FMAs (~4*T/D per input sample) for the
// 8 or 4 bytes it reads.
//
// Design:
// * The taps live in shared memory (8*T bytes).  Each warp owns one chunk
//   of consecutive outputs of one channel and walks it in order, U outputs
//   at a time: it stages the union of their windows, (U-1)*D + T <= W
//   samples with W = max(512, T), into its own shared-memory buffer with
//   coalesced loads, kLoads in flight per plane and lane, then reduces each
//   output from the buffer: the lanes split the T taps (tap i on lane
//   i % 32) and five xor-shuffles give every lane the sum.  Staging loads
//   each sample once where one window at a time loaded every overlap again,
//   as whole 128-byte lines, and waited on each window's loads: on an H100
//   80GB HBM3 at 700 W the AM bank (D = 40) went from 7.95 to 5.36 ms
//   (f32) and the USB bank (D = 80) from 6.16 to 4.61 ms.
// * Walking in order keeps the sequential state in registers: y[j-1] for
//   the discriminator (a later chunk starts one output early to seed it),
//   and the de-emphasis state, which starts from 0 in every chunk but the
//   first and is fixed up across chunks as in fir_fm_exact.cu.
// * kAfsk: each warp keeps its last kAfskMaxL tone products in a ring in
//   shared memory (16 B each); lane 0 writes each output's products, the
//   lanes split the L products of its window (product i on lane i % 32, in
//   order) and five xor-shuffles per plane give the sums.  A later chunk
//   starts L outputs early to fill the ring (the first of them has no true
//   y[j-1] and reaches no written output).
// * The window start is the caller's (fir_common.cuh: K1, or K5/K6's any
//   offset); a span inside the block loads x directly, one at its edges
//   (the tail, the clamped last frame of K5/K6) through sample_at.
// * Outputs are gathered one per lane and stored 32 at a time, so a warp
//   writes whole 128-byte lines.
// * K chunks per channel, K from the occupancy API so that all C*K warps
//   are resident at once, each chunk at least kMinWarpChunk outputs.
// * Gate: the taps and eight staging buffers in shared memory,
//   8*T + 8*W*itemsize*2 bytes, so T <= 3,228 with float32 planes and
//   T <= 5,811 with bfloat16 ones.

#include "fir_common.cuh"

namespace sdr {
namespace {

constexpr long long kMinWarpChunk = 64;
constexpr int kLoads = 8;   // staging loads in flight per plane and lane
constexpr int kSpan = 512;  // samples staged per warp, at least T

// Shared memory: kAfsk's per-warp rings of tone products (16-byte aligned
// at the base), the taps, then each warp's staging buffer of max(kSpan, T)
// complex samples of `item` bytes.
__host__ __device__ __forceinline__ size_t ring_bytes(int mode) {
  return mode == kAfsk ? (size_t)kWarps * kAfskMaxL * 16 : 0;
}

size_t warp_smem_bytes(int mode, int T, size_t item) {
  const size_t span = T > kSpan ? T : kSpan;
  return ring_bytes(mode) + 8 * (size_t)T + kWarps * span * item;
}

template <int MODE, typename Tin>
__global__ void __launch_bounds__(kThreads)
fir_warp_kernel(const Params p, long long C) {
  using CT = typename Cplx<Tin>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, D = p.D, W = p.Q;  // W: samples staged per warp
  const int L = MODE == kAfsk ? p.L : 0;
  unsigned char* base = smem + ring_bytes(MODE);
  float2* s_g = reinterpret_cast<float2*>(base);
  for (int i = threadIdx.x; i < T; i += kThreads) {
    s_g[i] = make_float2(p.taps_r[i], p.taps_i[i]);
  }
  __syncthreads();  // the only block barrier: warps leave independently below

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  CT* buf = reinterpret_cast<CT*>(base + 8 * (size_t)T) + (size_t)warp * W;
  float4* ring = reinterpret_cast<float4*>(smem) + warp * kAfskMaxL;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= C * p.K) return;
  const long long c = w / p.K;
  const int k = (int)(w % p.K);
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
  const int U = (W - T) / D + 1;  // outputs per staged span

  float pr = 0.f, pi = 0.f, st = 0.f;  // kFm: y[j-1], de-emphasis state
  float ph_r = 0.f, ph_i = 0.f;        // kUsb: the block's unit phasor
  if constexpr (MODE == kFm || MODE == kAfsk) {
    if (k == 0) {
      pr = p.prev_r[c];
      pi = p.prev_i[c];
      st = p.deemph ? p.dstate[c] : 0.f;
    }
  }
  int tix = 0;  // kAfsk: the template index of the next output
  if constexpr (MODE == kAfsk) {
    // The first chunk's ring starts with the carried products at slots
    // -(L-1)..-1 (mod kAfskMaxL).
    for (int i = lane; i < L - 1 && k == 0; i += 32) {
      const long long o = c * (L - 1) + i;
      ring[(i - (L - 1)) & (kAfskMaxL - 1)] = make_float4(
          p.u_in[0][o], p.u_in[1][o], p.u_in[2][o], p.u_in[3][o]);
    }
  }
  if constexpr (MODE == kUsb) {
    ph_r = p.ph_r[0];
    ph_i = p.ph_i[0];
  }
  float* orow = p.out + c * n_out;
  float* oirow = MODE == kFir ? p.out_i + c * n_out : nullptr;
  float v0 = 0.f, v1 = 0.f;  // this lane's gathered output (kFir: re, im)
  // A later chunk of mode kFm starts one output early: y[j_begin - 1]
  // seeds the discriminator and is not written; one of mode kAfsk starts L
  // outputs early to fill its ring.
  const long long j_first = k == 0             ? j_begin
                            : MODE == kFm      ? j_begin - 1
                            : MODE == kAfsk    ? j_begin - L
                                               : j_begin;
  if constexpr (MODE == kAfsk) tix = (int)((*p.n0 + j_first) % L);
  for (long long j0 = j_first; j0 < j_end; j0 += U) {
    const int nu = (int)min((long long)U, j_end - j0);
    const int span = (nu - 1) * D + T;
    const long long w0 = j0 * D + p.s0;
    // Stage samples [w0, w0 + span) of this warp's next nu windows, with
    // kLoads loads in flight per plane and lane.  Negative indices are the
    // tail (sample_at).
    __syncwarp();  // the previous span's reads are done
    const bool inner = inner_run(w0, span, p);
    for (int m0 = 0; m0 < span; m0 += 32 * kLoads) {
      Tin vr[kLoads], vi[kLoads];
      auto run = [&](auto in) {
        using In = decltype(in);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int m = m0 + u * 32 + lane;
          if (m < span) {
            vr[u] = sample<In>(xr, tr, w0 + m, p);
            vi[u] = sample<In>(xi, ti, w0 + m, p);
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
        const int m = m0 + u * 32 + lane;
        if (m < span) buf[m] = Cplx<Tin>::make(vr[u], vi[u]);
      }
    }
    __syncwarp();
    for (int u = 0; u < nu; ++u) {
      const long long j = j0 + u;
      // y[j] on every lane: the lanes split the taps, five shuffles sum.
      const CT* xw = buf + u * D;
      float yr = 0.f, yi = 0.f;
#pragma unroll 4
      for (int i = lane; i < T; i += 32) {
        const float2 v = Cplx<Tin>::widen(xw[i]);
        const float2 g = s_g[i];
        yr = fmaf(g.x, v.x, yr);
        yr = fmaf(-g.y, v.y, yr);
        yi = fmaf(g.x, v.y, yi);
        yi = fmaf(g.y, v.x, yi);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        yr += __shfl_xor_sync(0xffffffffu, yr, off);
        yi += __shfl_xor_sync(0xffffffffu, yi, off);
      }
      float u0 = yr, u1 = yi;
      if constexpr (MODE == kFm) {
        if (j < j_begin) {  // the seed of a later chunk
          pr = yr;
          pi = yi;
          continue;
        }
        const float zr = yr * pr + yi * pi;
        const float zi = yi * pr - yr * pi;
        const float zr2 = zr * p.rot_r - zi * p.rot_i;
        const float zi2 = zr * p.rot_i + zi * p.rot_r;
        u0 = p.gain * atan2_poly(zi2, zr2);
        if (p.deemph) {
          st = fmaf(p.a, st, p.b * u0);
          u0 = st;
        }
        pr = yr;
        pi = yi;
      } else if constexpr (MODE == kAfsk) {
        const float zr = yr * pr + yi * pi;
        const float zi = yi * pr - yr * pi;
        const float a = p.gain * atan2_poly(zr * p.rot_i + zi * p.rot_r,
                                            zr * p.rot_r - zi * p.rot_i);
        pr = yr;
        pi = yi;
        __syncwarp();  // every lane's reads of this ring slot are done
        if (lane == 0) {
          ring[j & (kAfskMaxL - 1)] =
              make_float4(a * p.tpl[0][tix], a * p.tpl[1][tix],
                          a * p.tpl[2][tix], a * p.tpl[3][tix]);
        }
        tix = tix + 1 == L ? 0 : tix + 1;
        __syncwarp();
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = lane; i < L; i += 32) {
          const float4 v = ring[(j - (L - 1) + i) & (kAfskMaxL - 1)];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
          s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
          s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
          s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
        }
        if (j < j_begin) continue;  // fills the ring only
        u0 = (s.x * s.x + s.y * s.y) - (s.z * s.z + s.w * s.w);
      } else if constexpr (MODE == kAm) {
        u0 = p.gain * sqrtf(yr * yr + yi * yi);
      } else if constexpr (MODE == kUsb) {
        u0 = p.gain * usb_sig(yr, yi, ph_r, ph_i, p.ramp_r[j], p.ramp_i[j]);
      }
      const int slot = (int)((j - j_begin) & 31);
      if (lane == slot) {
        v0 = u0;
        v1 = u1;
      }
      if (slot == 31 || j == j_end - 1) {
        const long long jo = j - slot + lane;
        if (lane <= slot) {
          orow[jo] = v0;
          if constexpr (MODE == kFir) oirow[jo] = v1;
        }
      }
    }
  }
  if constexpr (MODE == kFm || MODE == kAfsk) {
    if (lane == 0) {
      if (p.ends) p.ends[w] = st;
      if (k == p.K - 1) {
        p.ylast_r[c] = pr;
        p.ylast_i[c] = pi;
      }
    }
  }
  if constexpr (MODE == kAfsk) {
    if (k == p.K - 1) {  // the last L-1 products are the carry
      __syncwarp();
      for (int i = lane; i < L - 1; i += 32) {
        const float4 v = ring[(j_end - (L - 1) + i) & (kAfskMaxL - 1)];
        const long long o = c * (L - 1) + i;
        p.u_out[0][o] = v.x;
        p.u_out[1][o] = v.y;
        p.u_out[2][o] = v.z;
        p.u_out[3][o] = v.w;
      }
    }
  }
}

template <int MODE, typename Tin>
int warp_run(const Params& p, long long C, cudaStream_t stream,
             int* per_sm) {
  auto kernel = fir_warp_kernel<MODE, Tin>;
  Params q = p;
  q.Q = p.T > kSpan ? p.T : kSpan;
  const size_t bytes =
      warp_smem_bytes(MODE, p.T, sizeof(typename Cplx<Tin>::type));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kThreads, bytes);
  }
  const long long warps = C * p.K;
  kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, bytes,
           stream>>>(q, C);
  return (int)cudaGetLastError();
}

template <int MODE>
int warp_dtype(const Params& p, long long C, int bf16, cudaStream_t stream,
               int* per_sm) {
  return bf16 ? warp_run<MODE, __nv_bfloat16>(p, C, stream, per_sm)
              : warp_run<MODE, float>(p, C, stream, per_sm);
}

int warp_mode(int mode, const Params& p, long long C, int bf16,
              cudaStream_t stream, int* per_sm) {
  switch (mode) {
    case kFm: return warp_dtype<kFm>(p, C, bf16, stream, per_sm);
    case kFir: return warp_dtype<kFir>(p, C, bf16, stream, per_sm);
    case kAm: return warp_dtype<kAm>(p, C, bf16, stream, per_sm);
    case kUsb: return warp_dtype<kUsb>(p, C, bf16, stream, per_sm);
    case kAfsk: return warp_dtype<kAfsk>(p, C, bf16, stream, per_sm);
  }
  return -1;
}

}  // namespace

int warp_chunks(int mode, long long C, long long n_out, int T, int D, int L,
                int bf16, int smem_max, int sms) {
  if (warp_smem_bytes(mode, T, bf16 ? 4 : 8) > (size_t)smem_max) return -1;
  Params p{};
  p.T = T;
  p.D = D;
  p.L = L;
  int per_sm = 0;
  const int e = warp_mode(mode, p, C, bf16, nullptr, &per_sm);
  if (e != 0) return e == -1 ? -1 : -2 - e;
  long long k = (long long)sms * per_sm * kWarps / C;
  // kAfsk: a later chunk starts L outputs early, so chunks hold L at least
  const long long min_chunk =
      mode == kAfsk && L > kMinWarpChunk ? L : kMinWarpChunk;
  const long long most = n_out / min_chunk;
  return fit_chunks(n_out, k < most ? k : most);
}

int warp_launch(int mode, const Params& p, long long C, int bf16,
                cudaStream_t stream, int smem_max) {
  if (warp_smem_bytes(mode, p.T, bf16 ? 4 : 8) > (size_t)smem_max) return -1;
  return warp_mode(mode, p, C, bf16, stream, nullptr);
}

}  // namespace sdr
