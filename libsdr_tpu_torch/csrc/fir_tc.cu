// Tensor-core decimating complex FIR, alone or with the FM discriminator
// (+ the de-emphasis, or + the dual-tone FSK correlator), the AM envelope
// or the USB rotation: the route of K1's modes kFm (K1a, entry
// sdr_fir_exact), kFir (K1b), kAm (K1c), kUsb (K1d) and kAfsk (K1e), of
// K5 (entry sdr_fir_mxu: mode kFir from any window start, with kFir's
// cut) and of K6's kFm and kAm (entry sdr_fir_fm_mxu), at the strides of
// its cut (fir_common.cuh: tc_stride).  It computes what the staged kernel
// of fir_fm_exact.cu computes in those modes, with the same window form
// (Params: K1's start D - T with the tail, K5's any start in [1 - T, B - T]
// with the tail and a wrap of 0 or 128*D, K6's s0 >= 0 and its wrap of
// 128*D) and the same epilogues.
//
// Replaces the TPU kernels libsdr_tpu/ops/pallas_fir_mxu.py::_kernel_fm2
// (:777, modes 'fm', 'fir', 'am', 'usb' and 'afsk'), ::_kernel (:204, the
// v1 FIR) and ::_kernel_fm (:410, modes 'fm' and 'am'), and does their
// arithmetic: the FIR as block-Toeplitz frame matmuls, f32-accurate from a
// manual split into bf16 passes (_make_mm, :161):
//
//   float32 planes  x_hi*g_hi + x_hi*g_lo + x_lo*g_hi    (3 passes)
//   bfloat16 planes x*g_hi + x*g_lo                      (2 passes: x exact)
//   'fast'          x_hi*g_hi                            (1 pass)
//
// with float32 accumulators throughout.
//
// What bounds it on an H100, at the main path's shape (64 ch x 2^24, T = 67,
// D = 4): the bytes, 8 a complex input sample with float32 planes and 4/D
// of audio an output, 9.66 GB or 2.885 ms at 3.35 TB/s (bf16 planes: 1.603
// ms; kFir writes both planes of y, 8/D: 3.205 ms at the DDC bank's same
// shape).  The staged kernel spends 8T + 20-50 float32 operations an output
// on the CUDA cores, 2.2-2.3 ms at 67 TFLOP/s, so it cannot reach that
// bound; here the FIR runs on the tensor cores (bf16 at 989 TFLOP/s dense),
// about 2,200 operations an output in three passes once the Toeplitz band
// is skipped, 0.6 ms at peak, and the CUDA cores keep only the conversion
// and the epilogue.  Measured (PERF.md), it is the block's phases in series
// that hold it at ~55% of the float32 bound, not the MMAs' arithmetic.  At
// the AM bank's D = 40 (T = 71) a tile holds few outputs (shared memory
// holds each output's 40 samples twice raw and once converted), so the MMAs
// and the epilogue cost a tenth of D = 4's a sample and the copies and the
// conversion set the pace.  The USB bank's D = 80 (T = 143) is the far end
// of that: frames of one output (S*D a multiple of 8), so an n-tile's four
// output columns hold one and the band is a quarter useful, 32 (float32
// planes) or 64 (bfloat16) outputs a tile, each tile's span one bulk copy
// of ~2,600 or ~5,200 samples a plane; the MMAs stay a small share and the
// tile's fixed steps set the pace (~3.4 us a tile at either dtype; a ring
// of four raw stages measured no faster, PERF.md).
//
// Design:
// * GEMM rows are frames: S consecutive outputs of one channel.  Row f of a
//   tile is the frame's window, K = (S-1)*D + T samples padded to Kp (a
//   multiple of 16), real and imaginary planes side by side (reduction
//   depth 2*Kp).  The tap matrix is (2Kp x 2S):
//       [Wr | Wi] . [[Gr, Gi], [-Gi, Gr]],   G[k, s] = g[k - s*D]
//   with its columns interleaved (Re y, Im y) of each output, so that each
//   accumulator pair of the mma.sync m16n8k16 layout is one output.  Its
//   8-column n-tiles (4 outputs each) touch only a band of 16-row k-tiles;
//   only the band is stored and multiplied.
// * A is not materialised: the rows are overlapping windows of one span of
//   samples at a row stride of S*D, so a tile's span is converted once into
//   bf16 arrays (hi and lo for float32 planes, once a sample; bf16 planes
//   are copied) and every row is loaded with ldmatrix at its own address.
//   S*D is a multiple of 8 (16-byte rows), chosen an odd multiple of 8
//   where the stride allows it, so that the 8 rows of an ldmatrix phase
//   fall on distinct banks (S = 14 at D = 4: 112 bytes).
// * HBM stays busy: a ring of two raw stages per block, each a tile's span
//   of both planes, filled by cp.async.bulk (one copy a plane, completion on
//   an mbarrier) two tiles ahead, while the block converts, multiplies and
//   runs the epilogue of the current tile.  A block has 8 warps: all
//   convert (16-byte words shifted by the span's alignment), all run the
//   MMAs (16 frames and up to 2 n-tiles each, an accumulator per pass so
//   that one step's MMAs do not wait on each other) and all run the
//   epilogue; two blocks share an SM where they fit (the main path: 106
//   KB each), so one block's MMAs overlap the other's conversion and
//   epilogue.  Spans that reach into the tail or past the block (the first
//   tile of a channel in K1, and in K5 where its start is negative; the
//   tiles of K5 and K6 whose windows wrap) are read by the threads through
//   sample_at instead; every other tile, a later chunk's first among them
//   wherever its chunk starts, takes the bulk copies.
// * Epilogue: the accumulators go to shared memory in output order (over
//   the converted span, which the MMAs no longer read), and each thread
//   runs the staged kernel's discriminator and de-emphasis scan
//   (fir_common.cuh: fm_audio, DeemphScan) over 4 consecutive outputs, or
//   gain*|y| (kAm), or the exact NCO's rotation by a0 * ramp[j] and
//   gain*(re + im)/2 (kUsb: usb_sig; a0 read once a block, the ramp, which
//   every channel shares, in 16-byte loads that stay in L2), or takes y
//   itself (kFir: both planes, no carry), and stores them 16 bytes at a
//   time (storing from the mma.sync accumulators would scatter 8-byte
//   pairs, a lane's rows f and f + 8, across frames); the de-emphasis
//   across chunks and the AGC of kAm and kUsb (K1c, K1d, K6) are the same
//   follow-up kernels as the staged route's.  A later chunk's y[j_begin -
//   1] is recomputed in the same passes (warp_y_at<P>).
// * kAfsk (K1e): the discriminator's audio times the tone templates
//   (float4 in shared memory, the template index stepped a tile at a time)
//   gives each thread's four products of each tone; their prefix sums go
//   to shared memory over the converted span, behind the epilogue's slots,
//   with the last (L-1)/4 + 1 blocks of the tile before in front of them
//   (kept across tiles in a small history), and after a barrier each
//   thread sums its outputs' windows from the blocks' sums (afsk_sums, 13
//   float4 loads for four outputs at L = 40) and writes disc 16 bytes at a
//   time.  A later chunk starts L outputs early from y[-1] = 0 and zero
//   products, and writes none of them; the first starts from the carried
//   y[-1] and products, the last exports both.  The TPU kernel sums the
//   windows as a 0/1 band product on its matrix unit; on the tensor cores
//   (runs of 16 outputs against the band, f32-accurate in three bf16
//   parts) that measured 1.07 ms at the AX.25 bank's shape against these
//   sums' 0.82 (PERF.md), so the CUDA cores keep them.
// * The plan (S, frames a tile, buffer sizes) depends on T, D, the plane
//   dtype, the pass count and kAfsk's L only (tc_plan; kFir, kAm and kUsb
//   take kFm's, whose de-emphasis scratch is in the fixed header); where
//   none fits in shared memory, route_of sends the launch to the staged or
//   warp kernel.
//   The kernel allocates nothing and does not synchronise.

#include <stdint.h>

#include "fir_common.cuh"

namespace sdr {
namespace {

constexpr int kTcR = 4;                       // epilogue outputs a thread
constexpr int kTcSlots = kThreads * kTcR;     // epilogue outputs a tile
constexpr int kTcMaxNt = 4;                   // n-tiles a frame, at most
constexpr int kTcHeader = 128;  // mbarriers, carried state, scan scratch
constexpr long long kTcMinChunk = 4096;       // outputs per chunk, at least

// One tile's geometry and the block's shared-memory layout.
struct TcPlan {
  int S;    // outputs a frame
  int F;    // frames a tile: 64, 32 or 16
  int Kp;   // a frame's window, padded to a multiple of 16 samples
  int KT;   // Kp / 16
  int NTL;  // n-tiles a frame: ceil(S / 4)
  int KBW;  // k-tiles of the widest n-tile band
  int LA;   // samples of each converted array
  int CAP;  // samples of a raw stage buffer of one plane
  int na;   // converted arrays: re hi, im hi (+ re lo, im lo when 3 passes)
  int raw_off, a_off, b_off, bytes;
  // kAfsk (L > 0; zeros in the other modes): the correlator's blocked sums
  int L;    // the window
  int HB;   // blocks of 4 products of history before a tile: (L-1)/4 + 1
  int p_off, h_off, t_off;  // prefix sums, their history, the templates
};

// The epilogue's slot of output j: one pad slot after every 4, so that the
// lanes' reads (4 apart) spread over the banks.
__host__ __device__ __forceinline__ int tc_skew(int j) { return j + j / 4; }

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

// k-tiles [lo, hi) of the band of n-tile nt (outputs 4nt .. 4nt+3).
__host__ __device__ __forceinline__ void band(int nt, int S, int D, int T,
                                              int KT, int* lo, int* hi) {
  const int s_hi = imin(4 * nt + 3, S - 1);
  *lo = (4 * nt * D) / 16;
  *hi = imin(KT, (s_hi * D + T + 15) / 16);
}

// Bank-conflict degree of an ldmatrix phase over 8 rows `stride` bytes
// apart (a multiple of 16): the most rows on one 16-byte slot of 128.
int ldsm_ways(int stride) {
  int count[8] = {0};
  int ways = 0;
  for (int r = 0; r < 8; ++r) {
    const int slot = (int)(((long long)r * stride % 128) / 16);
    if (++count[slot] > ways) ways = count[slot];
  }
  return ways;
}

TcPlan make_plan(int T, int D, int isz, int passes, int S, int F, int L) {
  TcPlan g{};
  g.S = S;
  g.F = F;
  g.Kp = round_up((S - 1) * D + T, 16);
  g.KT = g.Kp / 16;
  g.NTL = (S + 3) / 4;
  for (int nt = 0; nt < g.NTL; ++nt) {
    int lo, hi;
    band(nt, S, D, T, g.KT, &lo, &hi);
    if (hi - lo > g.KBW) g.KBW = hi - lo;
  }
  const int per = 16 / isz;  // samples in 16 bytes
  const long long lbuf = (long long)(F * S - 1) * D + T;
  const long long la = (long long)(F - 1) * S * D + g.Kp;
  if (lbuf + 2 * per > (1 << 24) || la > (1 << 24)) {
    g.bytes = 0x7fffffff;
    return g;
  }
  g.LA = round_up((int)la, 8);
  // a raw stage holds the span and 16 bytes of alignment at each end; the
  // conversion reads 16-byte words up to 16 bytes past the converted span
  g.CAP = round_up((int)(lbuf > g.LA ? lbuf : g.LA) + 2 * per, per);
  g.na = passes == 3 ? 4 : 2;
  const long long raw = 4LL * g.CAP * isz;  // 2 stages x 2 planes
  // the converted arrays, and over them the epilogue's slots
  const long long ys = 8LL * (tc_skew(kTcSlots - 1) + 1);
  const long long arr = (long long)g.na * g.LA * 2 > ys
                            ? (long long)g.na * g.LA * 2 : ys;
  const long long taps = 2LL * g.NTL * g.KBW * 512;
  const long long a_off = kTcHeader + raw;
  long long span = arr;  // bytes over the converted arrays
  long long extra = 0;   // kAfsk's history and templates
  if (L > 0) {
    // the prefix sums of a tile's products, 4 arrays of HB + kThreads
    // float4 over the converted span behind the epilogue's slots; their
    // history, and the templates, after the taps
    g.L = L;
    g.HB = (L - 1) / 4 + 1;
    const long long p_rel = (a_off + ys + 15) / 16 * 16 - a_off;
    const long long pb = 4LL * (g.HB + kThreads) * 16;
    if (p_rel + pb > span) span = p_rel + pb;
    g.p_off = (int)(a_off + p_rel);
    extra = 4LL * g.HB * 16 + 16LL * L;
  }
  const long long b_off = a_off + (span + 15) / 16 * 16;
  const long long total = b_off + taps + extra;
  if (total > 0x7fffffffLL) {
    g.bytes = 0x7fffffff;
    return g;
  }
  g.raw_off = kTcHeader;
  g.a_off = (int)a_off;
  g.b_off = (int)b_off;
  if (L > 0) {
    g.h_off = (int)(b_off + taps);
    g.t_off = g.h_off + 4 * g.HB * 16;
  }
  g.bytes = (int)total;
  return g;
}

// The plan of a shape: frames of S <= 16 outputs with S*D a multiple of 8,
// fewest bank conflicts first and then the largest S, 64 frames a tile
// where that fits (then 32, 16); first within two blocks an SM, then
// within one.  L: kAfsk's window (its correlator's shared memory), else 0.
// False when nothing fits.
bool tc_plan(int T, int D, int L, int bf16, int fast, int smem_max,
             int smem_sm, TcPlan* out) {
  if (T < 1 || D < 1) return false;
  const int isz = bf16 ? 2 : 4;
  const int passes = fast ? 1 : (bf16 ? 2 : 3);
  int cand[16], nc = 0;
  for (int ways = 1; ways <= 8; ++ways) {
    for (int S = 4 * kTcMaxNt; S >= 1; --S) {
      if ((S * D) % 8 == 0 && ldsm_ways(2 * S * D) == ways) cand[nc++] = S;
    }
  }
  const int limits[2] = {smem_sm / 2 - 1024, smem_max};
  for (int limit : limits) {
    for (int mw = 4; mw >= 1; mw /= 2) {
      for (int i = 0; i < nc; ++i) {
        const TcPlan g = make_plan(T, D, isz, passes, cand[i], 16 * mw, L);
        if (g.bytes <= limit) {
          *out = g;
          return true;
        }
      }
    }
  }
  return false;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// d += a . b, one m16n8k16 bf16 product with float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tap blocks in shared memory: for each plane half h (0: the rows' real
// samples, 1: their imaginary ones), n-tile nt and k-tile kk of its band,
// 512 bytes [hi/lo][k 0-7 / 8-15][column n][8 k] of bf16, so that one
// ldmatrix.x4 at block + 16*lane gives the hi and lo fragments of B.
// Column n is output 4nt + n/2, its real part for even n: the entries are
// (Gr, Gi) for h = 0 and (-Gi, Gr) for h = 1, G[k, s] = g[k - s*D].
__device__ void build_taps(__nv_bfloat16* B, const TcPlan& g, const Params& p,
                           int tid) {
  const int total = 2 * g.NTL * g.KBW * 256;
  for (int idx = tid; idx < total; idx += kThreads) {
    const int kq = idx & 7, n = (idx >> 3) & 7, kh = (idx >> 6) & 1;
    const int hl = (idx >> 7) & 1, blk = idx >> 8;
    const int kb = blk % g.KBW, nt = (blk / g.KBW) % g.NTL;
    const int h = blk / (g.KBW * g.NTL);
    int lo, hi;
    band(nt, g.S, p.D, p.T, g.KT, &lo, &hi);
    const int kk = lo + kb;
    const int s = 4 * nt + n / 2;
    const int i = 16 * kk + 8 * kh + kq - s * p.D;
    float v = 0.f;
    if (kk < hi && s < g.S && i >= 0 && i < p.T) {
      const float gr = p.taps_r[i], gi = p.taps_i[i];
      v = h == 0 ? (n & 1 ? gi : gr) : (n & 1 ? gr : -gi);
    }
    const __nv_bfloat16 vh = __float2bfloat16_rn(v);
    B[idx] = hl ? __float2bfloat16_rn(v - __bfloat162float(vh)) : vh;
  }
}

// One warp's share of a tile's MMAs: 16 frames (m-tile mt) and up to 2
// n-tiles nt0, nt0 + 1 (nnt of them), over the k-tiles of their bands.
// acc[i][q] holds, per the m16n8k16 accumulator layout, pass q's sum for
// n-tile nt0 + i: (Re y, Im y) of output 4(nt0 + i) + lane%4 of frames
// 16*mt + lane/4 ([0..1]) and + 8 ([2..3]).  Each pass has its own
// accumulator, so that the MMAs of one step do not wait on each other, and
// the next step's A fragments are loaded before this step's MMAs.
template <int P>
__device__ __forceinline__ void mma_frames(float (&acc)[2][P][4],
                                           uint32_t a_sh, uint32_t b_sh,
                                           const TcPlan& g, int D, int T,
                                           int mt, int nt0, int nnt,
                                           int lane) {
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    band(nt0 + i, g.S, D, T, g.KT, &lo[i], &hi[i]);
    if (i >= nnt) lo[i] = hi[i] = 0;
  }
  const int k0 = lo[0], k1 = nnt > 1 ? max(hi[0], hi[1]) : hi[0];
  // this lane's row address (ldmatrix.x4: rows 0-15, columns 0 and 8)
  const uint32_t row =
      (uint32_t)((16 * mt + (lane & 15)) * g.S * D + 8 * (lane >> 4));
  const uint32_t plane = 2u * g.LA;  // bytes of one converted array
  auto a_at = [&](int step) {  // step = 2 kk + h
    return a_sh + (step & 1) * plane + 2u * (row + 16u * (step >> 1));
  };
  uint32_t ah[4], al[4], nh[4], nl[4];
  ldsm_x4(ah, a_at(2 * k0));
  if constexpr (P == 3) ldsm_x4(al, a_at(2 * k0) + 2 * plane);
  for (int step = 2 * k0; step < 2 * k1; ++step) {
    const int kk = step >> 1, h = step & 1;
    if (step + 1 < 2 * k1) {
      ldsm_x4(nh, a_at(step + 1));
      if constexpr (P == 3) ldsm_x4(nl, a_at(step + 1) + 2 * plane);
    }
    uint32_t b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kk >= lo[i] && kk < hi[i]) {
        const uint32_t bb =
            b_sh +
            ((uint32_t)((h * g.NTL + nt0 + i) * g.KBW + kk - lo[i]) << 9) +
            16u * lane;
        if constexpr (P == 1) {
          ldsm_x2(b[i][0], b[i][1], bb);
        } else {
          ldsm_x4(b[i], bb);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kk >= lo[i] && kk < hi[i]) {
        mma(acc[i][0], ah, b[i][0], b[i][1]);
        if constexpr (P >= 2) mma(acc[i][1], ah, b[i][2], b[i][3]);
        if constexpr (P == 3) mma(acc[i][2], al, b[i][0], b[i][1]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ah[q] = nh[q];
      if constexpr (P == 3) al[q] = nl[q];
    }
  }
}

// Converts samples [0, LA) of a tile's span (get(plane, m) for m < Ls, 0
// past it) into the bf16 arrays: re hi, im hi, and for 3 passes re lo, im lo
// (lo = bf16(x - hi)); two samples a thread and step.  The path of the
// spans that reach into the tail or past the block (sample_at).
template <int P, typename Get>
__device__ __forceinline__ void convert(__nv_bfloat16* A, int LA, int Ls,
                                        int tid, Get get) {
  uint32_t* a32 = reinterpret_cast<uint32_t*>(A);
  const int la2 = LA / 2;
  for (int q = tid; q < la2; q += kThreads) {
    const int m = 2 * q;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const float2 v = make_float2(m < Ls ? get(pl, m) : 0.f,
                                   m + 1 < Ls ? get(pl, m + 1) : 0.f);
      const __nv_bfloat162 h = __float22bfloat162_rn(v);
      a32[pl * la2 + q] = bits(h);
      if constexpr (P == 3) {
        const float2 hf = __bfloat1622float2(h);
        a32[(2 + pl) * la2 + q] = bits(
            __float22bfloat162_rn(make_float2(v.x - hf.x, v.y - hf.y)));
      }
    }
  }
}

// The same from a raw stage (sample m of a plane at raw[off + m], the
// buffer 16-byte aligned): 16-byte words shifted into place.  Float32
// planes: 4 samples a thread and step, their hi (and lo) as 8 bytes, the
// loop specialised by the offset (OFF) and two steps in flight; bfloat16
// planes: 8 samples, copied as 16 bytes (x is its own hi).
template <int P, int OFF>
__device__ __forceinline__ void convert_plane(__nv_bfloat16* hi,
                                              __nv_bfloat16* lo, int LA,
                                              int Ls, const float* raw,
                                              int tid) {
  const int la4 = LA / 4;
  const float4* rb = reinterpret_cast<const float4*>(raw);
  auto one = [&](int q, const float4& a, const float4& b) {
    const int m = 4 * q;
    float v[4];
    v[0] = OFF == 0 ? a.x : OFF == 1 ? a.y : OFF == 2 ? a.z : a.w;
    v[1] = OFF == 0 ? a.y : OFF == 1 ? a.z : OFF == 2 ? a.w : b.x;
    v[2] = OFF == 0 ? a.z : OFF == 1 ? a.w : OFF == 2 ? b.x : b.y;
    v[3] = OFF == 0 ? a.w : OFF == 1 ? b.x : OFF == 2 ? b.y : b.z;
    if (m + 3 >= Ls) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = m + i < Ls ? v[i] : 0.f;
    }
    const __nv_bfloat162 h0 = __float22bfloat162_rn(make_float2(v[0], v[1]));
    const __nv_bfloat162 h1 = __float22bfloat162_rn(make_float2(v[2], v[3]));
    *reinterpret_cast<uint2*>(hi + m) = make_uint2(bits(h0), bits(h1));
    if constexpr (P == 3) {
      const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
      *reinterpret_cast<uint2*>(lo + m) = make_uint2(
          bits(__float22bfloat162_rn(make_float2(v[0] - f0.x, v[1] - f0.y))),
          bits(__float22bfloat162_rn(make_float2(v[2] - f1.x, v[3] - f1.y))));
    }
  };
  int q = tid;
  for (; q + kThreads < la4; q += 2 * kThreads) {
    const float4 a0 = rb[q], b0 = rb[q + 1];
    const float4 a1 = rb[q + kThreads], b1 = rb[q + kThreads + 1];
    one(q, a0, b0);
    one(q + kThreads, a1, b1);
  }
  if (q < la4) one(q, rb[q], rb[q + 1]);
}

template <int P>
__device__ __forceinline__ void convert_raw(__nv_bfloat16* A, int LA, int Ls,
                                            const float* raw_r,
                                            const float* raw_i, int off_r,
                                            int off_i, int tid) {
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    __nv_bfloat16* hi = A + (size_t)pl * LA;
    __nv_bfloat16* lo = A + (size_t)(2 + pl) * LA;
    const float* raw = pl ? raw_i : raw_r;
    switch (pl ? off_i : off_r) {
      case 0: convert_plane<P, 0>(hi, lo, LA, Ls, raw, tid); break;
      case 1: convert_plane<P, 1>(hi, lo, LA, Ls, raw, tid); break;
      case 2: convert_plane<P, 2>(hi, lo, LA, Ls, raw, tid); break;
      default: convert_plane<P, 3>(hi, lo, LA, Ls, raw, tid); break;
    }
  }
}

// Words w[k .. k+3] of the 8 words (a, b), shifted right by sh bits more.
__device__ __forceinline__ uint4 shift_words(const uint4& a, const uint4& b,
                                             int k, int sh) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    r[i] = k == 0 ? w[i] : k == 1 ? w[i + 1] : k == 2 ? w[i + 2] : w[i + 3];
  }
  return make_uint4(__funnelshift_r(r[0], r[1], sh),
                    __funnelshift_r(r[1], r[2], sh),
                    __funnelshift_r(r[2], r[3], sh),
                    __funnelshift_r(r[3], r[4], sh));
}

template <int P>
__device__ __forceinline__ void convert_raw(__nv_bfloat16* A, int LA, int Ls,
                                            const __nv_bfloat16* raw_r,
                                            const __nv_bfloat16* raw_i,
                                            int off_r, int off_i, int tid) {
  const int la8 = LA / 8;
  for (int q = tid; q < la8; q += kThreads) {
    const int m = 8 * q;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const uint4* rb = reinterpret_cast<const uint4*>(pl ? raw_i : raw_r) + q;
      const int off = pl ? off_i : off_r;  // samples: 2 bytes each
      uint4 r = shift_words(rb[0], rb[1], off >> 1, (off & 1) * 16);
      if (m + 7 >= Ls) {
        uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (m + i >= Ls) w[i / 2] &= (i & 1) ? 0x0000ffffu : 0xffff0000u;
        }
        r = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(A + (size_t)pl * LA + m) = r;
    }
  }
}

// A thread's kTcR outputs v[0 .. n-1] (n may be <= 0 or past kTcR) to o:
// one 16-byte store where o is aligned and all four are valid.
__device__ __forceinline__ void store4(float* o, const float (&v)[kTcR],
                                       int n) {
  if (n >= kTcR && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int r = 0; r < kTcR; ++r) {
    if (r < n) o[r] = v[r];
  }
}

// v[0 .. 3] = i[0 .. n-1], zeros from n on (n may be <= 0): one 16-byte
// load where i is aligned and all four are in range.
__device__ __forceinline__ void load4(const float* i, float (&v)[kTcR],
                                      int n) {
  if (n >= kTcR && (reinterpret_cast<uintptr_t>(i) & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(i));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int r = 0; r < kTcR; ++r) v[r] = r < n ? i[r] : 0.f;
}

// v[0 .. 3], the outputs j .. j + 3 of a tile starting at output j0, to
// orow: those with j + r < nv and j0 + j + r >= j_lo (a later chunk's
// outputs before its own start are not written).
__device__ __forceinline__ void store4_at(float* orow, long long j0, int j,
                                          int nv, long long j_lo,
                                          const float (&v)[kTcR]) {
  const long long jg = j0 + j;
  if (jg >= j_lo) {
    store4(orow + jg, v, nv - j);
    return;
  }
#pragma unroll
  for (int r = 0; r < kTcR; ++r) {
    if (j + r < nv && jg + r >= j_lo) orow[jg + r] = v[r];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// kAfsk's prefix sums of a tile's products, array r: element HB + t holds
// u[4t] + .. + u[4t + r] of the tile's block t of 4 outputs (thread t's),
// float4 over the 4 planes (u_m re, u_m im, u_s re, u_s im); elements
// 0 .. HB - 1 the last HB blocks before the tile.
__device__ __forceinline__ float4* prefix(const TcPlan& g,
                                          unsigned char* smem, int r) {
  return reinterpret_cast<float4*>(smem + g.p_off) + r * (g.HB + kThreads);
}

// kAfsk's shared memory, once a block: the templates as float4 (mark re,
// mark im, space re, space im) and the history of prefix sums (as prefix()
// holds them, array after array): the blocks of the L - 1 carried products
// (zeros before them) in the first chunk, zeros in a later one.  When the
// block has fewer than L - 1 outputs, the first of the exported products
// are carried ones (the last chunk's block copies them).
__device__ void afsk_setup(const TcPlan& g, const Params& p,
                           unsigned char* smem, long long c, int k,
                           long long n_out, int tid) {
  const int L = g.L, HB = g.HB;
  float4* tpl = reinterpret_cast<float4*>(smem + g.t_off);
  for (int i = tid; i < L; i += kThreads) {
    tpl[i] = make_float4(p.tpl[0][i], p.tpl[1][i], p.tpl[2][i], p.tpl[3][i]);
  }
  float4* hist = reinterpret_cast<float4*>(smem + g.h_off);
  const long long o = c * (L - 1);
  for (int b = tid; b < HB; b += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < 4; ++r) {
      const int e = 4 * (b - HB) + r + (L - 1);  // index of the carried
      if (k == 0 && e >= 0) {
        acc = add4(acc, make_float4(p.u_in[0][o + e], p.u_in[1][o + e],
                                    p.u_in[2][o + e], p.u_in[3][o + e]));
      }
      hist[r * HB + b] = acc;
    }
  }
  if (k == p.K - 1 && n_out < L - 1) {
    for (int idx = tid; idx < 4 * (L - 1 - n_out); idx += kThreads) {
      const int q = idx / (L - 1 - n_out), e = idx % (L - 1 - n_out);
      p.u_out[q][o + e] = p.u_in[q][o + e + n_out];
    }
  }
}

// kAfsk's tone products of this thread's outputs jb .. jb + 3 of the tile
// (audio a[r], template index tix of output jb): their prefix sums into
// prefix(), and those among the channel's last L - 1 outputs into the
// carry export.  Returns u_m's real parts in a (the sums' knockout).
__device__ __forceinline__ void afsk_products(const TcPlan& g,
                                              const Params& p,
                                              unsigned char* smem,
                                              float (&a)[kTcR], int tix,
                                              int jb, int nv, long long jg,
                                              long long c, bool last,
                                              int tid) {
  const int L = g.L;
  const float4* tpl = reinterpret_cast<const float4*>(smem + g.t_off);
  float4 u[kTcR];
#pragma unroll
  for (int r = 0; r < kTcR; ++r) {
    const float4 t = tpl[tix];
    u[r] = make_float4(a[r] * t.x, a[r] * t.y, a[r] * t.z, a[r] * t.w);
    tix = tix + 1 == L ? 0 : tix + 1;
  }
  if (last) {
    const long long first = p.n_out - (L - 1);  // the first exported output
#pragma unroll
    for (int r = 0; r < kTcR; ++r) {
      if (jb + r < nv && jg + r >= first) {
        const long long o = c * (L - 1) + (jg + r - first);
        p.u_out[0][o] = u[r].x;
        p.u_out[1][o] = u[r].y;
        p.u_out[2][o] = u[r].z;
        p.u_out[3][o] = u[r].w;
      }
    }
  }
  float4 acc = u[0];
#pragma unroll
  for (int r = 0; r < kTcR; ++r) {
    if (r) acc = add4(acc, u[r]);
    prefix(g, smem, r)[g.HB + tid] = acc;
    a[r] = u[r].x;
  }
}

// kAfsk: the history's HB blocks in front of the prefix sums (from), or
// the tile's last HB blocks into the history (to).
__device__ __forceinline__ void afsk_history(const TcPlan& g,
                                             unsigned char* smem, int NT,
                                             bool from, int tid) {
  float4* hist = reinterpret_cast<float4*>(smem + g.h_off);
  for (int i = tid; i < 4 * g.HB; i += kThreads) {
    float4* pr = prefix(g, smem, i / g.HB);
    if (from) {
      pr[i % g.HB] = hist[i];
    } else {
      hist[i] = pr[NT / 4 + i % g.HB];
    }
  }
}

// kAfsk's window sums of this thread's outputs jb + r (block t = tid), and
// the output.  With L - 1 = 4m + e, output r's window starts in block
// t - m at offset r - e (r >= e) or in block t - m - 1 at r - e + 4, so
//   s[r] = P_r[t] + (B[t-m] + .. + B[t-1]) (+ B[t-m-1] when r < e)
//          - P_{off-1}[the start block]       (when the offset off > 0),
// B = P_3 a block's sum: m + 4 float4 loads for the thread's four outputs
// (13 at L = 40), and disc = |s_m|^2 - |s_s|^2 stored 16 bytes at a time.
__device__ __forceinline__ void afsk_sums(const TcPlan& g,
                                          unsigned char* smem, float* orow,
                                          long long j0, int jb, int nv,
                                          long long j_lo, int tid) {
  const int m = (g.L - 1) / 4, e = (g.L - 1) % 4;
  const int b0 = g.HB + tid;
  const float4* B = prefix(g, smem, 3);
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = m; i >= 1; --i) w = add4(w, B[b0 - i]);
  float d[kTcR];
#pragma unroll
  for (int r = 0; r < kTcR; ++r) {
    float4 sv = add4(prefix(g, smem, r)[b0], w);
    if (r < e) {
      sv = add4(sv, B[b0 - m - 1]);
      sv = sub4(sv, prefix(g, smem, r - e + 3)[b0 - m - 1]);
    } else if (r > e) {
      sv = sub4(sv, prefix(g, smem, r - e - 1)[b0 - m]);
    }
    d[r] = (sv.x * sv.x + sv.y * sv.y) - (sv.z * sv.z + sv.w * sv.w);
  }
  store4_at(orow, j0, jb, nv, j_lo, d);
}

template <int MODE, typename Tin, int P>
__global__ void __launch_bounds__(kThreads, 2)
fir_tc_kernel(const Params p, const TcPlan g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int isz = (int)sizeof(Tin);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one a raw stage
  float* s_state = reinterpret_cast<float*>(smem + 16);  // y[-1], de-emph
  float* s_wtot = s_state + 4;
  float* s_wpre = s_wtot + kWarps;
  Tin* raw = reinterpret_cast<Tin*>(smem + g.raw_off);  // [stage][plane]
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + g.a_off);
  float2* ys = reinterpret_cast<float2*>(smem + g.a_off);  // over A
  __nv_bfloat16* Bt = reinterpret_cast<__nv_bfloat16*>(smem + g.b_off);

  const int T = p.T, D = p.D, NT = g.F * g.S;  // NT: outputs a tile
  const long long c = blockIdx.x / p.K;
  const int k = blockIdx.x % p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long j_begin = k * p.chunk;
  const long long j_end = min(p.n_out, j_begin + p.chunk);
  // kAfsk: a later chunk starts L outputs early to fill its history (the
  // first of them has no true y[j-1]); those outputs are not written.
  const long long j_start =
      MODE == kAfsk && k > 0 ? j_begin - p.L : j_begin;
  const Tin* xr = static_cast<const Tin*>(p.xr) + c * p.B;
  const Tin* xi = static_cast<const Tin*>(p.xi) + c * p.B;
  const Tin* tr = p.s0 < 0 ? static_cast<const Tin*>(p.tail_r) + c * (T - 1)
                           : nullptr;
  const Tin* ti = p.s0 < 0 ? static_cast<const Tin*>(p.tail_i) + c * (T - 1)
                           : nullptr;
  float* orow = p.out + c * p.n_out;
  float ph_r = 0.f, ph_i = 0.f;  // kUsb: the block's unit phasor a0
  if constexpr (MODE == kUsb) {
    ph_r = p.ph_r[0];
    ph_i = p.ph_i[0];
  }

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&bar[s])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_taps(Bt, g, p, tid);
  if constexpr (MODE == kFm) {
    if (k == 0) {
      if (tid == 0) {
        s_state[0] = p.prev_r[c];
        s_state[1] = p.prev_i[c];
        s_state[2] = p.deemph ? p.dstate[c] : 0.f;
      }
    } else if (warp == 0) {
      // a later chunk starts from y[j_begin - 1] and de-emphasis state 0
      const float2 y = warp_y_at<P>(xr, xi, tr, ti,
                                    (j_begin - 1) * D + p.s0, p, lane);
      if (lane == 0) {
        s_state[0] = y.x;
        s_state[1] = y.y;
        s_state[2] = 0.f;
      }
    }
  }
  if constexpr (MODE == kAfsk) {
    // the first chunk from the carried y[-1] and products, a later one
    // from zeros, which reach only outputs it does not write
    if (tid == 0) {
      s_state[0] = k == 0 ? p.prev_r[c] : 0.f;
      s_state[1] = k == 0 ? p.prev_i[c] : 0.f;
    }
    afsk_setup(g, p, smem, c, k, p.n_out, tid);
  }
  __syncthreads();

  const long long n_tiles = (j_end - j_start + NT - 1) / NT;
  // Tile t's span: window start base, Ls samples, nv outputs.
  auto span = [&](long long t, long long* base, int* Ls, int* nv) {
    const long long j0 = j_start + t * NT;
    *nv = (int)min((long long)NT, j_end - j0);
    *Ls = (*nv - 1) * D + T;
    *base = j0 * D + p.s0;
  };
  // Thread 0: the bulk copies of tile t's span into its raw stage, for a
  // span inside the block; 16-byte aligned, so each plane's copy starts up
  // to 15 bytes early (still inside the planes' allocation: a row never
  // starts before an aligned address of it).
  auto fetch = [&](long long t) {
    long long base;
    int Ls, nv;
    span(t, &base, &Ls, &nv);
    if (!inner_run(base, Ls, p)) return;
    const int st = (int)(t & 1);
    uintptr_t a0[2];
    uint32_t n[2];
    for (int pl = 0; pl < 2; ++pl) {
      const uintptr_t a = reinterpret_cast<uintptr_t>((pl ? xi : xr) + base);
      a0[pl] = a & ~(uintptr_t)15;
      n[pl] = (uint32_t)(((a + (uintptr_t)Ls * isz + 15) & ~(uintptr_t)15) -
                         a0[pl]);
    }
    const uint32_t b = smem_addr(&bar[st]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(b),
                 "r"(n[0] + n[1])
                 : "memory");
    for (int pl = 0; pl < 2; ++pl) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(raw + (size_t)(2 * st + pl) * g.CAP)),
          "l"(a0[pl]), "r"(n[pl]), "r"(b)
          : "memory");
    }
  };
  if (tid == 0) {
    fetch(0);
    if (n_tiles > 1) fetch(1);
  }
  const DeemphScan<kTcR> deemph(p.a, p.b, lane);
  const uint32_t a_sh = smem_addr(A), b_sh = smem_addr(Bt);
  // this warp's MMAs: m-tile mt, n-tiles nt0 .. nt0 + nnt - 1 (the m-tiles
  // of a tile times its groups of n-tiles cover the 8 warps)
  const int n_mt = g.F / 16, groups = kWarps / n_mt;
  const int per_group = (g.NTL + groups - 1) / groups;
  const int mt = warp % n_mt, nt0 = (warp / n_mt) * per_group;
  const int nnt = max(0, min(per_group, g.NTL - nt0));
  uint32_t phase = 0;  // bit s: the parity stage s completes next
  // kAfsk: the template index of the tile's first output, stepped a tile at
  // a time, and this thread's first output's offset from it
  int ph = 0, ph_step = 0, jbm = 0;
  if constexpr (MODE == kAfsk) {
    ph = (int)(((long long)*p.n0 + j_start) % p.L);
    ph_step = NT % p.L;
    jbm = (tid * kTcR) % p.L;
  }

  for (long long t = 0; t < n_tiles; ++t) {
    long long base;
    int Ls, nv;
    span(t, &base, &Ls, &nv);
    const long long j0 = j_start + t * NT;
    if (inner_run(base, Ls, p)) {
      const int st = (int)(t & 1);
      bar_wait(smem_addr(&bar[st]), (phase >> st) & 1u);
      phase ^= 1u << st;
      convert_raw<P>(
          A, g.LA, Ls, raw + (size_t)(2 * st) * g.CAP,
          raw + (size_t)(2 * st + 1) * g.CAP,
          (int)((reinterpret_cast<uintptr_t>(xr + base) & 15) / isz),
          (int)((reinterpret_cast<uintptr_t>(xi + base) & 15) / isz), tid);
    } else {
      convert<P>(A, g.LA, Ls, tid, [&](int pl, int m) {
        return to_f32(pl ? sample_at(xi, ti, base + m, p)
                         : sample_at(xr, tr, base + m, p));
      });
    }
    __syncthreads();  // the span is converted and its raw stage free
    if (tid == 0 && t + 2 < n_tiles) fetch(t + 2);

    float acc[2][P][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        acc[i][q][0] = acc[i][q][1] = acc[i][q][2] = acc[i][q][3] = 0.f;
      }
    }
    if (nnt > 0) mma_frames<P>(acc, a_sh, b_sh, g, D, T, mt, nt0, nnt, lane);
    __syncthreads();  // every read of the span is done: ys goes over it
    if (nnt > 0) {
      const int f = 16 * mt + (lane >> 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = 4 * (nt0 + i) + (lane & 3);
        if (i < nnt && s < g.S) {
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = acc[i][0][e];
#pragma unroll
            for (int q = 1; q < P; ++q) y[e] += acc[i][q][e];
          }
          ys[tc_skew(f * g.S + s)] = make_float2(y[0], y[1]);
          ys[tc_skew((f + 8) * g.S + s)] = make_float2(y[2], y[3]);
        }
      }
    }
    __syncthreads();

    // Epilogue: this thread's outputs jb .. jb + 3 of the tile (those past
    // nv, and the slots past the tile, are computed and not written).
    const int jb = tid * kTcR;
    float yr[kTcR], yi[kTcR], loc[kTcR];
#pragma unroll
    for (int r = 0; r < kTcR; ++r) {
      const float2 v = ys[tc_skew(jb + r)];
      yr[r] = v.x;
      yi[r] = v.y;
    }
    if constexpr (MODE == kAm) {
#pragma unroll
      for (int r = 0; r < kTcR; ++r) {
        loc[r] = p.gain * sqrtf(yr[r] * yr[r] + yi[r] * yi[r]);
      }
      store4(orow + j0 + jb, loc, nv - jb);
    } else if constexpr (MODE == kUsb) {
      // the exact NCO: output j rotated by a0 * ramp[j]
      float rr[kTcR], ri[kTcR];
      load4(p.ramp_r + j0 + jb, rr, nv - jb);
      load4(p.ramp_i + j0 + jb, ri, nv - jb);
#pragma unroll
      for (int r = 0; r < kTcR; ++r) {
        loc[r] = p.gain * usb_sig(yr[r], yi[r], ph_r, ph_i, rr[r], ri[r]);
      }
      store4(orow + j0 + jb, loc, nv - jb);
    } else if constexpr (MODE == kFir) {
      store4(orow + j0 + jb, yr, nv - jb);
      store4(p.out_i + c * p.n_out + j0 + jb, yi, nv - jb);
    } else {
      float pr, pi;
      if (jb == 0) {
        pr = s_state[0];
        pi = s_state[1];
      } else {
        const float2 v = ys[tc_skew(jb - 1)];
        pr = v.x;
        pi = v.y;
      }
#pragma unroll
      for (int r = 0; r < kTcR; ++r) {
        loc[r] = MODE == kAfsk && kAfskKoDisc
                     ? yr[r]
                     : fm_audio<true>(yr[r], yi[r], pr, pi, p);
        pr = yr[r];
        pi = yi[r];
      }
      if constexpr (MODE == kAfsk) {
        if constexpr (!kAfskKoTone) {
          if (jb < NT) {
            const int tix = ph + jbm < p.L ? ph + jbm : ph + jbm - p.L;
            afsk_products(g, p, smem, loc, tix, jb, nv, j0 + jb, c,
                          k == p.K - 1, tid);
          }
          afsk_history(g, smem, NT, true, tid);
        }
        if constexpr (kAfskKoTone || kAfskKoSum) {
          store4_at(orow, j0, jb, nv, j_begin, loc);
        }
      } else {
        if (p.deemph) {  // uniform across the block: the barriers are safe
          deemph.template run<true>(loc, s_wtot, s_wpre, s_state + 2, lane,
                                    warp);
        }
        store4(orow + j0 + jb, loc, nv - jb);
      }
    }
    __syncthreads();  // every read of ys and of the carried state is done
    if constexpr (MODE == kAfsk) {
      // the tile's last y carries into the next tile; the window sums of
      // the tile's outputs, and its last HB blocks into the history
#pragma unroll
      for (int r = 0; r < kTcR; ++r) {
        if (jb + r == nv - 1) {
          s_state[0] = yr[r];
          s_state[1] = yi[r];
        }
      }
      if constexpr (!kAfskKoTone && !kAfskKoSum) {
        if (jb < NT) afsk_sums(g, smem, orow, j0, jb, nv, j_begin, tid);
      }
      if constexpr (!kAfskKoTone) afsk_history(g, smem, NT, false, tid);
      ph += ph_step;
      if (ph >= p.L) ph -= p.L;
      __syncthreads();  // every read of the products is done
    }
    if constexpr (MODE == kFm) {
      // the tile's last output carries into the next tile
#pragma unroll
      for (int r = 0; r < kTcR; ++r) {
        if (jb + r == nv - 1) {
          s_state[0] = yr[r];
          s_state[1] = yi[r];
          s_state[2] = loc[r];
          if (p.ends && j0 + nv == j_end) p.ends[blockIdx.x] = loc[r];
        }
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

using TcKernel = void (*)(const Params, const TcPlan);

TcKernel tc_kernel(int mode, int bf16, int fast) {
  if (mode == kFm) {
    if (bf16) {
      return fast ? fir_tc_kernel<kFm, __nv_bfloat16, 1>
                  : fir_tc_kernel<kFm, __nv_bfloat16, 2>;
    }
    return fast ? fir_tc_kernel<kFm, float, 1> : fir_tc_kernel<kFm, float, 3>;
  }
  if (mode == kFir) {
    if (bf16) {
      return fast ? fir_tc_kernel<kFir, __nv_bfloat16, 1>
                  : fir_tc_kernel<kFir, __nv_bfloat16, 2>;
    }
    return fast ? fir_tc_kernel<kFir, float, 1>
                : fir_tc_kernel<kFir, float, 3>;
  }
  if (mode == kAm) {
    if (bf16) {
      return fast ? fir_tc_kernel<kAm, __nv_bfloat16, 1>
                  : fir_tc_kernel<kAm, __nv_bfloat16, 2>;
    }
    return fast ? fir_tc_kernel<kAm, float, 1> : fir_tc_kernel<kAm, float, 3>;
  }
  if (mode == kUsb) {
    if (bf16) {
      return fast ? fir_tc_kernel<kUsb, __nv_bfloat16, 1>
                  : fir_tc_kernel<kUsb, __nv_bfloat16, 2>;
    }
    return fast ? fir_tc_kernel<kUsb, float, 1>
                : fir_tc_kernel<kUsb, float, 3>;
  }
  if (mode == kAfsk) {
    if (bf16) {
      return fast ? fir_tc_kernel<kAfsk, __nv_bfloat16, 1>
                  : fir_tc_kernel<kAfsk, __nv_bfloat16, 2>;
    }
    return fast ? fir_tc_kernel<kAfsk, float, 1>
                : fir_tc_kernel<kAfsk, float, 3>;
  }
  return nullptr;
}

// The kernel of (mode, bf16, fast) with its plan's shared memory allowed
// (L: kAfsk's window, else 0); 0, -1 (no kernel or no plan), or a
// cudaError_t.
int tc_prepare(int mode, int T, int D, int L, int bf16, int fast,
               int smem_max, int smem_sm, TcKernel* kernel, TcPlan* g) {
  *kernel = tc_kernel(mode, bf16, fast);
  if (!*kernel ||
      !tc_plan(T, D, L, bf16, fast, smem_max, smem_sm, g)) {
    return -1;
  }
  return (int)cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g->bytes);
}

}  // namespace

bool tc_fits(int T, int D, int L, int bf16, int fast, int smem_max,
             int smem_sm) {
  TcPlan g;
  return tc_plan(T, D, L, bf16, fast, smem_max, smem_sm, &g);
}

int tc_chunks(int mode, long long C, long long n_out, int T, int D, int L,
              int bf16, int fast, int smem_max, int smem_sm, int sms) {
  TcKernel kernel;
  TcPlan g;
  int e = tc_prepare(mode, T, D, L, bf16, fast, smem_max, smem_sm, &kernel,
                     &g);
  if (e != 0) return e == -1 ? -1 : -2 - e;
  int per_sm = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, g.bytes);
  if (e != 0) return -2 - e;
  const long long k = (long long)sms * per_sm / C;
  const long long most = n_out / kTcMinChunk;
  return fit_chunks(n_out, k < most ? k : most);
}

int tc_launch(int mode, const Params& p, long long C, int bf16, int fast,
              cudaStream_t stream, int smem_max, int smem_sm) {
  TcKernel kernel;
  TcPlan g;
  const int e = tc_prepare(mode, p.T, p.D, mode == kAfsk ? p.L : 0, bf16,
                          fast, smem_max, smem_sm, &kernel, &g);
  if (e != 0) return e;
  kernel<<<(unsigned)(C * p.K), kThreads, g.bytes, stream>>>(p, g);
  return (int)cudaGetLastError();
}

}  // namespace sdr

extern "C" {

// The tensor-core kernel's plan for a shape (tc_plan; L: kAfsk's window,
// else 0), for the tests that hold ops/fir_tc.py's layout to it: out gets
// S, frames a tile, Kp, the n-tiles, the widest band's k-tiles, LA, CAP
// and the shared-memory bytes.  Returns 0, -1 when no plan fits, or -2 -
// cudaError_t.
int sdr_fir_tc_plan(int T, int D, int L, int bf16, int fast, int* out) {
  int dev = 0, smem_max = 0, smem_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e != cudaSuccess) return -2 - (int)e;
  sdr::TcPlan g;
  if (!sdr::tc_plan(T, D, L, bf16, fast, smem_max, smem_sm, &g)) return -1;
  const int v[8] = {g.S, g.F, g.Kp, g.NTL, g.KBW, g.LA, g.CAP, g.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
