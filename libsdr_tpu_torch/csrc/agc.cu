// The AGC of the AM and USB modes, run over the kernel's sig output in
// place.  It replaces the AGC envelope IIR that rode along inside the TPU
// kernel pallas_fir_mxu.py::_kernel_fm2 in modes 'am' and 'usb' (an
// impulse-response matmul with the state carried from grid step to grid
// step):
//
//   sd[j]  = lam*sd[j-1] + b*|sig[j]|      (sd[-1] = sd_in)
//   out[j] = gain * sig[j] / sd[j]
//
// with b = 1 - lam for K1's modes am and usb.  It also runs the AGC of the
// v1 kernel's mode 'am' (pallas_fir_mxu.py::_kernel_fm, K6), whose (lam, b)
// are any pair.
//
// The state cannot cross chunks by a fix-up, as the de-emphasis does: the
// output is not linear in it, and lam = exp(-1/(0.1 s * 24 kHz)) decays over
// tens of thousands of outputs.  So three launches:
//   1. agc_pass<false>: each chunk's end value of sd from state 0;
//   2. agc_chunk_scan: the true state entering each chunk (and sd_out);
//   3. agc_pass<true>: each chunk again from its entry state, writing out.
// Passes 1 and 3 read sig and pass 3 writes out: 12/D bytes per input
// sample of the FIR, against its 4 or 8 bytes read.  A pass walks its chunk
// in segments of 256*4 outputs with the chunked scan of fir_fm_exact.cu's
// de-emphasis (per-thread pass, warp scan of the thread ends, block prefix
// in shared memory carried across segments).
//
// lam is close to 1 (1 - lam = 2.1e-5 at 480 kHz), so float32 cannot hold
// it: rounding would move 1 - lam by up to 1.4e-3 of itself.  The passes
// take b, la = log(lam) and e = lam - 1 + b, all from double: each step is
// sd += b*(|sig| - sd) + e*sd, and every power of lam is exp(n*la).  With
// b = 1 - lam, e is exactly 0 and the step is K1's own.

#include "fir_common.cuh"

namespace sdr {
namespace {

constexpr int kR = 4;                   // outputs per thread and segment
constexpr long long kMinAgcChunk = 2048;

template <bool APPLY>
__global__ void __launch_bounds__(kThreads)
agc_pass(float* out, float* ends, long long n_out, long long chunk, int K,
         float b, float e, float la, float gain) {
  __shared__ float s_wtot[kWarps], s_wpre[kWarps], s_state;
  constexpr int N = kThreads * kR;
  const long long c = blockIdx.x / K;
  const int k = blockIdx.x % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long j_begin = k * chunk;
  const long long j_end = min(n_out, j_begin + chunk);
  float* row = out + c * n_out;
  const float aR = expf(kR * la);               // lam^R
  const float a_lane = expf(lane * kR * la);     // lam^(R*lane)
  const float a32 = expf(32 * kR * la);          // lam^(R*32)
  if (tid == 0) s_state = APPLY ? ends[blockIdx.x] : 0.f;
  __syncthreads();

  for (long long j0 = j_begin; j0 < j_end; j0 += N) {
    const long long jt = j0 + tid * kR;  // this thread's first output
    float v[kR], loc[kR];
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      v[r] = jt + r < j_end ? row[jt + r] : 0.f;
      l = fmaf(e, l, fmaf(b, fabsf(v[r]) - l, l));
      loc[r] = l;
    }
    // Inclusive scan of S_t = sum_{u<=t} A^(t-u) l_u over the warp.
    float S = l, m = aR;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, S, off);
      if (lane >= off) S = fmaf(m, w, S);
      m *= m;
    }
    float Sx = __shfl_up_sync(0xffffffffu, S, 1);
    if (lane == 0) Sx = 0.f;
    if (lane == 31) s_wtot[warp] = S;
    __syncthreads();
    if (tid == 0) {
      float P = s_state;
      for (int w = 0; w < kWarps; ++w) {
        s_wpre[w] = P;
        P = fmaf(a32, P, s_wtot[w]);
      }
      s_state = P;
    }
    __syncthreads();
    const float s_in = fmaf(a_lane, s_wpre[warp], Sx);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float sd = fmaf(expf((r + 1) * la), s_in, loc[r]);
      if (jt + r < j_end) {
        if (APPLY) {
          row[jt + r] = gain * v[r] / sd;
        } else if (jt + r == j_end - 1) {
          ends[blockIdx.x] = sd;
        }
      }
    }
  }
}

// One thread per channel: the chunk-end values from state 0 become the
// state entering each chunk, S_in[0] = sd_in and
// S_in[k] = lam^len[k-1] * S_in[k-1] + end[k-1] (written over ends[k]); the
// state after the last chunk goes to sd_out.
__global__ void agc_chunk_scan(const float* sd_in, float* sd_out,
                               float* ends, long long C, long long n_out,
                               long long chunk, int K, float la) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= C) return;
  float* e = ends + c * K;
  float S = sd_in[c];
  for (int k = 0; k < K; ++k) {
    const long long len = min(n_out, (k + 1) * chunk) - k * chunk;
    const float E = e[k];
    e[k] = S;
    S = fmaf(expf(len * la), S, E);
  }
  sd_out[c] = S;
}

}  // namespace

int agc_chunks(long long C, long long n_out, int sms) {
  // Four blocks per SM of the card, each chunk at least kMinAgcChunk.
  long long k = 4LL * sms / C;
  const long long most = n_out / kMinAgcChunk;
  return fit_chunks(n_out, k < most ? k : most);
}

int agc_launch(float* out, const float* sd_in, float* sd_out, float* ends,
               long long C, long long n_out, int K, double lam, double b,
               float gain, cudaStream_t stream) {
  const long long chunk = (n_out + K - 1) / K;
  const float bf = (float)b, la = (float)log(lam);
  const float ef = (float)((lam - 1.0) + b);
  const unsigned blocks = (unsigned)(C * K);
  agc_pass<false><<<blocks, kThreads, 0, stream>>>(out, ends, n_out, chunk,
                                                   K, bf, ef, la, gain);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  agc_chunk_scan<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(
      sd_in, sd_out, ends, C, n_out, chunk, K, la);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  agc_pass<true><<<blocks, kThreads, 0, stream>>>(out, ends, n_out, chunk,
                                                  K, bf, ef, la, gain);
  return (int)cudaGetLastError();
}

}  // namespace sdr
