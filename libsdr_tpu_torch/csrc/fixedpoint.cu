// The Q14 chain's de-emphasis (FMDeemphInt, the reference's
// FMDeemph<int16_t>) for a bank of C channels, one thread a channel, every
// sample of the block in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as one
// lax.scan over the block's samples (libsdr_tpu/ops/fixedpoint.py:334),
// which XLA compiles into a loop on the accelerator.  The port's plain
// version (ops/fixedpoint.py::deemph_int_plain) is the same step as a loop
// over time of PyTorch ops; this kernel keeps the step on the card, so a
// block makes one launch and no host round a sample, and a pipeline
// holding FMDeemphInt can be captured into a CUDA graph
// (core/graph.py::compile_chunked).
//
// Per channel and sample x (int32), with the carry avg (int32):
//
//   diff = wrap16(x - avg)
//   upd  = diff > 0 ? (diff + half) / alpha : (diff - half) / alpha
//   avg  = wrap16(avg + upd);  out = avg
//
// with C's division, which truncates toward zero as the plain version's
// _div_trunc does (alpha >= 1), and wrap16(a) = ((a + 2^15) & 0xFFFF) -
// 2^15, the plain version's explicit mask.  The sums are taken in uint32:
// the plain version's int32 arithmetic wraps, and the mask keeps only the
// low 16 bits, which the wraparound does not change.  So the kernel's
// output and carry equal the plain version's bit for bit.
//
// What bounds it on an H100: per channel-sample it reads 4 bytes and
// writes 4, so the roofline bound is microseconds (64 channels x 2,400
// samples: 1.2 MB, 0.0004 ms at 3.35 TB/s), but every step is on one
// chain: avg feeds the next step's diff, and the truncating division makes
// the step nonlinear, so there is no scan that would parallelise it over
// time.  The chain's T steps are the floor: the wrap, the compare and
// select, the division by a runtime constant (a reciprocal and a
// correction, tens of cycles) and the second wrap.  What the design does
// about it is to keep nothing else on that chain:
// * one thread a channel, one warp a block, so that the channels of a
//   bank spread over the SMs;
// * avg in a register for the whole block;
// * each chunk's kChunk samples loaded at the start of the chunk before,
//   so their latency (a row of a channel is strided by T from its
//   neighbours') is off the chain.
// The entry point returns cudaGetLastError() after the launch, or -1 when
// the arguments are outside the gate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdr {
namespace {

constexpr int kChunk = 16;   // samples a thread loads ahead

__device__ __forceinline__ int32_t wrap16(uint32_t a) {
  return static_cast<int32_t>((a + 0x8000u) & 0xFFFFu) - 0x8000;
}

__device__ __forceinline__ int32_t deemph_step(int32_t avg, int32_t x,
                                               int32_t alpha, int32_t half) {
  const int32_t diff =
      wrap16(static_cast<uint32_t>(x) - static_cast<uint32_t>(avg));
  const int32_t upd = diff > 0 ? (diff + half) / alpha
                               : (diff - half) / alpha;
  return wrap16(static_cast<uint32_t>(avg) + static_cast<uint32_t>(upd));
}

__global__ void __launch_bounds__(32)
    deemph_int_scan(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ avg_in,
                    int32_t* __restrict__ y, int32_t* __restrict__ avg_out,
                    long long C, long long T, int32_t alpha, int32_t half) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (c >= C) return;
  const int32_t* xc = x + c * T;
  int32_t* yc = y + c * T;
  int32_t avg = avg_in[c];
  long long t0 = 0;
  if (T >= kChunk) {
    int32_t cur[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cur[k] = xc[k];
    for (; t0 + kChunk <= T; t0 += kChunk) {
      // the next chunk's samples, loaded before this chunk's chain runs
      int32_t nxt[kChunk];
      const bool more = t0 + 2 * kChunk <= T;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) nxt[k] = more ? xc[t0 + kChunk + k] : 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        avg = deemph_step(avg, cur[k], alpha, half);
        yc[t0 + k] = avg;
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) cur[k] = nxt[k];
    }
  }
  for (; t0 < T; ++t0) {    // the tail: fewer than kChunk samples
    avg = deemph_step(avg, xc[t0], alpha, half);
    yc[t0] = avg;
  }
  avg_out[c] = avg;
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// FMDeemphInt over a block of T samples for C channels.  x, y: (C, T)
// int32, row-major; avg_in, avg_out: (C,) int32, the carry entering and
// leaving the block; all device pointers.  alpha >= 1 and half =
// alpha / 2.  T = 0 copies the carry.  Returns 0, -1 when the arguments
// are outside the gate, else a cudaError_t.
int sdr_deemph_int(const int32_t* x, const int32_t* avg_in, int32_t* y,
                   int32_t* avg_out, long long C, long long T, int alpha,
                   int half, void* stream) {
  if (C < 1 || C > 0x7fffffffLL * 32 || T < 0 || alpha < 1 ||
      half != alpha / 2 || alpha > (1 << 30) || !avg_in || !avg_out ||
      (T > 0 && (!x || !y))) {
    return -1;
  }
  const long long blocks = (C + 31) / 32;
  deemph_int_scan<<<static_cast<unsigned>(blocks), 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, avg_in, y, avg_out, C, T, alpha, half);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
