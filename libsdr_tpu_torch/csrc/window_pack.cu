// The pager scanner's windowed compaction (parallel/wideband.py::
// build_scanner_step with compact_window w > 0) in one pass: the bit-sync
// PLL's packed bytes (M, T) in, lanes first, one byte a step with bit 0 =
// the sampled bit and bit 1 = its valid flag (csrc/bitsync.cu's output),
// and the (C, T/w) packed windows out, output row c read from input row
// rows[c] (the lane that carries channel c; rows null: row c).  Output byte
// (c, j), with r = rows[c] and k over the window's w steps:
//
//   (uint8)(sum_k data[r, jw+k] * valid[r, jw+k]) | any_k valid[r, jw+k] << 1
//
// the sum wrapping mod 256, which is ops/pll.py::window_pack_plain's
// arithmetic on any input (the PLL's bit gap leaves at most one valid step
// a window, so the sum is that step's bit).
//
// Replaces no Pallas kernel: the JAX package does this in jnp ops
// (libsdr_tpu/parallel/wideband.py:361-374 and :405-415) and the port did
// it in eager PyTorch, several passes over the full-rate bytes (the bits
// and flags split, a masked sum widened to int64, an any, two gathers, a
// transpose and the packing).
//
// What bounds it on an H100: bytes.  At the pager cell's shape (1024 x
// 65,536, w = 16) it reads 64 MiB and writes 4 MiB, 0.021 ms at 3.35 TB/s;
// the work a byte is a few integer operations.  How its loads are shaped:
// * one block walks a stretch of one output row (kUnroll x kThreads
//   16-byte vectors of its input row), so the row map is read once a block
//   and a warp reads whole 128-byte lines, four 512-byte runs a warp in
//   flight before any is used;
// * a vector's 16 steps reduce in registers as four 32-bit words: the
//   bit-and-flag items (bit & valid at bit 0 of each byte) are counted
//   with popc and the flags or-ed; w < 16 packs 16/w output bytes a vector
//   (byte_perm at w = 2) into one store of 16/w bytes, w = 16 one byte,
//   and w = 32 or 64 joins the vectors of neighbouring lanes with xor
//   shuffles, so the stores of a warp are contiguous too;
// * that route needs T a multiple of 16 and w a power of two up to 64
//   (pick_window's windows); every other shape takes a plain pass of one
//   thread an output byte, byte loads over its window.
// The entry point returns cudaGetLastError() after the launch, or -1 when
// the arguments are outside the gate.  The row map is not range-checked on
// the card: the caller passes rows within 0..M-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdr {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                  // 16-byte loads a thread
constexpr int kVecsPerBlock = kThreads * kUnroll;
constexpr int kRouteVector = 0;             // the routes (ops/pll.py)
constexpr int kRouteBytes = 1;

// Per byte of x: bit & valid, and valid, each at bit 0 of its byte.
__device__ __forceinline__ uint32_t items(uint32_t x) {
  return x & (x >> 1) & 0x01010101u;
}
__device__ __forceinline__ uint32_t flags(uint32_t x) {
  return (x >> 1) & 0x01010101u;
}
// One output byte from a window's item count and or-ed flags.
__device__ __forceinline__ uint32_t pack(uint32_t n, uint32_t any) {
  return (n & 0xFFu) | (any ? 2u : 0u);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    window_pack_vec(const uint8_t* __restrict__ in,
                    const long long* __restrict__ rows,
                    uint8_t* __restrict__ out, long long T, int chunks) {
  const long long c = blockIdx.x / chunks;
  const long long v0 =
      static_cast<long long>(blockIdx.x % chunks) * kVecsPerBlock +
      threadIdx.x;
  const long long nvec = T >> 4;
  const long long r = rows ? rows[c] : c;
  const uint4* src = reinterpret_cast<const uint4*>(in + r * T);
  uint8_t* dst = out + c * (T / W);
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = v0 + u * kThreads;
    v[u] = i < nvec ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = v0 + u * kThreads;
    const bool live = i < nvec;
    const uint32_t x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    if constexpr (W == 1) {
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = items(x[k]) | (flags(x[k]) << 1);
      if (live) {
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else if constexpr (W == 2) {
      // each word's byte pairs summed into its bytes 0 and 2 (at most 2
      // each: no carry), then those bytes of two words side by side
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t d = items(x[k]), a = flags(x[k]);
        o[k] = (d + (d >> 8)) | ((a | (a >> 8)) << 1);
      }
      if (live) {
        reinterpret_cast<uint2*>(dst)[i] =
            make_uint2(__byte_perm(o[0], o[1], 0x6420),
                       __byte_perm(o[2], o[3], 0x6420));
      }
    } else if constexpr (W == 4) {
      uint32_t o = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o |= pack(__popc(items(x[k])), flags(x[k])) << (8 * k);
      }
      if (live) reinterpret_cast<uint32_t*>(dst)[i] = o;
    } else if constexpr (W == 8) {
      const uint32_t lo = pack(__popc(items(x[0])) + __popc(items(x[1])),
                               flags(x[0]) | flags(x[1]));
      const uint32_t hi = pack(__popc(items(x[2])) + __popc(items(x[3])),
                               flags(x[2]) | flags(x[3]));
      if (live) {
        reinterpret_cast<uint16_t*>(dst)[i] =
            static_cast<uint16_t>(lo | (hi << 8));
      }
    } else {
      // W >= 16: a window is the vectors of W/16 neighbouring lanes (a
      // warp's vectors are consecutive and start at a multiple of 32); all
      // 32 lanes shuffle, a lane past the row with zeros
      constexpr int G = W / 16;
      uint32_t n = 0, a = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        n += __popc(items(x[k]));
        a |= flags(x[k]);
      }
#pragma unroll
      for (int s = 1; s < G; s <<= 1) {
        n += __shfl_xor_sync(0xffffffffu, n, s);
        a |= __shfl_xor_sync(0xffffffffu, a, s);
      }
      if (live && (i & (G - 1)) == 0) dst[i / G] = pack(n, a);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    window_pack_bytes(const uint8_t* __restrict__ in,
                      const long long* __restrict__ rows,
                      uint8_t* __restrict__ out, long long T, long long w,
                      long long n_out, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long o = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       o < total; o += stride) {
    const long long c = o / n_out, j = o - c * n_out;
    const long long r = rows ? rows[c] : c;
    const uint8_t* p = in + r * T + j * w;
    uint32_t n = 0, a = 0;
    for (long long k = 0; k < w; ++k) {
      const uint32_t b = p[k];
      n += b & (b >> 1) & 1u;
      a |= b;
    }
    out[o] = static_cast<uint8_t>((n & 0xFFu) | (a & 2u));
  }
}

template <int W>
void launch_vec(const uint8_t* in, const long long* rows, uint8_t* out,
                long long T, long long blocks, int chunks,
                cudaStream_t stream) {
  window_pack_vec<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      in, rows, out, T, chunks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
}  // namespace sdr

using namespace sdr;

extern "C" {

// The windows of the PLL's packed bytes.  in: (M, T) uint8, row-major;
// rows: (C,) int64 within 0..M-1, or null for C = M and row c; out: (C,
// T/w) uint8, row-major; all device pointers.  w >= 1 divides T.  *route
// gets the route taken (0: 16-byte vectors, 1: bytes).  Returns 0, -1
// when the arguments are outside the gate, else a cudaError_t.
int sdr_window_pack(const uint8_t* in, const long long* rows, uint8_t* out,
                    long long M, long long C, long long T, long long w,
                    void* stream, int* route) {
  if (M < 1 || C < 0 || T < 1 || w < 1 || T % w || !in || !out || !route ||
      (!rows && C != M)) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (T / 16 + kVecsPerBlock - 1) / kVecsPerBlock;
  const bool vec = T % 16 == 0 && w <= 64 && (w & (w - 1)) == 0 &&
                   aligned16(in) && aligned16(out) &&
                   C * chunks <= 0x7fffffffLL;
  *route = vec ? kRouteVector : kRouteBytes;
  if (C == 0) return 0;
  if (vec) {
    const long long blocks = C * chunks;
    const int ch = static_cast<int>(chunks);
    switch (w) {
      case 1: launch_vec<1>(in, rows, out, T, blocks, ch, s); break;
      case 2: launch_vec<2>(in, rows, out, T, blocks, ch, s); break;
      case 4: launch_vec<4>(in, rows, out, T, blocks, ch, s); break;
      case 8: launch_vec<8>(in, rows, out, T, blocks, ch, s); break;
      case 16: launch_vec<16>(in, rows, out, T, blocks, ch, s); break;
      case 32: launch_vec<32>(in, rows, out, T, blocks, ch, s); break;
      default: launch_vec<64>(in, rows, out, T, blocks, ch, s); break;
    }
  } else {
    const long long n_out = T / w, total = C * n_out;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    window_pack_bytes<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, rows, out, T, w, n_out, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
