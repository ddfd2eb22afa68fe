// Banded tracebacks on the device (nw_moves, mea_moves).
//
// Replace marginalign_trna_tpu/ops/traceback_device.py `nw_moves_device`
// and `mea_moves_device` (XLA scans, not Pallas) fused with its
// `pack_moves`: each lane walks its uint8 pointer band [D1, Wp, B] from
// (m, n) back to (0, 0) over the diagonals d = D1 - 1 .. 1 in lockstep,
// making at most one move a diagonal (an M move skips d - 1), and only the
// 2-bit move stream [ceil((D1 - 1) / 4), B] is written: move t = d - 1 of
// lane b in bits 2 (t % 4) of byte (t / 4, b), NO_MOVE (3) where the lane
// does not move and in the padding.  The pointer bands of K1, D and K4
// never leave the card.
//
// Design: one thread per lane, a warp a block, so that the lanes spread
// over the SMs.  A thread packs its four moves of a byte in a register and
// stores one byte every fourth diagonal; the stores of a warp's lanes
// coalesce.  The walk is a chain of dependent loads: the band row of
// diagonal d is i - lo[d], and i depends on the pointer read at the
// diagonal before.  So the kernel is bound by the load latency times the
// moves a lane makes, far above the bytes it moves (its bound is the
// pointer and offset bytes of the moves made plus the stream, at the
// card's memory rate).  The offsets of the next byte's four diagonals are
// loaded before the current byte is walked, so that only the pointer
// loads stay on the chain.
//
// Semantics are the host tracebacks' (native/margin_native.cpp, ops/nw.py
// and ops/mea.py `_traceback_arrays`) and, on the pointer values the
// kernels emit, the JAX scans':
//   NW   state M on the i == 0 / j == 0 edge re-reads the same cell as
//        gap state Ix / Iy; M moves diagonally and takes its next state
//        from p & 3, Ix (ref consumed) from bit 2, Iy (read consumed) from
//        bit 3;
//   MEA  i == 0 forces D and j == 0 forces I without reading the band;
//        pointer 0 is M, 1 is D (j - 1), any other value I (i - 1), as the
//        host traceback reads it (the JAX scan takes 3 as I with both i
//        and j decremented).
// A band row outside [0, Wp) reads pointer 0, as the scans' one-hot does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB_THREADS = 32;
constexpr unsigned NO_MOVE = 3;

// The band offsets of the four diagonals of byte q (0 past the last one).
__device__ __forceinline__ void load_offsets(const int32_t* __restrict__ lo,
                                             int q, int T, int B, int b,
                                             int (&out)[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int d = 4 * q + s + 1;
    out[s] = d <= T ? __ldg(lo + (size_t)d * B + b) : 0;
  }
}

template <bool NW>
__global__ void __launch_bounds__(TB_THREADS)
    moves_kernel(const uint8_t* __restrict__ ptrs,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                 const int32_t* __restrict__ final_state, int D1, int Wp,
                 int B, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * TB_THREADS + threadIdx.x;
  if (b >= B) return;
  const int T = D1 - 1;
  int i = m[b], j = n[b];
  int state = NW ? final_state[b] : 0;
  int lod[4], next[4];
  load_offsets(lo, (T + 3) / 4 - 1, T, B, b, lod);
  for (int q = (T + 3) / 4 - 1; q >= 0; --q) {
    if (q > 0) load_offsets(lo, q - 1, T, B, b, next);
    unsigned byte = 0;
#pragma unroll
    for (int s = 3; s >= 0; --s) {
      const int d = 4 * q + s + 1;
      unsigned mv = NO_MOVE;
      if (d <= T && i + j == d && (i > 0 || j > 0)) {
        const int k = i - lod[s];
        const bool read = (k >= 0 && k < Wp) && (NW || (i > 0 && j > 0));
        const unsigned p = read ? ptrs[((size_t)d * Wp + k) * B + b] : 0u;
        if (NW) {
          const int st = state == 0 && i == 0 ? 1
                         : (state == 0 && j == 0 ? 2 : state);
          if (st == 0) {
            mv = 0;
            state = p & 3;
            --i;
            --j;
          } else if (st == 1) {
            mv = 2;
            state = (p >> 2) & 1;
            --j;
          } else {
            mv = 1;
            state = ((p >> 3) & 1) ? 2 : 0;
            --i;
          }
        } else {
          const unsigned pe = i == 0 ? 1u : (j == 0 ? 2u : p);
          if (pe == 0) {
            mv = 0;
            --i;
            --j;
          } else if (pe == 1) {
            mv = 2;
            --j;
          } else {
            mv = 1;
            --i;
          }
        }
      }
      byte |= mv << (2 * s);
    }
    out[(size_t)q * B + b] = (uint8_t)byte;
#pragma unroll
    for (int s = 0; s < 4; ++s) lod[s] = next[s];
  }
}

cudaError_t moves_launch(bool nw, const uint8_t* ptrs, const int32_t* lo,
                         const int32_t* m, const int32_t* n,
                         const int32_t* final_state, int D1, int Wp, int B,
                         uint8_t* out, cudaStream_t stream) {
  if (D1 < 2 || Wp < 1 || B < 1) return cudaErrorInvalidValue;
  const dim3 grid((B + TB_THREADS - 1) / TB_THREADS);
  if (nw)
    moves_kernel<true><<<grid, TB_THREADS, 0, stream>>>(
        ptrs, lo, m, n, final_state, D1, Wp, B, out);
  else
    moves_kernel<false><<<grid, TB_THREADS, 0, stream>>>(
        ptrs, lo, m, n, nullptr, D1, Wp, B, out);
  return cudaGetLastError();
}

}  // namespace

// ptrs [D1, Wp, B] uint8 (K1's ptrM | ptrIx << 2 | ptrIy << 3), lo [D1, B],
// m, n, final_state [B] int32; out [ceil((D1 - 1) / 4), B] uint8.
extern "C" int nw_moves_launch(const uint8_t* ptrs, const int32_t* lo,
                               const int32_t* m, const int32_t* n,
                               const int32_t* final_state, int D1, int Wp,
                               int B, uint8_t* out, void* stream) {
  return moves_launch(true, ptrs, lo, m, n, final_state, D1, Wp, B, out,
                      (cudaStream_t)stream);
}

// ptrs [D1, Wp, B] uint8 (D's and K4's 0 diag, 1 left, 2 up), lo [D1, B],
// m, n [B] int32; out as nw_moves_launch's.
extern "C" int mea_moves_launch(const uint8_t* ptrs, const int32_t* lo,
                                const int32_t* m, const int32_t* n, int D1,
                                int Wp, int B, uint8_t* out, void* stream) {
  return moves_launch(false, ptrs, lo, m, n, nullptr, D1, Wp, B, out,
                      (cudaStream_t)stream);
}
