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
// What bounds it: the walk is a chain.  The band row of diagonal d is
// i - lo[d], and i depends on the pointer read at a diagonal before, so a
// lane's pointer byte cannot be fetched before its walk reaches d.  Read
// from device memory, one byte of a band far larger than L2 a step, that
// chain cost ~1 us a step (the first design, a thread a lane: 3.64 ms on
// the guide batch [7168, 48, 1024] of an H100, 590x its bound).  But the
// walk is in lockstep over d, so the bytes a block of lanes can need at d
// are known before it gets there: the slab ptrs[d, 0:Wp, b0:b0 + 32] and
// lo[d, b0:b0 + 32].
//
// Design: a block owns 32 consecutive lanes.  One walking warp makes the
// moves, a thread a lane; producer warps stream the slabs ahead of it
// through a ring of up to 8 stages in shared memory (as many as the shared
// memory each block of an SM may take: `moves_plan`), a stage a tile of KT
// diagonals (16 up to Wp 64, 8 up to 128, the widest band K1, D and K4
// take).  Tile t holds the diagonals t KT + 1 .. t KT + KT, so its bytes
// of the stream are whole.  A stage is the byte tile of the band's slab
// and the int32 tile of lo; each stage has a "full" barrier the walker
// waits on and an "empty" barrier it arrives on when it is done with the
// stage.  The walker reads only shared memory and waits on the ring only
// at tile edges.  Two copy routes, by the band's alignment:
//   TMA      (B % 16 == 0, band and lo 16-byte aligned): one producer
//            thread asks the tensor memory accelerator for the box
//            [KT][Wp][32] of the band (rows of 32 bytes) and the box
//            [KT][32] of lo; the barrier counts the bytes in.  Boxes past
//            D1 or B read zeros.
//   SHIFTED  (any other B or alignment): four producer warps copy each
//            row of the slab by cp.async as the aligned words that hold
//            its 32 bytes (8 or 9 words, which the odd word count of
//            mk::byte_stride(32) leaves room for) into rows of
//            byte_stride(32) bytes, and lo a word a copy; each producer
//            thread's copies arrive on the full barrier when they land
//            (cp.async.mbarrier.arrive).  The walker reads a row's lane at
//            its byte shift in the first word, ((d Wp + k) B + band
//            address) mod 4.  A word that holds a byte of the band lies in
//            the band's memory page.
// A block walks only from its top, min(D1 - 1, the largest m + n of its
// lanes): above it no lane moves, so the walker writes those bytes as
// 0xFF (four NO_MOVEs) without streaming them.  The guide and realign
// buckets sort their lanes by length (align/guide.py, align/realign.py),
// so most blocks stop far below D1.  At each diagonal the walker finds the
// two bytes its lane may read at the next one (after no move of i, or
// after one) before its own pointer is read, so only a compare and a
// select stand between one shared-memory read and the next; it packs its
// four moves of a byte in a register and stores one byte every fourth
// diagonal, the stores of its lanes coalescing.  On an H100 the walk
// bounds the kernel, at ~35 instructions a diagonal (kernel_ab.py
// probe_traceback: the walk alone takes nearly the whole time, the stream
// alone half or less); 16 lanes a block ran slower at every shape tried,
// and a ring of 16 stages no faster.
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
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned NO_MOVE = 3;
constexpr int TB_LANES = 32;      // lanes a block, a walking thread each
constexpr int TB_MAX_STAGES = 8;
constexpr int TB_COPY_WARPS = 4;  // the cp.async route's producer warps
// The block's shared memory, from its first 128-byte boundary: the stages'
// barriers, a zero word at TB_ZERO, the ring from TB_RING.
constexpr int TB_ZERO = 16 * TB_MAX_STAGES, TB_RING = TB_ZERO + 128;

enum Route { ROUTE_TMA = 0, ROUTE_SHIFTED = 1 };

// Producer warps of a route; the walking warp comes after them.
__host__ __device__ constexpr int tb_producers(int route) {
  return route == ROUTE_TMA ? 1 : TB_COPY_WARPS;
}

// Diagonals a tile (a multiple of 4: whole bytes of the stream).
inline int tb_kt(int Wp) { return Wp <= 64 ? 16 : 8; }

struct MovesArgs {
  const uint8_t* __restrict__ ptrs;  // [D1, Wp, B]
  const int32_t* __restrict__ lo;    // [D1, B]
  const int32_t* __restrict__ m;
  const int32_t* __restrict__ n;
  const int32_t* __restrict__ final_state;  // NW only
  uint8_t* __restrict__ out;                // [ceil((D1 - 1) / 4), B]
  int D1, Wp, B;
  int stages;
  int ptile;  // bytes of a stage's byte tile (a multiple of 128)
  int stage;  // bytes of a stage: the byte tile, then lo's tile
  unsigned shift;  // SHIFTED: the band's address mod 4
};

// The TMA route's tensor maps (zero on the others).
struct MovesMaps {
  CUtensorMap ptrs, lo;
};

// SHIFTED: starts copying rows r0 .. r0 + nrows - 1 of the [rows, B] byte
// array src, lanes b0 .. b0 + 31, as the aligned words that hold them,
// word c of a row at byte 4 c of its row of the tile (rows at
// byte_stride(32)), with the NT producer threads.
template <int NT>
__device__ __forceinline__ void stage_shifted(uint8_t* dst,
                                              const uint8_t* src, size_t r0,
                                              int nrows, int b0, int B) {
  constexpr int S = mk::byte_stride(TB_LANES), W = TB_LANES / 4 + 1;
  const int nl = min(TB_LANES, B - b0);
  for (int q = threadIdx.x; q < nrows * W; q += NT) {
    const int row = q / W, c = q - row * W;
    const uintptr_t first =
        reinterpret_cast<uintptr_t>(src + (r0 + row) * B + b0);
    const uintptr_t word = (first & ~(uintptr_t)3) + 4 * c;
    if (word <= first + nl - 1)
      mk::cp_async4(dst + row * S + 4 * c,
                    reinterpret_cast<const void*>(word));
  }
}

// A lane's walk: its position (i, j), i RS (RS: the tile's row stride)
// and, NW, its state; `at`, the byte it reads at the current diagonal (an
// offset in the block's shared memory: the pointer of its row there, or
// the zero word where the row lies outside [0, Wp)).
struct Walk {
  int i, j, irs, state, at;
};

// The walk of one diagonal d: the lane's move (NO_MOVE where it is not
// active at d), its position and state after it and, where `next`, the
// byte it reads at d - 1, whose row 0 lies at byte c1 less lo1 rows (lo1 =
// lo[d - 1]; sh0 / sh1 its byte shift in the SHIFTED route after no move /
// a move of i).  Both candidate bytes of d - 1 are found before this
// diagonal's pointer is read.
template <bool NW>
__device__ __forceinline__ unsigned walk_step(const uint8_t* raw, Walk& w,
                                              bool act, bool next, int c1,
                                              int lo1, int sh0, int sh1,
                                              int Wp, int RS) {
  const unsigned p = raw[w.at];
  const bool zi = w.i == 0, zj = w.j == 0;
  bool di, dj;
  unsigned mv;
  if (NW) {
    const bool e0 = w.state == 0;
    const int st = e0 & zi ? 1 : (e0 & zj ? 2 : w.state);
    const bool m = st == 0, x = st == 1;
    mv = m ? 0u : (x ? 2u : 1u);
    di = !x;
    dj = m | x;
    const int ns = m ? (int)(p & 3)
                     : (x ? (int)((p >> 2) & 1) : (int)((p >> 3) & 1) * 2);
    w.state = act ? ns : w.state;
  } else {
    // i == 0 forces D, j == 0 forces I; else 0 M, 1 D, any other I.
    di = !zi & (zj | (p != 1));
    dj = zi | (!zj & (p <= 1));
    mv = zi ? 2u : (zj ? 1u : (p == 0 ? 0u : (p == 1 ? 2u : 1u)));
  }
  if (next) {
    const int k0 = w.i - lo1, c = c1 - lo1 * RS + w.irs;
    const int a0 = (unsigned)k0 < (unsigned)Wp ? c + sh0 : TB_ZERO;
    const int a1 = (unsigned)(k0 - 1) < (unsigned)Wp ? c - RS + sh1 : TB_ZERO;
    w.at = act & di ? a1 : a0;
  }
  w.i -= act & di;
  w.irs -= act & di ? RS : 0;
  w.j -= act & dj;
  return act ? mv : NO_MOVE;
}

// Warps 0 .. P - 1 produce (P = tb_producers(ROUTE)), warp P walks; tiles
// of KT diagonals.
template <bool NW, int ROUTE, int KT>
__global__ void __launch_bounds__(32 * (tb_producers(ROUTE) + 1))
    moves_kernel(const __grid_constant__ MovesMaps maps, MovesArgs a) {
  constexpr int LPB = TB_LANES, NP = tb_producers(ROUTE), NT = 32 * NP;
  constexpr int RS = ROUTE == ROUTE_TMA ? LPB : mk::byte_stride(LPB);
  extern __shared__ __align__(16) uint8_t tb_raw[];
  // Barriers, the zero word, then the ring, 128-byte aligned (TMA
  // destinations).
  uint8_t* raw = tb_raw + (128 - mk::smem_addr(tb_raw) % 128) % 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);
  uint64_t* empty = full + TB_MAX_STAGES;
  const int S = a.stages, T = a.D1 - 1, P = (T + 3) / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * LPB, b = b0 + lane;
  const bool live = b < a.B;
  // The block's top (every warp finds it): no lane moves above it.
  const int top = max(0, min(T, (int)__reduce_max_sync(
                                    mk::FULL, live ? a.m[b] + a.n[b] : 0)));
  const int tiles = (top + KT - 1) / KT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mk::mbar_init(full + s, ROUTE == ROUTE_TMA ? 1 : NT);
      mk::mbar_init(empty + s);
    }
    mk::mbar_init_fence();
    *reinterpret_cast<uint32_t*>(raw + TB_ZERO) = 0;
  }
  __syncthreads();

  if (warp < NP) {
    // Producers: tile t = tiles - 1 - it into stage it % S, once the
    // walker has released the tile that stage held.
    if (ROUTE == ROUTE_TMA && threadIdx.x != 0) return;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % S, d0 = (tiles - 1 - it) * KT + 1;
      if (it >= S) mk::mbar_wait(empty + s, (it / S - 1) & 1);
      uint8_t* st = raw + TB_RING + (size_t)s * a.stage;
      int32_t* lt = reinterpret_cast<int32_t*>(st + a.ptile);
      if (ROUTE == ROUTE_TMA) {
        mk::tma_expect(full + s, (unsigned)KT * LPB * (a.Wp + 4));
        mk::tma_load(st, &maps.ptrs, b0, 0, d0, full + s);
        mk::tma_load2(lt, &maps.lo, b0, d0, full + s);
      } else {
        const int nd = min(KT, a.D1 - d0);  // rows past D1 stay unread
        stage_shifted<NT>(st, a.ptrs, (size_t)d0 * a.Wp, nd * a.Wp, b0, a.B);
        for (int q = threadIdx.x; q < nd * LPB; q += NT) {
          const int row = q / LPB, w = q - row * LPB;
          if (b0 + w < a.B)
            mk::cp_async4(lt + q, a.lo + (size_t)(d0 + row) * a.B + b0 + w);
        }
        mk::cp_async_arrive(full + s);
      }
    }
    if (ROUTE != ROUTE_TMA) {
      mk::cp_async_commit();
      mk::cp_async_wait();
    }
    return;
  }

  // The walker.  Bytes above the top tile: no lane moves there.
  for (int q = tiles * (KT / 4); q < P; ++q)
    if (live) a.out[(size_t)q * a.B + b] = 0xFF;
  // A lane past B, or whose m + n lies past D1 - 1, is never active: it
  // starts on diagonal -1.
  const bool walks = live && a.m[b] + a.n[b] <= T;
  Walk w;
  w.i = walks ? a.m[b] : 0;
  w.j = walks ? a.n[b] : -1;
  w.irs = w.i * RS;
  w.state = NW && walks ? a.final_state[b] : 0;
  const int Wp = a.Wp;
  // The byte shift of row k at diagonal d (SHIFTED): (d Wp + k) B + the
  // band's address, mod 4.
  auto shift = [&](int d, int k) -> int {
    return ROUTE == ROUTE_SHIFTED
               ? (int)((a.shift + (unsigned)(d * Wp + k) * (unsigned)a.B) &
                       3u)
               : 0;
  };
  for (int it = 0; it < tiles; ++it) {
    const int s = it % S, t = tiles - 1 - it;
    mk::mbar_wait(full + s, (it / S) & 1);
    const int base = TB_RING + s * a.stage;  // the stage, from raw
    const int32_t* lt =
        reinterpret_cast<const int32_t*>(raw + base + a.ptile);
    int lod[KT];
#pragma unroll
    for (int dd = 0; dd < KT; ++dd) lod[dd] = lt[dd * LPB + lane];
    {  // The byte the lane reads at the tile's top diagonal.
      const int dd = KT - 1, k = w.i - lod[dd];
      w.at = (unsigned)k < (unsigned)Wp
                 ? base + (dd * Wp + k) * RS + lane + shift(t * KT + 1 + dd, k)
                 : TB_ZERO;
    }
#pragma unroll
    for (int qb = KT / 4 - 1; qb >= 0; --qb) {
      const int q = t * (KT / 4) + qb;
      unsigned byte = 0;
#pragma unroll
      for (int s4 = 3; s4 >= 0; --s4) {
        const int dd = 4 * qb + s4, d = t * KT + 1 + dd;
        const int d1 = dd > 0 ? dd - 1 : 0;
        byte |= walk_step<NW>(raw, w, w.i + w.j == d, dd > 0,
                              base + d1 * Wp * RS + lane, lod[d1],
                              shift(d - 1, w.i - lod[d1]),
                              shift(d - 1, w.i - 1 - lod[d1]), Wp, RS)
                << (2 * s4);
      }
      if (live && q < P) a.out[(size_t)q * a.B + b] = (uint8_t)byte;
    }
    __syncwarp();
    if (lane == 0) mk::mbar_arrive(empty + s);
  }
}

template <bool NW, int KT>
const void* moves_kernel_kt(int route) {
  return route == ROUTE_TMA
             ? (const void*)moves_kernel<NW, ROUTE_TMA, KT>
             : (const void*)moves_kernel<NW, ROUTE_SHIFTED, KT>;
}

// A launch's shape: route, tile, ring and shared memory.
struct MovesPlan {
  const void* kernel;
  int route, kt, stages, threads, ptile, stage;
  size_t smem;
};

// The route the band's alignment allows; the tile; the ring's stages, as
// many (2 to 8) as fit the shared memory each of the blocks an SM must
// hold at once may take; the kernel, its shared memory opted in.
cudaError_t moves_plan(bool nw, const void* ptrs, const void* lo, int Wp,
                       int B, MovesPlan* p) {
  if (Wp < 1 || Wp > 128 || B < 1) return cudaErrorInvalidValue;
  int sms = 0, cap = 0;
  cudaError_t err = mk::device_shape(&sms, &cap);
  if (err != cudaSuccess) return err;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(ptrs),
                  la = reinterpret_cast<uintptr_t>(lo);
  const int route = B % 16 == 0 && pa % 16 == 0 && la % 16 == 0 &&
                            mk::tensor_map_encoder() != nullptr
                        ? ROUTE_TMA
                        : ROUTE_SHIFTED;
  const int kt = tb_kt(Wp);
  const int rs = route == ROUTE_TMA ? TB_LANES : mk::byte_stride(TB_LANES);
  const int ptile = (kt * Wp * rs + 127) / 128 * 128;
  const int stage = ptile + kt * TB_LANES * 4;
  const int blocks = (B + TB_LANES - 1) / TB_LANES;
  const int per = std::min(4, std::max(1, (blocks + sms - 1) / sms));
  // An SM holds 228 KB of shared memory, 1 KB of it kept for each block.
  const size_t budget =
      std::min((size_t)cap, (size_t)233472 / per - 1024) - 128 - TB_RING;
  const int stages =
      std::max(2, std::min(TB_MAX_STAGES, (int)(budget / stage)));
  const size_t smem = 128 + TB_RING + (size_t)stages * stage;
  if (smem > (size_t)cap) return cudaErrorInvalidValue;
  const void* kernel = nw ? (kt == 16 ? moves_kernel_kt<true, 16>(route)
                                      : moves_kernel_kt<true, 8>(route))
                          : (kt == 16 ? moves_kernel_kt<false, 16>(route)
                                      : moves_kernel_kt<false, 8>(route));
  *p = MovesPlan{kernel, route, kt, stages, 32 * (tb_producers(route) + 1),
                 ptile, stage, smem};
  return mk::allow_smem(kernel, smem);
}

cudaError_t moves_launch(bool nw, const uint8_t* ptrs, const int32_t* lo,
                         const int32_t* m, const int32_t* n,
                         const int32_t* final_state, int D1, int Wp, int B,
                         uint8_t* out, cudaStream_t stream) {
  if (D1 < 2) return cudaErrorInvalidValue;
  MovesPlan p;
  cudaError_t err = moves_plan(nw, ptrs, lo, Wp, B, &p);
  if (err != cudaSuccess) return err;
  MovesMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (p.route == ROUTE_TMA &&
      !(mk::byte_band_map(&maps.ptrs, ptrs, D1, Wp, B, TB_LANES, p.kt) &&
        mk::lane_rows_map(&maps.lo, lo, D1, B, TB_LANES, p.kt)))
    return cudaErrorInvalidValue;
  MovesArgs a{ptrs, lo, m, n, final_state, out, D1, Wp, B, p.stages,
              p.ptile, p.stage,
              (unsigned)(reinterpret_cast<uintptr_t>(ptrs) & 3)};
  void* args[] = {&maps, &a};
  return cudaLaunchKernel(p.kernel, dim3((B + TB_LANES - 1) / TB_LANES),
                          dim3(p.threads), args, p.smem, stream);
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

// What a launch of nw_moves (nw 1) or mea_moves over B lanes at band width
// Wp gets on this device, its band and lo 16-byte aligned (a band at
// another offset takes the SHIFTED route whatever B):
// mk::kernel_info's out[5], then the diagonals a tile, the ring's stages,
// the route (0 TMA, 1 SHIFTED) and the lanes a block.
extern "C" int moves_info(int nw, int Wp, int B, int* out) {
  MovesPlan p;
  cudaError_t err = moves_plan(nw != 0, nullptr, nullptr, Wp, B, &p);
  if (err != cudaSuccess) return err;
  out[5] = p.kt;
  out[6] = p.stages;
  out[7] = p.route;
  out[8] = TB_LANES;
  return mk::kernel_info(p.kernel, p.smem, p.threads, out);
}
