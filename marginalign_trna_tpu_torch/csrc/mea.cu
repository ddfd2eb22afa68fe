// Banded maximum-expected-accuracy (AMAP) decode: max-plus over the
// diagonal (posterior match weight), left (ref-skip) and up (read-skip)
// moves, with pointers 0 = diag, 1 = left, 2 = up.
//
// One recursion, two weight sources, one warp per lane:
//   banded_mea (K4) <- marginalign_trna_tpu/ops/wavefront_pallas.py
//                      `_mea_kernel` (`banded_mea_pallas`): the weights come
//                      materialised as three [D1, Wp, B] bands, with the
//                      valid band and the s1/s2 shift streams.
//   mea_multi       <- `_mea_kernel_multi` (`banded_mea_pallas_multi`): the
//                      same weights over lanes holding several problems
//                      (ops/band.py `pack_multi_banded_batch`): the score
//                      frontier starts at NEG, the SPACER empty diagonals
//                      push it back to NEG, row 0 is seeded with 0 (pointer
//                      0) where `start` marks a problem's local d = 0, and
//                      on a diagonal `find` marks terminal the score at row
//                      `fink` leaves as max(value, NEG) in term [D1, B],
//                      NEG on every other diagonal.
//   mea_dl (D)      <- `_mea_kernel_dl` (`_mea_dl_jit`): the weights come
//                      from the raw posterior band and the per-position
//                      posterior row / column sums accr [rgm, B] /
//                      accc [rgn, B]:
//                        wdiag = post if post >= matchGamma and post > 0,
//                                else NEG
//                        wup   = i >= 1 ? gapGamma * clip(1 - accr[i-1]) : 0
//                        wleft = j >= 1 ? gapGamma * clip(1 - accc[j-1]) : 0
//                      (i = lo(d) + k, j = d - i; indices clipped to the
//                      sums' last rows), and valid, s1, s2 from lo, m, n,
//                      width.
// Same arithmetic as the TPU kernels: no normalisation, circular row
// shifts, first-max-wins ties in the order diag, left, up, and the terminal
// score read at (final_d, final_k) as max(value, NEG) (mea_multi: at each
// problem's terminal cell).
//
// What bounds them on an H100: K4 streams 13 B per cell (three f32 weight
// bands and the valid byte in, one pointer byte out), D 5 B (the posterior
// and the pointer) against ~6 adds and compares (D ~15 with its masks), so
// at full occupancy they would be bound by device memory; before that, the
// chain of D1 dependent diagonals and how many chains run at once.
//   K4 runs one warp per lane (common.cuh's warp-per-lane layout,
//     consecutive rows a thread), as K1 does: both score generations in
//     registers, a row shift one shuffle of the edge row, no barrier on a
//     diagonal.  A block of 8, 16 or 32 lanes (`mea_lanes`: the widest that
//     leaves no SM idle, so the REL path's 1024 lanes spread over 128
//     blocks of 8) stages a tile of diagonals (8, or 4 at three or four
//     rows a thread) while it computes the previous tile, its pointers
//     leaving through shared memory as lane rows: one barrier a tile.  The
//     three weight bands are 12 of K4's 13 bytes a cell, and copying them
//     with cp.async, 4 bytes a lane and row, bound it (the copies alone
//     took 0.86 of 0.95 ms at [3072, 24, 1024] on an H100); the tensor
//     memory accelerator brings each tile's three boxes instead (B a
//     multiple of 4, Wp <= 64; `mea_tma`, `mea_map`), one thread asking, a
//     barrier counting the bytes in: 0.76 ms there, 1.71 at [3072, 24,
//     4096] (2.40 by cp.async), against 1.75 and 2.26 for the first design
//     (a block per 32 lanes, a barrier a diagonal, 32 blocks on 132 SMs at
//     1024 lanes).
//   mea_multi is K4's kernel with the MULTI flag: a tile also stages the
//     start flags as a byte tile and fink / find as per-lane records, every
//     diagonal is a step (the frontier starts at NEG; row 0 seeded where a
//     problem starts), and the terminal scores leave through a per-lane
//     record filled with NEG each tile and written by the thread holding
//     row fink.
//   D runs one warp per lane (common.cuh), as the TPU kernel's delay line
//     asks: both score generations and the two band windows of gap weights
//     stay in registers.  Where the band's lower edge steps (s1 = 1) the up
//     window rolls up one row and the closed-form weight of read row
//     lo(d) + Wp - 1 enters at the top; where it does not (s1 = 0) the left
//     window rolls down and that of ref column d - lo(d) enters at row 0;
//     every other row keeps its position's weight, so the window holds the
//     closed form on every row (rows i = 0 and j <= 0 and the clips
//     included), seeded from it at d = 1 (and wherever lo moves by other
//     than 0 or 1).  That is two scattered loads of the sums a
//     lane-diagonal, copied with the tile's posterior, instead of 2 Wp.  A
//     block of 8 or 16 lanes stages 8 diagonals of the posterior, the
//     entering sums and lo by cp.async while it computes the previous 8,
//     its pointers leaving through shared memory: one barrier per 8
//     diagonals.  On an H100 at [3072, 24, 4096] that took 2.26 ms against
//     a 0.48 ms byte bound (kernel_ab.py): the warps' serial chains of
//     instructions a diagonal (without the row shuffles 33% faster,
//     without device memory 17%); loading every gap weight from the sums
//     instead of the delay line took 1.8x as long.
#include <string.h>

#include "common.cuh"

namespace {

using mk::NEG;

// The weights as materialised bands (K4 and mea_multi).
struct BandWeights {
  const float* __restrict__ wdiag;
  const float* __restrict__ wup;
  const float* __restrict__ wleft;
  const uint8_t* __restrict__ valid;
  const int32_t* __restrict__ s1;
  const int32_t* __restrict__ s2;
  int Wp, B;
};

// ----------------------------------------- K4, mea_multi: warp per lane

// Diagonals a tile: 8 up to Wp 64 (rpt rows a thread of t threads a lane
// cover the band), 4 above, so that the ring of weight tiles of 8 lanes
// still fits a block at Wp 128.
__host__ __device__ constexpr int mea_kt_rpt(int rpt, int t = 32) {
  return rpt * t <= 64 ? 8 : 4;
}
constexpr int MEA_STAGES = 2;  // input tiles: the one computed, 1 in flight

// A tile's inputs in shared memory: the three weight planes (wdiag, wup,
// wleft), the shifts s1, s2 [LPB][KT], and the valid band as a byte tile
// (mk::byte_stride's layout); multi lanes add fink and find [LPB][KT] and
// the start flags as a byte tile st [KT] rows.  A weight plane comes in one
// of two layouts:
//   TMA (B a multiple of 4, Wp <= 64): the tensor memory accelerator copies
//     the box [KT][Wp][LPB] of each band as it lies in device memory, lanes
//     fastest, its 16-byte pieces swizzled by the row's low bits (the
//     map's 32, 64 or 128-byte swizzle at LPB 8, 16, 32), so that the 32
//     rows of one lane a warp reads fall on 8 banks (4-way conflicts, not
//     LPB-way); a plane takes a multiple of 1024 bytes, 1024-aligned;
//   else cp.async, 4 bytes a lane and row: [LPB][mea_stride] floats, lane
//     w's row k of tile diagonal kb at w * stride + kb * Wp + k, the
//     stride odd so that a warp reading its lane's rows touches 32 banks.
struct MeaIn {
  float* w;
  int32_t* s1;
  int32_t* s2;
  uint8_t* v;
  int32_t* fk;
  int32_t* fd;
  uint8_t* st;
};

__host__ __device__ inline int mea_stride(int Wp, int kt) {
  return kt * Wp + 1;
}
// Floats of one weight plane of a stage.
__host__ __device__ inline size_t mea_wplane(int Wp, int kt, int lpb,
                                             bool tma) {
  return tma ? ((size_t)kt * Wp * lpb + 255) / 256 * 256
             : (size_t)lpb * mea_stride(Wp, kt);
}
__host__ __device__ inline size_t mea_bplane(int Wp, int kt, int lpb) {
  return (size_t)kt * Wp * mk::byte_stride(lpb);
}
// One stage buffer, rounded up to 1024 bytes with TMA, else to 16.
__host__ __device__ inline size_t mea_in_bytes(int Wp, int kt, int lpb,
                                               bool tma, bool multi) {
  const size_t a = tma ? 1024 : 16;
  const size_t b = (3 * mea_wplane(Wp, kt, lpb, tma) + 2 * (size_t)lpb * kt) *
                       4 + mea_bplane(Wp, kt, lpb) +
                   (multi ? 8 * (size_t)lpb * kt + kt * mk::byte_stride(lpb)
                          : 0);
  return (b + a - 1) / a * a;
}
// An output tile: the pointer plane and, for multi lanes, the terminal
// record [KT][LPB].
__host__ __device__ inline size_t mea_out_bytes(int Wp, int kt, int lpb,
                                                bool multi) {
  return mea_bplane(Wp, kt, lpb) + (multi ? 4 * (size_t)kt * lpb : 0);
}
// MEA_STAGES stage buffers and two output tiles; with TMA 1024 bytes to
// align the stages and the stages' barriers.
inline size_t mea_smem(int Wp, int lpb, bool tma, bool multi) {
  const int kt = mea_kt_rpt(mk::rows_per_thread(Wp));
  return (tma ? 1024 + 8 * MEA_STAGES : 0) +
         MEA_STAGES * mea_in_bytes(Wp, kt, lpb, tma, multi) +
         2 * mea_out_bytes(Wp, kt, lpb, multi);
}

__device__ inline MeaIn mea_in(uint8_t* p, int Wp, int kt, int lpb,
                               bool tma) {
  float* w = reinterpret_cast<float*>(p);
  int32_t* s =
      reinterpret_cast<int32_t*>(w + 3 * mea_wplane(Wp, kt, lpb, tma));
  uint8_t* v = reinterpret_cast<uint8_t*>(s + 2 * lpb * kt);
  int32_t* f = reinterpret_cast<int32_t*>(v + mea_bplane(Wp, kt, lpb));
  return MeaIn{w, s, s + lpb * kt, v, f, f + lpb * kt,
               reinterpret_cast<uint8_t*>(f + 2 * lpb * kt)};
}

// The three weight bands' tensor maps for TMA (unused by cp.async).
struct MeaMaps {
  CUtensorMap wd, wu, wl;
};

// Starts the copy of diagonals d0 .. d0 + n - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into S (the caller commits the cp.async group).  TMA:
// thread 0 asks for the three weight boxes, to arrive on barrier bar;
// cp.async: thread tid of the NT copies lane tid % LPB of rows tid / LPB +
// NT / LPB i of each weight band, so a warp moves 32 / LPB rows of LPB
// lanes a step.  The shifts, the valid bytes and multi lanes' records and
// start flags take cp.async either way.
template <int LPB, int KT, bool TMA, bool MULTI, int NT>
__device__ __forceinline__ void mea_stage(const MeaIn& S, const BandWeights& w,
                                          const mk::MultiSteps& ms,
                                          const MeaMaps& maps, uint64_t* bar,
                                          int d0, int n, int b0, bool vec) {
  const int Wp = w.Wp, B = w.B;
  const int l = threadIdx.x % LPB, b = b0 + l;
  const size_t plane = mea_wplane(Wp, KT, LPB, TMA);
  if (TMA) {
    if (threadIdx.x == 0) {
      mk::tma_expect(bar, 3u * KT * Wp * LPB * 4);
      const CUtensorMap* m[3] = {&maps.wd, &maps.wu, &maps.wl};
#pragma unroll
      for (int q = 0; q < 3; ++q)
        mk::tma_load(S.w + q * plane, m[q], b0, 0, d0, bar);
    }
  } else if (b < B) {
    const size_t g = (size_t)d0 * Wp * B + b;
    float* s = S.w + l * mea_stride(Wp, KT);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += NT / LPB) {
      const size_t o = g + (size_t)r * B;
      mk::cp_async4(s + r, w.wdiag + o);
      mk::cp_async4(s + plane + r, w.wup + o);
      mk::cp_async4(s + 2 * plane + r, w.wleft + o);
    }
  }
  const int kb = threadIdx.x / LPB;
  if (kb < n && b < B) {
    const size_t o = (size_t)(d0 + kb) * B + b;
    mk::cp_async4(S.s1 + l * KT + kb, w.s1 + o);
    mk::cp_async4(S.s2 + l * KT + kb, w.s2 + o);
    if (MULTI) {
      mk::cp_async4(S.fk + l * KT + kb, ms.fink + o);
      mk::cp_async4(S.fd + l * KT + kb, ms.find + o);
    }
  }
  mk::stage_bytes<LPB, NT>(S.v, w.valid, (size_t)d0 * Wp, n * Wp, b0, B,
                           vec);
  if (MULTI) mk::stage_bytes<LPB, NT>(S.st, ms.start, d0, n, b0, B, vec);
}

// The decode of one lane (rows as mk::WarpRows): both score generations in
// registers, a row shift one shuffle of the edge row.  A full tile runs
// unrolled, each diagonal's inputs read from the stage buffer one diagonal
// ahead, with no branch on the warp's chain of diagonals; the first (K4)
// and a partial last tile run a rolled loop.  MULTI: the frontier starts at
// NEG and every diagonal is a step; row 0 is seeded where a problem
// starts, and the score at a terminal row goes to the tile's record.  A
// lane takes T threads (mk::WarpRows).
template <int RPT, int LPB, bool TMA, bool MULTI, int T>
struct MeaWarp {
  static constexpr int SB = mk::byte_stride(LPB);
  static constexpr int KT = mea_kt_rpt(RPT, T);
  // One diagonal's inputs (rows past the band read row Wp - 1: their
  // results are never read); multi lanes: `mk::pack_steps` of the start
  // flag and the terminal row.
  struct In {
    float wd[RPT], wu[RPT], wl[RPT];
    bool v[RPT];
    int t1, t2;
    int steps;
  };
  mk::WarpRows<RPT, T, MULTI> rows;
  int Wp, fd, fk, stride;
  size_t plane;
  float a1[RPT], a2[RPT];  // scores of d - 1, d - 2
  float tscore = NEG;      // the score at the terminal
  bool hit = false;        // whether this thread holds it

  __device__ MeaWarp(int Wp_, int fd_, int fk_)
      : rows(Wp_), Wp(Wp_), fd(fd_), fk(fk_), stride(mea_stride(Wp_, KT)),
        plane(mea_wplane(Wp_, KT, LPB, TMA)) {
    if (MULTI) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) a1[r] = a2[r] = NEG;
    }
  }

  __device__ int row(int r) const { return rows.row(r); }

  __device__ __forceinline__ In load(const MeaIn& S, int w, int kb) const {
    In a;
    const uint8_t* v = S.v + kb * Wp * SB + w;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = min(row(r), Wp - 1);
      const int o = TMA ? mk::swizzled<LPB>(kb * Wp + k, w)
                        : w * stride + kb * Wp + k;
      a.wd[r] = S.w[o];
      a.wu[r] = S.w[plane + o];
      a.wl[r] = S.w[2 * plane + o];
      a.v[r] = v[k * SB] != 0;
    }
    a.t1 = S.s1[w * KT + kb];
    a.t2 = S.s2[w * KT + kb];
    if (MULTI) a.steps = S.fk[w * KT + kb];
    return a;
  }

  // Diagonals d0 .. d0 + n - 1 of lane w from stage buffer S into the
  // pointer tile out (multi lanes: the terminal record rec).
  __device__ __forceinline__ void tile(const MeaIn& S, uint8_t* out,
                                       float* rec, int w, int d0, int n) {
    int kb = 0;
    if (MULTI) {
      // Each diagonal's start flag and terminal row packed in place of its
      // fink; the lane's record holds NEG but on terminal diagonals.
      if (rows.kk < n) {
        S.fk[w * KT + rows.kk] =
            mk::pack_steps(S.st[rows.kk * SB + w], S.fk[w * KT + rows.kk],
                           S.fd[w * KT + rows.kk]);
        rec[rows.kk * LPB + w] = NEG;
      }
      __syncwarp();
    } else if (d0 == 0) {
      // d = 0 is pure initialisation: 0 at row 0; d - 1 holds NEG.
      float na[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        na[r] = row(r) == 0 ? 0.f : NEG;
        a2[r] = NEG;
        if (row(r) < Wp) out[row(r) * SB + w] = 0;
      }
      publish(0, na);
      kb = 1;
    }
    if (kb == 0 && n == KT) {
      In cur = load(S, w, 0);
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const In next = load(S, w, q + 1 < KT ? q + 1 : q);
        step(d0 + q, cur, out + q * Wp * SB + w, rec + q * LPB + w);
        cur = next;
      }
    } else {
      for (; kb < n; ++kb)
        step(d0 + kb, load(S, w, kb), out + kb * Wp * SB + w,
             rec + kb * LPB + w);
    }
  }

  // Generation d from its inputs a; pointers at row k go to ptr[k * SB], a
  // multi lane's terminal score to *term.  Diag from d - 2 at row shift
  // s2 - 1, left (ref skip) from d - 1 at shift s1, up (read skip) at shift
  // s1 - 1: at most one of the two moves, so d - 1 rolls once.
  __device__ __forceinline__ void step(int d, const In& a, uint8_t* ptr,
                                       float* term) {
    const mk::GapMove g(a.t1);
    float ar[RPT], dg[RPT], na[RPT];
    rows.roll(a1, ar, g.by);
    rows.roll(a2, dg, mk::diag_move(a.t2));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float diag = dg[r] + a.wd[r];
      const float left = (g.left ? ar[r] : a1[r]) + a.wl[r];
      const float up = (g.up ? ar[r] : a1[r]) + a.wu[r];
      int am;
      const float val = mk::max_argmax3(diag, left, up, am);
      na[r] = a.v[r] ? val : NEG;
      if (MULTI) {
        const bool seed = mk::seeds(a.steps) & (row(r) == 0);
        na[r] = seed ? 0.f : na[r];
        am = seed ? 0 : am;
      }
      if (row(r) < Wp) ptr[row(r) * SB] = (uint8_t)am;
      a2[r] = a1[r];
      if (MULTI && mk::ends_at(a.steps, row(r)) & (row(r) < Wp))
        *term = fmaxf(na[r], NEG);
    }
    publish(d, na);
  }

  // Generation d becomes d - 1; the score at the lane's terminal is kept
  // (one problem a lane).
  __device__ __forceinline__ void publish(int d, const float (&na)[RPT]) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      a1[r] = na[r];
      if (!MULTI) {
        const bool at = (d == fd) & (row(r) == fk) & (fk < Wp);
        tscore = at ? na[r] : tscore;
        hit = hit | at;
      }
    }
  }

  // The lane's score, from the thread that kept it; NEG where the lane's
  // terminal lies on no diagonal of the band (the plain version's default).
  __device__ void finish(float* score) const {
    const unsigned any = __ballot_sync(mk::FULL, hit);
    if (hit) *score = fmaxf(tscore, NEG);
    else if (any == 0 && rows.kk == 0) *score = NEG;
  }
};

// K4 (final_d, final_k, score; ms null) or, MULTI, mea_multi (ms; the
// single-problem arguments null); T threads a lane, LPB lanes a block.
template <int RPT, int LPB, bool TMA, bool MULTI, int T>
__global__ void __launch_bounds__(T * LPB)
    mea_warp_kernel(BandWeights wts, const __grid_constant__ MeaMaps maps,
                    const int32_t* __restrict__ final_d,
                    const int32_t* __restrict__ final_k, mk::MultiSteps ms,
                    int D1, int vec, uint8_t* __restrict__ ptr,
                    float* __restrict__ score) {
  constexpr int KT = mea_kt_rpt(RPT, T), NT = T * LPB;
  extern __shared__ __align__(16) uint8_t mea_raw[];
  const int Wp = wts.Wp, B = wts.B;
  // TMA: the stages start 1024-aligned in the shared window, their
  // barriers after the output tiles.
  uint8_t* raw =
      TMA ? mea_raw + ((1024 - mk::smem_addr(mea_raw) % 1024) % 1024)
          : mea_raw;
  const size_t nin = mea_in_bytes(Wp, KT, LPB, TMA, MULTI),
               nout = mea_out_bytes(Wp, KT, LPB, MULTI);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      raw + MEA_STAGES * nin + (2 * nout + 7) / 8 * 8);
  const int w = threadIdx.x / T;  // the thread's lane in the block
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  // Whether the warp's first lane is in the batch: warp-uniform (a lane
  // past B beside a live one computes on stale tiles and writes nothing).
  const bool live = b0 + (int)(threadIdx.x >> 5) * (32 / T) < B;
  const int tiles = (D1 + KT - 1) / KT;
  // Stage buffer of tile t (t mod MEA_STAGES), output tile (by parity): the
  // pointer plane, then the terminal record.
  auto in = [&](int t) {
    return mea_in(raw + (t % MEA_STAGES) * nin, Wp, KT, LPB, TMA);
  };
  auto out = [&](int t) { return raw + MEA_STAGES * nin + (t & 1) * nout; };
  auto rec = [&](int t) {
    return reinterpret_cast<float*>(out(t) + mea_bplane(Wp, KT, LPB));
  };
  // One cp.async group a tile, empty past the last, so that wait_but counts
  // tiles.
  auto stage = [&](int t) {
    if (t < tiles)
      mea_stage<LPB, KT, TMA, MULTI, NT>(in(t), wts, ms, maps,
                                         bars + t % MEA_STAGES, t * KT,
                                         min(KT, D1 - t * KT), b0, vec);
    mk::cp_async_commit();
  };
  auto flush = [&](int t) {
    const int d0 = t * KT, n = min(KT, D1 - d0);
    mk::flush_bytes<LPB, NT>(ptr, out(t), (size_t)d0 * Wp, n * Wp, b0, B,
                             vec);
    if (MULTI)
      mk::flush_records<LPB, 1, KT, NT>(ms.term, rec(t), d0, n, D1, b0, B);
  };
  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < MEA_STAGES; ++s) mk::mbar_init(bars + s);
    mk::mbar_init_fence();
  }
  if (TMA) __syncthreads();
  MeaWarp<RPT, LPB, TMA, MULTI, T> lane(
      Wp, live && !MULTI ? final_d[b] : -1, live && !MULTI ? final_k[b] : -1);
  for (int t = 0; t < MEA_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (this thread's copies and, with TMA, the barrier's
    // phase t / MEA_STAGES, then everyone's), every warp is past tile
    // t - 1, whose outputs leave now and whose stage buffer takes tile
    // t + MEA_STAGES - 1.
    mk::cp_async_wait_but<MEA_STAGES - 2>();
    if (TMA) mk::mbar_wait(bars + t % MEA_STAGES, (t / MEA_STAGES) & 1);
    __syncthreads();
    if (t > 0) flush(t - 1);
    stage(t + MEA_STAGES - 1);
    if (live)
      lane.tile(in(t), out(t), rec(t), w, t * KT, min(KT, D1 - t * KT));
  }
  __syncthreads();
  flush(tiles - 1);
  if (live && !MULTI) lane.finish(score + b);
}

// The instance at RPT = rpt rows a thread (TMA only up to Wp 64:
// `mea_tma`; half a warp a lane only up to two rows a thread; mea_multi
// at a warp a lane only above Wp 32: at one row a thread its unrolled TMA
// tiles spilled).
template <int LPB, bool TMA, bool MULTI, int T>
const void* mea_kernel_rpt(int rpt) {
  if constexpr (!MULTI || T < 32)
    if (rpt == 1) return (const void*)mea_warp_kernel<1, LPB, TMA, MULTI, T>;
  if (rpt == 2) return (const void*)mea_warp_kernel<2, LPB, TMA, MULTI, T>;
  if constexpr (T == 32 && !TMA) {
    if (rpt == 3) return (const void*)mea_warp_kernel<3, LPB, false, MULTI, 32>;
    if (rpt == 4) return (const void*)mea_warp_kernel<4, LPB, false, MULTI, 32>;
  }
  return nullptr;
}

// Threads a lane: mea_multi gives a lane half a warp up to Wp 32 (two lanes
// a warp, ceil(Wp / 16) rows a thread); a warp a lane above, as K4 always.
// On an H100 at [1024, 24, 4096] half a warp took 0.559 ms, a warp 0.725
// (kernel_ab.py); at Wp 48 half a warp's weight tiles leave one block of 8
// warps an SM.
inline int mea_threads(int Wp, bool multi) {
  return multi && Wp <= 32 ? 16 : 32;
}

template <int LPB, bool MULTI, int T>
const void* mea_kernel_tma(int rpt, bool tma) {
  return tma ? mea_kernel_rpt<LPB, true, MULTI, T>(rpt)
             : mea_kernel_rpt<LPB, false, MULTI, T>(rpt);
}

// The kernel of K4 (mea_multi) with LPB lanes a block at (Wp, tma).
template <int LPB>
const void* mea_kernel_of(int Wp, bool tma, bool multi) {
  const int rpt = mk::rows_per_thread(Wp);
  if (mea_threads(Wp, multi) == 16) {
    if constexpr (LPB >= 16)
      return mea_kernel_tma<LPB, true, 16>((Wp + 15) / 16, tma);
    return nullptr;
  }
  if constexpr (LPB == 32)  // 1024 threads: K4 at one row a thread only
    return rpt != 1 || multi
               ? nullptr
               : (tma ? (const void*)mea_warp_kernel<1, 32, true, false, 32>
                      : (const void*)mea_warp_kernel<1, 32, false, false, 32>);
  else
    return multi ? mea_kernel_tma<LPB, true, 32>(rpt, tma)
                 : mea_kernel_tma<LPB, false, 32>(rpt, tma);
}

// Whether K4's (mea_multi's) launch at (Wp, B) takes TMA: B a multiple of
// 4 (the maps' row strides are multiples of 16 bytes), at most two rows a
// thread, and the maps can be encoded.  At three and four rows a thread the
// swizzled planes' 4-way bank conflicts cost more than TMA saves: on an
// H100 at Wp 96 / 128 over 1024 lanes TMA took 3.93 / 5.02 ms, cp.async
// 3.67 / 4.51 (kernel_ab.py).
bool mea_tma(int Wp, int B) {
  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&
         mk::tensor_map_encoder() != nullptr;
}

// The tensor map of one weight band [D1, Wp, B] for K4's (mea_multi's)
// boxes.
bool mea_map(CUtensorMap* m, const float* band, int D1, int Wp, int B,
             int lpb) {
  return mk::band_map(m, band, D1, Wp, B, lpb,
                      mea_kt_rpt(mk::rows_per_thread(Wp)));
}

// K4's lanes a block on the current device: the most of 32, 16 and 8 whose
// block fits shared memory and whose blocks still reach 15/16 of the SMs;
// 32 (1024 threads, 64 registers) only at one row a thread.  Wider blocks
// copy wider weight rows, and the copies bound K4 where the SMs are full,
// so wider wins as long as no SM idles: on an H100 (kernel_ab.py
// probe_mea) [3072, 24, 4096] took 1.71 ms at 32 lanes, 2.02 at 16, 5.79 at
// 8; [512, 24, 2048] 0.173 at 16, 0.184 at 8; [3072, 24, 1024] 0.76 at 8,
// 1.02 at 16 (64 blocks).  mk::warp_lanes (16 from 16 x SMs lanes on)
// would leave 2048 lanes at 8 and 4096 at 16.  mea_multi takes the same
// rule; at half a warp a lane its blocks of 32 lanes take 512 threads at
// any rows a thread, and it takes no fewer than 16.
cudaError_t mea_lanes(int Wp, int B, bool tma, bool multi, int* lanes) {
  int sms = 0, cap = 0;
  cudaError_t err = mk::device_shape(&sms, &cap);
  if (err != cudaSuccess) return err;
  const bool half = mea_threads(Wp, multi) == 16;
  for (int l = 32; l >= (half ? 16 : 8); l /= 2) {
    if (l == 32 && !half && mk::rows_per_thread(Wp) > 1) continue;
    if (mea_smem(Wp, l, tma, multi) > (size_t)cap) continue;
    if (l > (half ? 16 : 8) && !mk::fills(B, l, sms)) continue;
    *lanes = l;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// The kernel, lanes a block (mea_lanes) and shared memory of K4's
// (mea_multi's) launch at (Wp, B) with or without TMA, its shared memory
// opted in.
cudaError_t mea_setup(int Wp, int B, bool tma, bool multi,
                      const void** kernel, int* lanes, size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  cudaError_t err = mea_lanes(Wp, B, tma, multi, lanes);
  if (err != cudaSuccess) return err;
  switch (*lanes) {
    case 8: *kernel = mea_kernel_of<8>(Wp, tma, multi); break;
    case 16: *kernel = mea_kernel_of<16>(Wp, tma, multi); break;
    case 32: *kernel = mea_kernel_of<32>(Wp, tma, multi); break;
    default: return cudaErrorInvalidValue;
  }
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = mea_smem(Wp, *lanes, tma, multi);
  return mk::allow_smem(*kernel, *smem);
}

// Launches K4 or mea_multi (ms.term non-null): TMA where mea_tma allows it
// and the bands' maps encode, else cp.async.
cudaError_t mea_launch(const BandWeights& w, const int32_t* final_d,
                       const int32_t* final_k, mk::MultiSteps ms, int D1,
                       uint8_t* ptr, float* score, cudaStream_t stream) {
  const int Wp = w.Wp, B = w.B;
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const bool multi = ms.term != nullptr;
  const void* kernel;
  int lanes;
  size_t smem;
  MeaMaps maps;
  memset(&maps, 0, sizeof(maps));
  bool tma = mea_tma(Wp, B);
  cudaError_t err = mea_setup(Wp, B, tma, multi, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  if (tma && !(mea_map(&maps.wd, w.wdiag, D1, Wp, B, lanes) &&
               mea_map(&maps.wu, w.wup, D1, Wp, B, lanes) &&
               mea_map(&maps.wl, w.wleft, D1, Wp, B, lanes))) {
    tma = false;
    err = mea_setup(Wp, B, tma, multi, &kernel, &lanes, &smem);
    if (err != cudaSuccess) return err;
  }
  BandWeights wts = w;
  int vec = mk::words_aligned(B, {w.valid, ptr, ms.start});
  void* args[] = {&wts, &maps, &final_d, &final_k, &ms,
                  &D1,  &vec,  &ptr,     &score};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(mea_threads(Wp, multi) * lanes), args, smem,
                          stream);
}

// What K4's (mea_multi's) launch at band width Wp over B lanes gets on this
// device (mk::kernel_info's out[5] and out[5], its lanes a block), with
// TMA where B allows it.
cudaError_t mea_info(int Wp, int B, bool multi, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err =
      mea_setup(Wp, B, mea_tma(Wp, B), multi, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  out[5] = lanes;
  return mk::kernel_info(kernel, smem, mea_threads(Wp, multi) * lanes, out);
}

// ------------------------------------------------------ D: warp per lane

constexpr int DL_KT = 8;      // diagonals a tile
constexpr int DL_STAGES = 2;  // tiles in shared memory: 1 computed, 1 in flight

// The posterior sums and what the gap weights take from them.
struct DlSums {
  const float* __restrict__ accr;  // [rgm, B], read positions
  const float* __restrict__ accc;  // [rgn, B], ref positions
  int B, rgm, rgn;
  float gap_gamma;

  __device__ float gap(float sum) const {
    return gap_gamma * fminf(fmaxf(1.f - sum, 0.f), 1.f);
  }
  // The sums behind wup at read row i (i >= 1) and wleft at ref column j
  // (j >= 1), clipped to the last rows.
  __device__ const float* row_sum(int i, int b) const {
    return accr + (size_t)min(i - 1, rgm - 1) * B + b;
  }
  __device__ const float* col_sum(int j, int b) const {
    return accc + (size_t)min(j - 1, rgn - 1) * B + b;
  }
  __device__ float wup(int i, int b) const {
    return i >= 1 ? gap(*row_sum(i, b)) : 0.f;
  }
  __device__ float wleft(int j, int b) const {
    return j >= 1 ? gap(*col_sum(j, b)) : 0.f;
  }
};

// Shared memory of a block, a ring of DL_STAGES tiles: posterior tiles
// [LPB][dl_stride(Wp)] (lane w's row k of tile diagonal kb at w * stride +
// kb * Wp + k: a warp reads its lane's rows without bank conflicts), the
// sums entering at each diagonal [LPB][DL_KT][2] (read row lo(d) + Wp - 1,
// ref column d - lo(d)); lo tiles [DL_LO][LPB][DL_KT], staged DL_STAGES - 1
// tiles ahead of the posterior because the entering sums' addresses come
// from lo; and two pointer tiles (mk::byte_stride's layout).
constexpr int DL_LO = 2 * DL_STAGES - 1;
__host__ __device__ inline int dl_stride(int Wp) { return DL_KT * Wp + 1; }
__host__ __device__ inline size_t dl_post_floats(int Wp, int lpb) {
  return (size_t)lpb * dl_stride(Wp);
}
__host__ __device__ inline size_t dl_plane(int Wp, int lpb) {
  return (size_t)DL_KT * Wp * mk::byte_stride(lpb);
}
inline size_t dl_smem(int Wp, int lpb) {
  return (DL_STAGES * (dl_post_floats(Wp, lpb) + 2 * lpb * DL_KT) +
          DL_LO * lpb * DL_KT) * sizeof(float) +
         2 * dl_plane(Wp, lpb);
}

// Starts the copy of the posterior rows of diagonals d0 .. d0 + n - 1 of
// the block's lanes into dst: thread tid copies lane tid % LPB of rows
// tid / LPB + 32 i, so a warp moves 32 / LPB rows of LPB lanes a step.
template <int LPB>
__device__ __forceinline__ void dl_stage_post(float* dst,
                                              const float* __restrict__ post,
                                              int d0, int n, int b0, int Wp,
                                              int B) {
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b >= B) return;
  const size_t g = (size_t)d0 * Wp * B + b;
  float* s = dst + w * dl_stride(Wp);
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
    mk::cp_async4(s + r, post + g + (size_t)r * B);
}

// Starts the copy of lo at diagonals d0 .. d0 + n - 1 into dst [LPB][DL_KT].
template <int LPB>
__device__ __forceinline__ void dl_stage_lo(int32_t* dst,
                                            const int32_t* __restrict__ lo,
                                            int d0, int n, int b0, int B) {
  const int w = threadIdx.x % LPB, kb = threadIdx.x / LPB;
  if (kb < n && b0 + w < B)
    mk::cp_async4(dst + w * DL_KT + kb, lo + (size_t)(d0 + kb) * B + b0 + w);
}

// Starts the copy of the sums entering at diagonals d0 .. d0 + n - 1 (lo at
// them in los, landed) into dst [LPB][DL_KT][2]; a position that does not
// exist (i < 1 or j < 1) copies nothing.
template <int LPB>
__device__ __forceinline__ void dl_stage_entering(float* dst,
                                                  const int32_t* los, int d0,
                                                  int n, int b0, int Wp,
                                                  const DlSums& S) {
  const int w = threadIdx.x % LPB, kb = threadIdx.x / LPB, b = b0 + w;
  if (kb >= n || b >= S.B) return;
  const int l = los[w * DL_KT + kb];
  const int i = l + Wp - 1, j = d0 + kb - l;
  float* e = dst + 2 * (w * DL_KT + kb);
  if (i >= 1) mk::cp_async4(e, S.row_sum(i, b));
  if (j >= 1) mk::cp_async4(e + 1, S.col_sum(j, b));
}

// The decode of one lane (rows as mk::WarpRows).  Each diagonal's inputs
// are read from the stage buffers one diagonal ahead, and at one row a
// thread (Wp <= 32) tiles whose band edge moves by 0 or 1 row a diagonal
// run unrolled with no branch, so that a warp's chain of dependent
// diagonals holds only the shuffles and the arithmetic (wider bands
// spilled registers unrolled and take the rolled loop).
template <int RPT, int LPB>
struct DlWarp {
  static constexpr int SB = mk::byte_stride(LPB);
  // One diagonal's inputs (rows past the band read row Wp - 1: their
  // results are never read).
  struct In {
    float p[RPT];
    int l0;
  };
  DlSums S;
  mk::WarpRows<RPT> rows;
  int Wp, kk, b, width, mb, nb, fd, fk;
  float mg;
  int lo1 = 0, lo2 = 0;    // lo at d - 1, d - 2
  float a1[RPT], a2[RPT];  // scores of d - 1, d - 2
  float wu[RPT], wl[RPT];  // the gap-weight windows at d - 1
  float tscore = NEG;      // the score at the terminal
  bool hit = false;        // whether this thread holds it

  __device__ DlWarp(const DlSums& S_, int Wp_, int b_, int width_, int mb_,
                    int nb_, int fd_, int fk_, float mg_)
      : S(S_), rows(Wp_), Wp(Wp_), kk(threadIdx.x & 31), b(b_),
        width(width_), mb(mb_), nb(nb_), fd(fd_), fk(fk_), mg(mg_) {}

  __device__ int row(int r) const { return rows.row(r); }

  __device__ In load(const float* post, const int32_t* los, int kb) const {
    In a;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      a.p[r] = post[kb * Wp + min(row(r), Wp - 1)];
    a.l0 = los[kb];
    return a;
  }

  // Diagonals d0 .. d0 + n - 1 of lane w: posterior rows from post (lane
  // w's row of the tile), lo from los, the entering sums from ent (lane
  // w's), pointers into the tile out.
  __device__ void tile(const float* post, const int32_t* los,
                       const float* ent, uint8_t* out, int w, int d0, int n) {
    // Thread kk holds the weights entering at tile diagonal kk, and checks
    // that lo moves by 0 or 1 there.
    int t1 = 0;
    float erw = 0.f, ecw = 0.f;
    if (kk < n) {
      const int l = los[kk];
      erw = l + Wp - 1 >= 1 ? S.gap(ent[2 * kk]) : 0.f;
      ecw = d0 + kk - l >= 1 ? S.gap(ent[2 * kk + 1]) : 0.f;
      t1 = l - (kk == 0 ? lo1 : los[kk - 1]);
    }
    const bool regular = (RPT == 1) & (d0 > 0) & (n == DL_KT) &
                         __all_sync(mk::FULL, (t1 == 0) | (t1 == 1));
    int kb = 0;
    if (d0 == 0) {
      // d = 0 is pure initialisation: 0 at row 0; d - 1 holds NEG.
      float na[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        na[r] = row(r) == 0 ? 0.f : NEG;
        a2[r] = NEG;
        if (row(r) < Wp) out[row(r) * SB + w] = 0;
      }
      publish(0, na, los[0]);
      kb = 1;
    }
    In cur = load(post, los, kb);
    if (regular) {
#pragma unroll
      for (int q = 0; q < DL_KT; ++q) {
        const In next = load(post, los, q + 1 < DL_KT ? q + 1 : q);
        step<true>(d0 + q, q, cur, erw, ecw, out + q * Wp * SB + w);
        cur = next;
      }
    } else {
      for (; kb < n; ++kb) {
        const In next = load(post, los, kb + 1 < n ? kb + 1 : kb);
        step<false>(d0 + kb, kb, cur, erw, ecw, out + kb * Wp * SB + w);
        cur = next;
      }
    }
  }

  // The windows at diagonal d from the closed form.
  __device__ void seed(int d, int l0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = l0 + row(r);
      wu[r] = S.wup(i, b);
      wl[r] = S.wleft(d - i, b);
    }
  }

  // Generation d >= 1 (tile row kb) from its inputs a and the entering
  // weights of this thread's tile diagonal (erw, ecw); pointers at row k
  // go to ptr[k * SB].  REGULAR: lo moved by 0 or 1 from d - 1 and d > 1.
  template <bool REGULAR>
  __device__ void step(int d, int kb, const In& a, float erw, float ecw,
                       uint8_t* ptr) {
    const int l0 = a.l0;
    const int t1 = l0 - lo1, t2 = d >= 2 ? l0 - lo2 : 0;
    // The delay line: where lo steps the up window moves up a row and
    // read row lo(d) + Wp - 1 enters at the top, else the left window
    // moves down and ref column d - lo(d) enters at row 0 (the entering
    // weight shuffled from the thread that holds it).  Seeded from the
    // closed form at d = 1 and where lo moves by other than 0 or 1.
    const bool steps = t1 == 1;
    float wm[RPT], wr[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) wm[r] = steps ? wu[r] : wl[r];
    rows.roll(wm, wr, steps ? 1 : -1);
    const float e = __shfl_sync(mk::FULL, steps ? erw : ecw, kb);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float moved = row(r) == (steps ? Wp - 1 : 0) ? e : wr[r];
      wu[r] = steps ? moved : wu[r];
      wl[r] = steps ? wl[r] : moved;
    }
    if (!REGULAR && ((d == 1) | ((t1 != 0) & (t1 != 1)))) seed(d, l0);
    // Diag from d - 2 at row shift s2 - 1, left (ref skip) from d - 1 at
    // shift s1, up (read skip) at shift s1 - 1: at most one of the two
    // moves, so d - 1 rolls once.
    const mk::GapMove g(t1);
    float ar[RPT], dg[RPT], na[RPT];
    rows.roll(a1, ar, g.by);
    rows.roll(a2, dg, mk::diag_move(t2));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      const float p = a.p[r];
      const float wd = (p >= mg) & (p > 0.f) ? p : NEG;
      const int i = l0 + k, j = d - i;
      const bool v = (k < width) & (i >= 0) & (i <= mb) & (i <= d) &
                     (j >= 0) & (j <= nb) & (mb + nb > 0);
      const float diag = dg[r] + wd;
      const float left = (g.left ? ar[r] : a1[r]) + wl[r];
      const float up = (g.up ? ar[r] : a1[r]) + wu[r];
      int am;
      const float val = mk::max_argmax3(diag, left, up, am);
      na[r] = v ? val : NEG;
      if (k < Wp) ptr[k * SB] = (uint8_t)am;
      a2[r] = a1[r];
    }
    publish(d, na, l0);
  }

  // Generation d becomes d - 1; the score at the lane's terminal is kept.
  __device__ void publish(int d, const float (&na)[RPT], int l0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      a1[r] = na[r];
      const bool at = (d == fd) & (row(r) == fk) & (fk < Wp);
      tscore = at ? na[r] : tscore;
      hit = hit | at;
    }
    lo2 = lo1;
    lo1 = l0;
  }

  // The lane's score, from the thread that kept it.
  __device__ void finish(float* score) const {
    if (hit) *score = fmaxf(tscore, NEG);
  }
};

template <int RPT, int LPB>
__global__ void __launch_bounds__(32 * LPB)
    mea_dl_kernel(const float* __restrict__ post,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ m,
                  const int32_t* __restrict__ n, DlSums sums,
                  const int32_t* __restrict__ final_d,
                  const int32_t* __restrict__ final_k, int D1, int Wp,
                  int width, float match_gamma, int vec,
                  uint8_t* __restrict__ ptr, float* __restrict__ score) {
  extern __shared__ __align__(16) float dl_raw[];
  const int B = sums.B;
  const size_t np = dl_post_floats(Wp, LPB);
  float* ent_s = dl_raw + DL_STAGES * np;
  int32_t* lo_s = reinterpret_cast<int32_t*>(ent_s + DL_STAGES * 2 * LPB *
                                                         DL_KT);
  uint8_t* out_s = reinterpret_cast<uint8_t*>(lo_s + DL_LO * LPB * DL_KT);
  const int tiles = (D1 + DL_KT - 1) / DL_KT;
  // Tile t's posterior and entering sums (t mod DL_STAGES), lo (t mod
  // DL_LO) and pointers (by parity).
  auto post_t = [&](int t) { return dl_raw + (t % DL_STAGES) * np; };
  auto ent_t = [&](int t) {
    return ent_s + (t % DL_STAGES) * 2 * LPB * DL_KT;
  };
  auto lo_t = [&](int t) { return lo_s + (t % DL_LO) * LPB * DL_KT; };
  auto out_t = [&](int t) { return out_s + (t & 1) * dl_plane(Wp, LPB); };
  auto count = [&](int t) { return min(DL_KT, D1 - t * DL_KT); };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  auto stage_lo = [&](int t) {
    if (t < tiles)
      dl_stage_lo<LPB>(lo_t(t), lo, t * DL_KT, count(t), b0, B);
  };
  // One group a tile (tile t's posterior and entering sums, whose lo has
  // landed, and tile t + DL_STAGES - 1's lo), empty past the last, so that
  // wait_but counts tiles.
  auto stage = [&](int t) {
    if (t < tiles) {
      dl_stage_post<LPB>(post_t(t), post, t * DL_KT, count(t), b0, Wp, B);
      dl_stage_entering<LPB>(ent_t(t), lo_t(t), t * DL_KT, count(t), b0, Wp,
                             sums);
    }
    stage_lo(t + DL_STAGES - 1);
    mk::cp_async_commit();
  };
  auto flush = [&](int t) {
    mk::flush_bytes<LPB>(ptr, out_t(t), (size_t)t * DL_KT * Wp,
                         count(t) * Wp, b0, B, vec);
  };
  DlWarp<RPT, LPB> lane(sums, Wp, b, width, live ? m[b] : 0,
                        live ? n[b] : 0, live ? final_d[b] : -1,
                        live ? final_k[b] : -1, match_gamma);
  for (int t = 0; t < DL_STAGES - 1; ++t) stage_lo(t);
  mk::cp_async_commit();
  mk::cp_async_wait();
  __syncthreads();
  for (int t = 0; t < DL_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    // Tile t's posterior, entering sums and lo and tile t + DL_STAGES - 1's
    // lo have landed; every warp is past tile t - 1, whose pointers leave
    // now and whose buffers take tile t + DL_STAGES - 1.
    mk::cp_async_wait_but<DL_STAGES - 2>();
    __syncthreads();
    if (t > 0) flush(t - 1);
    stage(t + DL_STAGES - 1);
    if (live)
      lane.tile(post_t(t) + w * dl_stride(Wp), lo_t(t) + w * DL_KT,
                ent_t(t) + 2 * w * DL_KT, out_t(t), w, t * DL_KT, count(t));
  }
  __syncthreads();
  flush(tiles - 1);
  if (live) lane.finish(score + b);
}

template <int LPB>
const void* dl_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)mea_dl_kernel<1, LPB>;
    case 2: return (const void*)mea_dl_kernel<2, LPB>;
    case 3: return (const void*)mea_dl_kernel<3, LPB>;
    case 4: return (const void*)mea_dl_kernel<4, LPB>;
  }
  return nullptr;
}

// The kernel, lanes a block (mk::warp_lanes) and shared memory of D's
// launch at (Wp, B), its shared memory opted in.
cudaError_t dl_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  cudaError_t err =
      mk::warp_lanes(B, [Wp](int l) { return dl_smem(Wp, l); }, lanes);
  if (err != cudaSuccess) return err;
  switch (*lanes) {
    case 8: *kernel = dl_kernel_rpt<8>(Wp); break;
    case 16: *kernel = dl_kernel_rpt<16>(Wp); break;
    default: return cudaErrorInvalidValue;
  }
  *smem = dl_smem(Wp, *lanes);
  return mk::allow_smem(*kernel, *smem);
}

}  // namespace

// Plain C entry points (loaded with ctypes); device pointers.  Each returns
// a cudaError_t code.
extern "C" int banded_mea_launch(const float* wdiag, const float* wup,
                                 const float* wleft, const uint8_t* valid,
                                 const int32_t* s1, const int32_t* s2,
                                 const int32_t* final_d,
                                 const int32_t* final_k, int D1, int Wp,
                                 int B, uint8_t* ptr, float* score,
                                 void* stream) {
  return mea_launch(BandWeights{wdiag, wup, wleft, valid, s1, s2, Wp, B},
                    final_d, final_k,
                    mk::MultiSteps{nullptr, nullptr, nullptr, nullptr}, D1,
                    ptr, score, (cudaStream_t)stream);
}

extern "C" int banded_mea_info(int Wp, int B, int* out) {
  return mea_info(Wp, B, false, out);
}

extern "C" int mea_dl_launch(const float* post, const int32_t* lo,
                             const int32_t* m, const int32_t* n,
                             const float* accr, const float* accc,
                             const int32_t* final_d, const int32_t* final_k,
                             int D1, int Wp, int B, int width, int rgm,
                             int rgn, float gap_gamma, float match_gamma,
                             uint8_t* ptr, float* score, void* stream) {
  if (D1 < 1 || B < 1 || rgm < 1 || rgn < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = dl_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  DlSums sums{accr, accc, B, rgm, rgn, gap_gamma};
  int vec = mk::words_aligned(B, {ptr});
  void* args[] = {&post, &lo,  &m,     &n,           &sums,
                  &final_d, &final_k, &D1, &Wp, &width, &match_gamma,
                  &vec,  &ptr, &score};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What D's launch at band width Wp over B lanes gets on this device
// (mk::kernel_info's out[5] and out[5], its lanes a block).
extern "C" int mea_dl_info(int Wp, int B, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = dl_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  out[5] = lanes;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

extern "C" int mea_multi_launch(const float* wdiag, const float* wup,
                                const float* wleft, const uint8_t* valid,
                                const int32_t* s1, const int32_t* s2,
                                const int8_t* start, const int32_t* fink,
                                const int32_t* find, int D1, int Wp, int B,
                                uint8_t* ptr, float* term, void* stream) {
  if (term == nullptr) return cudaErrorInvalidValue;
  return mea_launch(BandWeights{wdiag, wup, wleft, valid, s1, s2, Wp, B},
                    nullptr, nullptr, mk::MultiSteps{start, fink, find, term},
                    D1, ptr, nullptr, (cudaStream_t)stream);
}

extern "C" int mea_multi_info(int Wp, int B, int* out) {
  return mea_info(Wp, B, true, out);
}
