// Banded affine-gap Gotoh alignment (the guide Viterbi), max-plus over the
// match / ref-gap (Ix) / read-gap (Iy) states along anti-diagonals.
//
// Replaces the TPU kernels of marginalign_trna_tpu/ops/wavefront_pallas.py
//   banded_nw <- `_nw_kernel` (launched by `banded_nw_pallas`): one problem
//                per lane, M = 0 at row 0 of d = 0, the terminal score read
//                at (final_d, final_k) as max(value, NEG);
//   nw_multi  <- `_nw_kernel_multi` (`banded_nw_pallas_multi`): several
//                problems per lane (ops/band.py `pack_multi_banded_batch`);
//                both frontier generations start at NEG, the SPACER empty
//                diagonals between problems push them back to NEG, and
//                where `start` marks a problem's local d = 0 row 0 is
//                seeded (M = 0, X = Y = NEG, pointer 0).  On a diagonal
//                that `find` marks terminal, the three states at row
//                `fink` leave as max(value, NEG) in term [3, D1, B]; NEG
//                on every other diagonal.
// Same arithmetic in both: no score normalisation (scores grow by at most
// `match` per diagonal, so f32 stays exact for integer scoring), circular
// row shifts, first-max-wins pointers `ptrM | ptrIx << 2 | ptrIy << 3` in
// the order diag, left, up, strict `ext > open` for the gap pointers.
//
// What bounds them on an H100: not bytes (3 B in, 1 B out per cell) nor
// arithmetic (~12 adds/compares per cell) but the chain of D1 dependent
// diagonals and the instructions a lane-diagonal issues.  Both run
// `nw_kernel` (common.cuh's warp-per-lane layout, consecutive rows a
// thread; nw_multi its MULTI instances): both frontier generations in
// registers, a row shift one shuffle of the edge row, a block staging 8
// diagonals of codes, valid bytes and shifts (nw_multi: start flags as a
// byte tile, fink / find as per-lane records) by cp.async while it
// computes the previous 8, its pointers (nw_multi: and the terminal
// records) leaving through shared memory: one barrier per 8 diagonals.
// banded_nw at [7168, 48, 1024] took 4.6 ms against a 0.44 ms byte bound
// (kernel_ab.py): each warp's serial chain a diagonal bounds it.
// nw_multi's 4096 lanes fill the card, so its instructions a lane-diagonal
// bound it (without the row shuffles 30% faster): a quarter or half of a
// warp a lane (`nw_threads`) took it from 1.95 / 1.11 ms at a warp a lane
// to 1.33 / 0.92 at [1024, 48 / 24, 4096] (the block-per-32-lanes kernel
// it replaces: 1.42 / 0.84).
#include "common.cuh"

namespace {

using mk::NEG;

struct NwScores {
  float match, mismatch, gap_open, gap_extend;
};

// ------------------------------------------------------- one warp per lane

constexpr int NW_KT = 8;      // diagonals a tile
constexpr int NW_STAGES = 2;  // input tiles: the one computed, 1 in flight

// A tile's inputs in shared memory: the byte tiles x, y, v (codes and the
// valid band, mk::byte_stride's layout) and the shifts s1, s2 [LPB][NW_KT];
// multi lanes add fink and find [LPB][NW_KT] and the start flags as a byte
// tile st [NW_KT] rows.
struct NwIn {
  uint8_t* x;
  uint8_t* y;
  uint8_t* v;
  int32_t* s1;
  int32_t* s2;
  int32_t* fk;
  int32_t* fd;
  uint8_t* st;
};

__host__ __device__ inline size_t nw_plane(int Wp, int lpb) {
  return (size_t)NW_KT * Wp * mk::byte_stride(lpb);
}
__host__ __device__ inline size_t nw_in_bytes(int Wp, int lpb, bool multi) {
  return 3 * nw_plane(Wp, lpb) + 2 * sizeof(int32_t) * lpb * NW_KT +
         (multi ? 2 * sizeof(int32_t) * lpb * NW_KT +
                      (size_t)NW_KT * mk::byte_stride(lpb)
                : 0);
}
// An output tile: the pointer plane and, for multi lanes, the terminal
// records [3][NW_KT][LPB] (M, X, Y).
__host__ __device__ inline size_t nw_out_bytes(int Wp, int lpb, bool multi) {
  return nw_plane(Wp, lpb) + (multi ? 3 * sizeof(float) * NW_KT * lpb : 0);
}
// NW_STAGES stage buffers and two output tiles.
inline size_t nw_smem(int Wp, int lpb, bool multi) {
  return NW_STAGES * nw_in_bytes(Wp, lpb, multi) +
         2 * nw_out_bytes(Wp, lpb, multi);
}

__device__ inline NwIn nw_in(uint8_t* p, int Wp, int lpb) {
  const size_t pl = nw_plane(Wp, lpb);
  int32_t* s = reinterpret_cast<int32_t*>(p + 3 * pl);
  const int n = lpb * NW_KT;
  return NwIn{p,     p + pl, p + 2 * pl, s, s + n, s + 2 * n, s + 3 * n,
              reinterpret_cast<uint8_t*>(s + 4 * n)};
}

// Starts the copy of diagonals d0 .. d0 + NW_KT - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into S with the block's NT threads (the caller
// commits).
template <int LPB, bool MULTI, int NT>
__device__ __forceinline__ void nw_stage(
    const NwIn& S, int d0, int D1, int b0, int Wp, int B,
    const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const mk::MultiSteps& ms, bool vec) {
  const int n = min(NW_KT, D1 - d0);
  const size_t r0 = (size_t)d0 * Wp;
  mk::stage_bytes<LPB, NT>(S.x, xb, r0, n * Wp, b0, B, vec);
  mk::stage_bytes<LPB, NT>(S.y, yb, r0, n * Wp, b0, B, vec);
  mk::stage_bytes<LPB, NT>(S.v, valid, r0, n * Wp, b0, B, vec);
  if (MULTI) mk::stage_bytes<LPB, NT>(S.st, ms.start, d0, n, b0, B, vec);
  const int w = threadIdx.x % LPB, kb = threadIdx.x / LPB;
  if (kb < n && b0 + w < B) {
    const size_t o = (size_t)(d0 + kb) * B + b0 + w;
    mk::cp_async4(S.s1 + w * NW_KT + kb, s1 + o);
    mk::cp_async4(S.s2 + w * NW_KT + kb, s2 + o);
    if (MULTI) {
      mk::cp_async4(S.fk + w * NW_KT + kb, ms.fink + o);
      mk::cp_async4(S.fd + w * NW_KT + kb, ms.find + o);
    }
  }
}

// The Viterbi of one lane (rows as mk::WarpRows).  Each diagonal's inputs
// are read from the stage buffer one diagonal ahead, and the loop over a
// tile's diagonals has no branch (unrolled, it ran slower: the guide's
// 7168-diagonal launch from an instruction stream 8 times longer).
// MULTI: both generations start at NEG and every diagonal is a step; row 0
// is seeded where a problem starts, and the three states at a terminal
// row go to the tile's record.  A lane takes T threads (mk::WarpRows).
template <int RPT, int LPB, bool MULTI, int T>
struct NwWarp {
  static constexpr int SB = mk::byte_stride(LPB);
  // One diagonal's inputs (rows past the band read row Wp - 1: their
  // results are never read); multi lanes: `mk::pack_steps` of the start
  // flag and the terminal row.
  struct In {
    int x[RPT], y[RPT];
    bool v[RPT];
    int t1, t2;
    int steps;
  };
  NwScores p;
  mk::WarpRows<RPT, T, MULTI> rows;
  int Wp, fd, fk;
  float m1[RPT], x1[RPT], y1[RPT];  // the three states of d - 1
  float b1[RPT], b2[RPT];           // their max at d - 1, d - 2
  int a1[RPT], a2[RPT];             // and its first argmax
  float tm = NEG, tx = NEG, ty = NEG;  // the states at the terminal
  bool hit = false;                    // whether this thread holds it

  __device__ NwWarp(const NwScores& p_, int Wp_, int fd_, int fk_)
      : p(p_), rows(Wp_), Wp(Wp_), fd(fd_), fk(fk_) {
    if (MULTI) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        m1[r] = x1[r] = y1[r] = b1[r] = b2[r] = NEG;
        a1[r] = a2[r] = 0;
      }
    }
  }

  __device__ int row(int r) const { return rows.row(r); }

  __device__ In load(const NwIn& S, int w, int kb) const {
    In a;
    const int o = kb * Wp * SB + w;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int q = o + min(row(r), Wp - 1) * SB;
      a.x[r] = (int8_t)S.x[q];
      a.y[r] = (int8_t)S.y[q];
      a.v[r] = S.v[q] != 0;
    }
    a.t1 = S.s1[w * NW_KT + kb];
    a.t2 = S.s2[w * NW_KT + kb];
    if (MULTI) a.steps = S.fk[w * NW_KT + kb];
    return a;
  }

  // Diagonals d0 .. d0 + n - 1 of lane w from stage buffer S into the
  // pointer tile out (multi lanes: the terminal records rec).
  __device__ void tile(const NwIn& S, uint8_t* out, float* rec, int w,
                       int d0, int n) {
    int kb = 0;
    if (MULTI) {
      // Each diagonal's start flag and terminal row packed in place of its
      // fink; the lane's records hold NEG but on terminal diagonals.
      if (rows.kk < n)
        S.fk[w * NW_KT + rows.kk] = mk::pack_steps(
            S.st[rows.kk * SB + w], S.fk[w * NW_KT + rows.kk],
            S.fd[w * NW_KT + rows.kk]);
      for (int i = rows.kk; i < 3 * NW_KT; i += T) rec[i * LPB + w] = NEG;
      __syncwarp();
    } else if (d0 == 0) {
      // d = 0 is pure initialisation: M = 0 at row 0; d - 1 holds NEG.
      float nm[RPT], neg[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        nm[r] = row(r) == 0 ? 0.f : NEG;
        neg[r] = NEG;
        b2[r] = NEG;
        a2[r] = 0;
        if (row(r) < Wp) out[row(r) * SB + w] = 0;
      }
      publish(0, nm, neg, neg);
      kb = 1;
    }
    In cur = load(S, w, kb);
    for (; kb < n; ++kb) {
      const In next = load(S, w, kb + 1 < n ? kb + 1 : kb);
      step(d0 + kb, cur, out + kb * Wp * SB + w, rec + kb * LPB + w);
      cur = next;
    }
  }

  // Generation d from its inputs a; pointers at row k go to ptr[k * SB],
  // multi lanes' terminal states to term[0], term[NW_KT LPB], term[2
  // NW_KT LPB].
  __device__ void step(int d, const In& a, uint8_t* ptr, float* term) {
    // Match from (i-1, j-1): d - 2 at row shift s2 - 1.  Ix from (i, j-1):
    // d - 1 at shift s1; Iy from (i-1, j): shift s1 - 1.  At most one of
    // those two moves, so M and the moving gap state roll once each.
    const mk::GapMove g(a.t1);
    const int tb = mk::diag_move(a.t2);
    float mr[RPT], gr[RPT], gs[RPT], bs[RPT];
    int as[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) gs[r] = g.left ? x1[r] : y1[r];
    rows.roll(m1, mr, g.by);
    rows.roll(gs, gr, g.by);
    rows.roll(b2, bs, tb);
    rows.roll(a2, as, tb);
    float nm[RPT], nx[RPT], ny[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int x = a.x[r], y = a.y[r];
      const float sub = (x == y) & (x < 4)
                            ? p.match
                            : ((x >= 4) | (y >= 4) ? 0.f : p.mismatch);
      const float mval = bs[r] + sub;
      const float io = (g.left ? mr[r] : m1[r]) + p.gap_open;
      const float ie = (g.left ? gr[r] : x1[r]) + p.gap_extend;
      const float vo = (g.up ? mr[r] : m1[r]) + p.gap_open;
      const float ve = (g.up ? gr[r] : y1[r]) + p.gap_extend;
      const float ixv = fmaxf(io, ie), iyv = fmaxf(vo, ve);
      const int ixp = ie > io ? 1 : 0, iyp = ve > vo ? 1 : 0;
      nm[r] = a.v[r] ? mval : NEG;
      nx[r] = a.v[r] ? ixv : NEG;
      ny[r] = a.v[r] ? iyv : NEG;
      uint8_t pt = (uint8_t)(as[r] | (ixp << 2) | (iyp << 3));
      if (MULTI) {
        const bool seed = mk::seeds(a.steps) & (row(r) == 0);
        nm[r] = seed ? 0.f : nm[r];
        nx[r] = seed ? NEG : nx[r];
        ny[r] = seed ? NEG : ny[r];
        pt = seed ? 0 : pt;
      }
      if (row(r) < Wp) ptr[row(r) * SB] = pt;
      b2[r] = b1[r];
      a2[r] = a1[r];
    }
    if (MULTI) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (mk::ends_at(a.steps, row(r)) & (row(r) < Wp)) {
          term[0] = fmaxf(nm[r], NEG);
          term[NW_KT * LPB] = fmaxf(nx[r], NEG);
          term[2 * NW_KT * LPB] = fmaxf(ny[r], NEG);
        }
      }
    }
    publish(d, nm, nx, ny);
  }

  // Generation d becomes d - 1 (its max d - 2 one diagonal later); the
  // states at the lane's terminal are kept (one problem a lane).
  __device__ void publish(int d, const float (&nm)[RPT],
                          const float (&nx)[RPT], const float (&ny)[RPT]) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      b1[r] = mk::max_argmax3(nm[r], nx[r], ny[r], a1[r]);
      m1[r] = nm[r];
      x1[r] = nx[r];
      y1[r] = ny[r];
      if (!MULTI) {
        const bool at = (d == fd) & (row(r) == fk) & (fk < Wp);
        tm = at ? nm[r] : tm;
        tx = at ? nx[r] : tx;
        ty = at ? ny[r] : ty;
        hit = hit | at;
      }
    }
  }

  // The lane's score and final state, from the thread that kept them.
  __device__ void finish(float* score, int32_t* state) const {
    if (!hit) return;
    const float bm = fmaxf(tm, NEG), bx = fmaxf(tx, NEG), by = fmaxf(ty, NEG);
    float best = bm;
    int st = 0;
    if (bx > best) { best = bx; st = 1; }
    if (by > best) { best = by; st = 2; }
    *score = best;
    *state = st;
  }
};

// banded_nw (final_d, final_k, score, final_state; ms null) or, MULTI,
// nw_multi (ms; the single-problem arguments null); T threads a lane, LPB
// lanes a block.
template <int RPT, int LPB, bool MULTI, int T>
__global__ void __launch_bounds__(T * LPB)
    nw_kernel(const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ s1, const int32_t* __restrict__ s2,
              const int32_t* __restrict__ final_d,
              const int32_t* __restrict__ final_k, mk::MultiSteps ms, int D1,
              int Wp, int B, NwScores p, int vec, uint8_t* __restrict__ ptr,
              float* __restrict__ score, int32_t* __restrict__ final_state) {
  extern __shared__ __align__(16) uint8_t nw_raw[];
  const size_t nin = nw_in_bytes(Wp, LPB, MULTI),
               nout = nw_out_bytes(Wp, LPB, MULTI);
  constexpr int NT = T * LPB;
  const int w = threadIdx.x / T;  // the thread's lane in the block
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  // Whether the warp's first lane is in the batch: warp-uniform (a lane
  // past B beside a live one computes on stale tiles and writes nothing).
  const bool live = b0 + (int)(threadIdx.x >> 5) * (32 / T) < B;
  const int tiles = (D1 + NW_KT - 1) / NW_KT;
  // Stage buffer of tile t (t mod NW_STAGES), output tile (by parity): the
  // pointer plane, then the terminal records.
  auto in = [&](int t) {
    return nw_in(nw_raw + (t % NW_STAGES) * nin, Wp, LPB);
  };
  auto out = [&](int t) { return nw_raw + NW_STAGES * nin + (t & 1) * nout; };
  auto rec = [&](int t) {
    return reinterpret_cast<float*>(out(t) + nw_plane(Wp, LPB));
  };
  // One group a tile, empty past the last, so that wait_but counts tiles.
  auto stage = [&](int t) {
    if (t < tiles)
      nw_stage<LPB, MULTI, NT>(in(t), t * NW_KT, D1, b0, Wp, B, xb, yb,
                               valid, s1, s2, ms, vec);
    mk::cp_async_commit();
  };
  auto flush = [&](int t) {
    const int d0 = t * NW_KT, n = min(NW_KT, D1 - d0);
    mk::flush_bytes<LPB, NT>(ptr, out(t), (size_t)d0 * Wp, n * Wp, b0, B,
                             vec);
    if (MULTI)
      mk::flush_records<LPB, 3, NW_KT, NT>(ms.term, rec(t), d0, n, D1, b0,
                                           B);
  };
  NwWarp<RPT, LPB, MULTI, T> lane(p, Wp, live && !MULTI ? final_d[b] : -1,
                                  live && !MULTI ? final_k[b] : -1);
  for (int t = 0; t < NW_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (this thread's copies, then everyone's), every
    // warp is past tile t - 1, whose pointers leave now and whose stage
    // buffer takes tile t + NW_STAGES - 1.
    mk::cp_async_wait_but<NW_STAGES - 2>();
    __syncthreads();
    if (t > 0) flush(t - 1);
    stage(t + NW_STAGES - 1);
    if (live)
      lane.tile(in(t), out(t), rec(t), w, t * NW_KT,
                min(NW_KT, D1 - t * NW_KT));
  }
  __syncthreads();
  flush(tiles - 1);
  if (live && !MULTI) lane.finish(score + b, final_state + b);
}

// The instance of nw_kernel at RPT = rpt rows a thread.
template <int LPB, bool MULTI, int T>
const void* nw_kernel_rpt(int rpt) {
  switch (rpt) {
    case 1: return (const void*)nw_kernel<1, LPB, MULTI, T>;
    case 2: return (const void*)nw_kernel<2, LPB, MULTI, T>;
    case 3: return (const void*)nw_kernel<3, LPB, MULTI, T>;
    case 4: return (const void*)nw_kernel<4, LPB, MULTI, T>;
  }
  return nullptr;
}

// nw_kernel at T threads a lane and ceil(Wp / T) rows a thread, `lanes`
// lanes a block: 8 or 16 warps' worth.
template <int T, bool MULTI>
const void* nw_kernel_of(int Wp, int lanes) {
  constexpr int L = 32 / T;  // lanes a warp
  const int rpt = (Wp + T - 1) / T;
  switch (lanes / L) {
    case 8: return nw_kernel_rpt<8 * L, MULTI, T>(rpt);
    case 16: return nw_kernel_rpt<16 * L, MULTI, T>(rpt);
  }
  return nullptr;
}

// Threads a lane: nw_multi gives a lane a quarter of a warp up to Wp 24
// and half a warp up to Wp 48 (ceil(Wp / T) rows a thread), which cuts the
// row moves a lane-diagonal; a warp a lane above, as banded_nw always.
inline int nw_threads(int Wp, bool multi) {
  return !multi ? 32 : (Wp <= 24 ? 8 : (Wp <= 48 ? 16 : 32));
}

// The kernel, lanes a block and shared memory of banded_nw's (nw_multi's)
// launch at (Wp, B), its shared memory opted in.  A warp a lane takes
// mk::warp_lanes; two or four lanes a warp take blocks of 16 warps where
// they fit and still reach 15/16 of the SMs, as K4 takes its lanes
// (csrc/mea.cu `mea_lanes`), else 8: on an H100 at [1024, 48, 4096] 16
// warps of half a warp a lane took 1.333 ms, 8 1.418; at [1024, 24, 4096]
// 8 warps of a quarter 0.917, 16 1.408 (nw.cu alone, kernel_ab.py's multi
// batch).
cudaError_t nw_setup(int Wp, int B, bool multi, const void** kernel,
                     int* lanes, size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  const int T = nw_threads(Wp, multi), per = 32 / T;  // lanes a warp
  int sms = 0, cap = 0;
  cudaError_t err = mk::device_shape(&sms, &cap);
  if (err == cudaSuccess && per == 1)
    err = mk::warp_lanes(
        B, [Wp, multi](int l) { return nw_smem(Wp, l, multi); }, lanes);
  if (err != cudaSuccess) return err;
  if (per > 1)
    *lanes = nw_smem(Wp, 16 * per, multi) <= (size_t)cap &&
                     mk::fills(B, 16 * per, sms)
                 ? 16 * per
                 : 8 * per;
  *kernel = T == 8    ? nw_kernel_of<8, true>(Wp, *lanes)
            : T == 16 ? nw_kernel_of<16, true>(Wp, *lanes)
            : multi   ? nw_kernel_of<32, true>(Wp, *lanes)
                      : nw_kernel_of<32, false>(Wp, *lanes);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = nw_smem(Wp, *lanes, multi);
  return mk::allow_smem(*kernel, *smem);
}

// Launches banded_nw or nw_multi (ms.term non-null).
cudaError_t nw_launch(const int8_t* xb, const int8_t* yb,
                      const uint8_t* valid, const int32_t* s1,
                      const int32_t* s2, const int32_t* final_d,
                      const int32_t* final_k, mk::MultiSteps ms, int D1,
                      int Wp, int B, NwScores p, uint8_t* ptr, float* score,
                      int32_t* final_state, cudaStream_t stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const bool multi = ms.term != nullptr;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = nw_setup(Wp, B, multi, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  int vec = mk::words_aligned(B, {xb, yb, valid, ptr, ms.start});
  void* args[] = {&xb, &yb, &valid, &s1,  &s2,  &final_d, &final_k, &ms,
                  &D1, &Wp, &B,     &p,   &vec, &ptr,     &score,
                  &final_state};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(nw_threads(Wp, multi) * lanes), args, smem,
                          stream);
}

// What banded_nw's (nw_multi's) launch at band width Wp over B lanes gets
// on this device (mk::kernel_info's out[5] and out[5], its lanes a block).
cudaError_t nw_info(int Wp, int B, bool multi, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = nw_setup(Wp, B, multi, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  out[5] = lanes;
  return mk::kernel_info(kernel, smem, nw_threads(Wp, multi) * lanes, out);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns a cudaError_t
// code.
extern "C" int banded_nw_launch(const int8_t* xb, const int8_t* yb,
                                const uint8_t* valid, const int32_t* s1,
                                const int32_t* s2, const int32_t* final_d,
                                const int32_t* final_k, int D1, int Wp, int B,
                                float match, float mismatch, float gap_open,
                                float gap_extend, uint8_t* ptr, float* score,
                                int32_t* final_state, void* stream) {
  return nw_launch(xb, yb, valid, s1, s2, final_d, final_k,
                   mk::MultiSteps{nullptr, nullptr, nullptr, nullptr}, D1,
                   Wp, B, NwScores{match, mismatch, gap_open, gap_extend},
                   ptr, score, final_state, (cudaStream_t)stream);
}

extern "C" int banded_nw_info(int Wp, int B, int* out) {
  return nw_info(Wp, B, false, out);
}

extern "C" int nw_multi_launch(const int8_t* xb, const int8_t* yb,
                               const uint8_t* valid, const int32_t* s1,
                               const int32_t* s2, const int8_t* start,
                               const int32_t* fink, const int32_t* find,
                               int D1, int Wp, int B, float match,
                               float mismatch, float gap_open,
                               float gap_extend, uint8_t* ptr, float* term,
                               void* stream) {
  if (term == nullptr) return cudaErrorInvalidValue;
  return nw_launch(xb, yb, valid, s1, s2, nullptr, nullptr,
                   mk::MultiSteps{start, fink, find, term}, D1, Wp, B,
                   NwScores{match, mismatch, gap_open, gap_extend}, ptr,
                   nullptr, nullptr, (cudaStream_t)stream);
}

extern "C" int nw_multi_info(int Wp, int B, int* out) {
  return nw_info(Wp, B, true, out);
}

extern "C" const char* marginalign_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
