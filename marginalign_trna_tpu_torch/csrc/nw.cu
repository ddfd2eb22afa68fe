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
// diagonals and how many of those chains run at once.
//   banded_nw runs one warp per lane (common.cuh's warp-per-lane layout,
//     consecutive rows a thread): both frontier generations stay in
//     registers, a row shift is one shuffle of the edge row, and a block
//     of 8 or 16 lanes stages 8 diagonals of codes, valid bytes and shifts
//     by cp.async while it computes the previous 8, its pointers leaving
//     through shared memory: one barrier per 8 diagonals, and at the
//     guide's 1024 lanes 1024 warps in flight.  On an H100 at [7168, 48,
//     1024] that took 4.6 ms against a 0.44 ms byte bound (kernel_ab.py):
//     each warp's serial chain of instructions a diagonal bounds it;
//     without the row shuffles it ran 29% faster, without device memory
//     22%, with more tiles in flight no faster.
//   nw_multi keeps the block-per-32-lanes design: both frontier
//     generations in shared memory, one barrier per diagonal, the d-2
//     generation read as a precomputed (max, argmax) over its three states,
//     the next diagonal's inputs fetched while the current one computes.
#include "common.cuh"

namespace {

using mk::NEG;

struct NwScores {
  float match, mismatch, gap_open, gap_extend;
};

// ------------------------------------------------- banded_nw: warp per lane

constexpr int NW_KT = 8;      // diagonals a tile
constexpr int NW_STAGES = 2;  // input tiles: the one computed, 1 in flight

// A tile's inputs in shared memory: the byte tiles x, y, v (codes and the
// valid band, mk::byte_stride's layout) and the shifts s1, s2 [LPB][NW_KT].
struct NwIn {
  uint8_t* x;
  uint8_t* y;
  uint8_t* v;
  int32_t* s1;
  int32_t* s2;
};

__host__ __device__ inline size_t nw_plane(int Wp, int lpb) {
  return (size_t)NW_KT * Wp * mk::byte_stride(lpb);
}
__host__ __device__ inline size_t nw_in_bytes(int Wp, int lpb) {
  return 3 * nw_plane(Wp, lpb) + 2 * sizeof(int32_t) * lpb * NW_KT;
}
// NW_STAGES stage buffers and two pointer tiles.
inline size_t nw_smem(int Wp, int lpb) {
  return NW_STAGES * nw_in_bytes(Wp, lpb) + 2 * nw_plane(Wp, lpb);
}

__device__ inline NwIn nw_in(uint8_t* p, int Wp, int lpb) {
  const size_t pl = nw_plane(Wp, lpb);
  int32_t* s = reinterpret_cast<int32_t*>(p + 3 * pl);
  return NwIn{p, p + pl, p + 2 * pl, s, s + lpb * NW_KT};
}

// Starts the copy of diagonals d0 .. d0 + NW_KT - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into S (the caller commits).
template <int LPB>
__device__ __forceinline__ void nw_stage(
    const NwIn& S, int d0, int D1, int b0, int Wp, int B,
    const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, bool vec) {
  const int n = min(NW_KT, D1 - d0);
  const size_t r0 = (size_t)d0 * Wp;
  mk::stage_bytes<LPB>(S.x, xb, r0, n * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.y, yb, r0, n * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.v, valid, r0, n * Wp, b0, B, vec);
  const int w = threadIdx.x % LPB, kb = threadIdx.x / LPB;
  if (kb < n && b0 + w < B) {
    const size_t o = (size_t)(d0 + kb) * B + b0 + w;
    mk::cp_async4(S.s1 + w * NW_KT + kb, s1 + o);
    mk::cp_async4(S.s2 + w * NW_KT + kb, s2 + o);
  }
}

// The Viterbi of one lane (rows as mk::WarpRows).  Each diagonal's inputs
// are read from the stage buffer one diagonal ahead, and the loop over a
// tile's diagonals has no branch (unrolled, it ran slower: the guide's
// 7168-diagonal launch from an instruction stream 8 times longer).
template <int RPT, int LPB>
struct NwWarp {
  static constexpr int SB = mk::byte_stride(LPB);
  // One diagonal's inputs (rows past the band read row Wp - 1: their
  // results are never read).
  struct In {
    int x[RPT], y[RPT];
    bool v[RPT];
    int t1, t2;
  };
  NwScores p;
  mk::WarpRows<RPT> rows;
  int Wp, fd, fk;
  float m1[RPT], x1[RPT], y1[RPT];  // the three states of d - 1
  float b1[RPT], b2[RPT];           // their max at d - 1, d - 2
  int a1[RPT], a2[RPT];             // and its first argmax
  float tm = NEG, tx = NEG, ty = NEG;  // the states at the terminal
  bool hit = false;                    // whether this thread holds it

  __device__ NwWarp(const NwScores& p_, int Wp_, int fd_, int fk_)
      : p(p_), rows(Wp_), Wp(Wp_), fd(fd_), fk(fk_) {}

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
    return a;
  }

  // Diagonals d0 .. d0 + n - 1 of lane w from stage buffer S into the
  // pointer tile out.
  __device__ void tile(const NwIn& S, uint8_t* out, int w, int d0, int n) {
    int kb = 0;
    if (d0 == 0) {
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
      step(d0 + kb, cur, out + kb * Wp * SB + w);
      cur = next;
    }
  }

  // Generation d >= 1 from its inputs a; pointers at row k go to
  // ptr[k * SB].
  __device__ void step(int d, const In& a, uint8_t* ptr) {
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
      if (row(r) < Wp)
        ptr[row(r) * SB] = (uint8_t)(as[r] | (ixp << 2) | (iyp << 3));
      b2[r] = b1[r];
      a2[r] = a1[r];
    }
    publish(d, nm, nx, ny);
  }

  // Generation d becomes d - 1 (its max d - 2 one diagonal later); the
  // states at the lane's terminal are kept.
  __device__ void publish(int d, const float (&nm)[RPT],
                          const float (&nx)[RPT], const float (&ny)[RPT]) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      b1[r] = mk::max_argmax3(nm[r], nx[r], ny[r], a1[r]);
      m1[r] = nm[r];
      x1[r] = nx[r];
      y1[r] = ny[r];
      const bool at = (d == fd) & (row(r) == fk) & (fk < Wp);
      tm = at ? nm[r] : tm;
      tx = at ? nx[r] : tx;
      ty = at ? ny[r] : ty;
      hit = hit | at;
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

template <int RPT, int LPB>
__global__ void __launch_bounds__(32 * LPB)
    nw_kernel(const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ s1, const int32_t* __restrict__ s2,
              const int32_t* __restrict__ final_d,
              const int32_t* __restrict__ final_k, int D1, int Wp, int B,
              NwScores p, int vec, uint8_t* __restrict__ ptr,
              float* __restrict__ score, int32_t* __restrict__ final_state) {
  extern __shared__ __align__(16) uint8_t nw_raw[];
  const size_t nin = nw_in_bytes(Wp, LPB), nout = nw_plane(Wp, LPB);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const int tiles = (D1 + NW_KT - 1) / NW_KT;
  // Stage buffer of tile t (t mod NW_STAGES), pointer tile (by parity).
  auto in = [&](int t) {
    return nw_in(nw_raw + (t % NW_STAGES) * nin, Wp, LPB);
  };
  auto out = [&](int t) { return nw_raw + NW_STAGES * nin + (t & 1) * nout; };
  // One group a tile, empty past the last, so that wait_but counts tiles.
  auto stage = [&](int t) {
    if (t < tiles)
      nw_stage<LPB>(in(t), t * NW_KT, D1, b0, Wp, B, xb, yb, valid, s1, s2,
                    vec);
    mk::cp_async_commit();
  };
  auto flush = [&](int t) {
    const int d0 = t * NW_KT;
    mk::flush_bytes<LPB>(ptr, out(t), (size_t)d0 * Wp,
                         min(NW_KT, D1 - d0) * Wp, b0, B, vec);
  };
  NwWarp<RPT, LPB> lane(p, Wp, live ? final_d[b] : -1,
                        live ? final_k[b] : -1);
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
      lane.tile(in(t), out(t), w, t * NW_KT, min(NW_KT, D1 - t * NW_KT));
  }
  __syncthreads();
  flush(tiles - 1);
  if (live) lane.finish(score + b, final_state + b);
}

template <int LPB>
const void* nw_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)nw_kernel<1, LPB>;
    case 2: return (const void*)nw_kernel<2, LPB>;
    case 3: return (const void*)nw_kernel<3, LPB>;
    case 4: return (const void*)nw_kernel<4, LPB>;
  }
  return nullptr;
}

// The kernel, lanes a block (mk::warp_lanes) and shared memory of
// banded_nw's launch at (Wp, B), its shared memory opted in.
cudaError_t nw_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  cudaError_t err =
      mk::warp_lanes(B, [Wp](int l) { return nw_smem(Wp, l); }, lanes);
  if (err != cudaSuccess) return err;
  switch (*lanes) {
    case 8: *kernel = nw_kernel_rpt<8>(Wp); break;
    case 16: *kernel = nw_kernel_rpt<16>(Wp); break;
    default: return cudaErrorInvalidValue;
  }
  *smem = nw_smem(Wp, *lanes);
  return mk::allow_smem(*kernel, *smem);
}

// --------------------------------------------- nw_multi: block per 32 lanes

// The per-diagonal streams of multi-problem lanes: start [D1, B] int8,
// fink / find [D1, B] int32 (-1 off terminal diagonals), and the terminal
// scores term [3, D1, B] it writes.
struct MultiSteps {
  const int8_t* __restrict__ start;
  const int32_t* __restrict__ fink;
  const int32_t* __restrict__ find;
  float* __restrict__ term;
};

template <int RPT>
__global__ void __launch_bounds__(1024)
    nw_multi_kernel(const int8_t* __restrict__ xb,
                    const int8_t* __restrict__ yb,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ s1,
                    const int32_t* __restrict__ s2, MultiSteps ms, int D1,
                    int Wp, int B, NwScores p, uint8_t* __restrict__ ptr) {
  extern __shared__ float smem[];
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  // Generation d-1 of each state, double-buffered by the parity of d.
  float* shM = smem;
  float* shX = shM + 2 * plane;
  float* shY = shX + 2 * plane;
  // (max, argmax) over the three states, three generations by d mod 3.
  float* shBest = shY + 2 * plane;
  uint8_t* shArg = reinterpret_cast<uint8_t*>(shBest + 3 * plane);

  // Every slot holds NEG (generations -1 and -2); the loop starts at d = 0.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
    if (k >= Wp) continue;
    const int i = k * L + lane;
    for (int g = 0; g < 2; ++g) {
      shM[g * plane + i] = NEG;
      shX[g * plane + i] = NEG;
      shY[g * plane + i] = NEG;
    }
    for (int g = 0; g < 3; ++g) {
      shBest[g * plane + i] = NEG;
      shArg[g * plane + i] = 0;
    }
  }

  int8_t fx[RPT], fy[RPT];
  uint8_t fv[RPT];
  int f1 = 0, f2 = 0, fst = 0, ffk = -1, ffd = -1;
  auto fetch = [&](int d) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      fx[r] = 4; fy[r] = 4; fv[r] = 0;
      if (live && k < Wp) {
        const size_t c = mk::cell(d, k, b, Wp, B);
        fx[r] = xb[c]; fy[r] = yb[c]; fv[r] = valid[c];
      }
    }
    f1 = live ? s1[(size_t)d * B + b] : 0;
    f2 = live ? s2[(size_t)d * B + b] : 0;
    if (live) {
      fst = ms.start[(size_t)d * B + b];
      ffk = ms.fink[(size_t)d * B + b];
      ffd = ms.find[(size_t)d * B + b];
    }
  };
  fetch(0);
  __syncthreads();

  for (int d = 0; d < D1; ++d) {
    int8_t cx[RPT], cy[RPT];
    uint8_t cv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { cx[r] = fx[r]; cy[r] = fy[r]; cv[r] = fv[r]; }
    const int t1 = f1, t2 = f2;
    const bool seeds = fst != 0;
    const int tk = ffd >= 0 ? ffk : -1;  // terminal row, or -1
    if (d + 1 < D1) fetch(d + 1);

    const int prv = ((d - 1) & 1) * plane, cur = (d & 1) * plane;
    const int old = ((d + 1) % 3) * plane, now = (d % 3) * plane;
    float nm[RPT], nx[RPT], ny[RPT];
    uint8_t np[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int x = cx[r], y = cy[r];
      const float sub = (x == y && x < 4)
                            ? p.match
                            : ((x >= 4 || y >= 4) ? 0.f : p.mismatch);
      // Match from (i-1, j-1): row shift s2 - 1.
      const int kd = mk::wrap(k + t2 - 1, Wp) * L + lane;
      float mv = shBest[old + kd] + sub;
      const int mp = shArg[old + kd];
      // Ix from (i, j-1): shift s1.  Iy from (i-1, j): shift s1 - 1.
      const int kh = mk::wrap(k + t1, Wp) * L + lane;
      const int kv = mk::wrap(k + t1 - 1, Wp) * L + lane;
      const float io = shM[prv + kh] + p.gap_open;
      const float ie = shX[prv + kh] + p.gap_extend;
      const float vo = shM[prv + kv] + p.gap_open;
      const float ve = shY[prv + kv] + p.gap_extend;
      float ixv = fmaxf(io, ie), iyv = fmaxf(vo, ve);
      const int ixp = ie > io ? 1 : 0, iyp = ve > vo ? 1 : 0;
      if (!cv[r]) { mv = NEG; ixv = NEG; iyv = NEG; }
      nm[r] = mv; nx[r] = ixv; ny[r] = iyv;
      np[r] = (uint8_t)(mp | (ixp << 2) | (iyp << 3));
      if (seeds && k == 0) {
        nm[r] = 0.f; nx[r] = NEG; ny[r] = NEG; np[r] = 0;
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
      shM[cur + i] = nm[r];
      shX[cur + i] = nx[r];
      shY[cur + i] = ny[r];
      int a;
      shBest[now + i] = mk::max_argmax3(nm[r], nx[r], ny[r], a);
      shArg[now + i] = (uint8_t)a;
      if (live) {
        ptr[mk::cell(d, k, b, Wp, B)] = np[r];
        if (k == tk) {
          const size_t t = (size_t)d * B + b, n = (size_t)D1 * B;
          ms.term[t] = fmaxf(nm[r], NEG);
          ms.term[n + t] = fmaxf(nx[r], NEG);
          ms.term[2 * n + t] = fmaxf(ny[r], NEG);
        }
      }
    }
    if (live && ty == 0 && (tk < 0 || tk >= Wp)) {
      const size_t t = (size_t)d * B + b, n = (size_t)D1 * B;
      ms.term[t] = NEG;
      ms.term[n + t] = NEG;
      ms.term[2 * n + t] = NEG;
    }
    __syncthreads();
  }
}

template <int RPT>
cudaError_t run_multi(const int8_t* xb, const int8_t* yb,
                      const uint8_t* valid, const int32_t* s1,
                      const int32_t* s2, const MultiSteps& ms, int D1,
                      int Wp, int B, NwScores p, uint8_t* ptr,
                      cudaStream_t stream) {
  const size_t smem = (size_t)Wp * mk::LANES * (9 * sizeof(float) + 3);
  cudaError_t err = mk::allow_smem((const void*)nw_multi_kernel<RPT>, smem);
  if (err != cudaSuccess) return err;
  nw_multi_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), smem, stream>>>(
          xb, yb, valid, s1, s2, ms, D1, Wp, B, p, ptr);
  return cudaGetLastError();
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
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = nw_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  NwScores p{match, mismatch, gap_open, gap_extend};
  int vec = mk::words_aligned(B, {xb, yb, valid, ptr});
  void* args[] = {&xb, &yb, &valid, &s1, &s2, &final_d, &final_k, &D1,
                  &Wp, &B,  &p,     &vec, &ptr, &score, &final_state};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What banded_nw's launch at band width Wp over B lanes gets on this device
// (mk::kernel_info's out[5]; its lanes a block are out[3] / 32).
extern "C" int banded_nw_info(int Wp, int B, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = nw_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

extern "C" int nw_multi_launch(const int8_t* xb, const int8_t* yb,
                               const uint8_t* valid, const int32_t* s1,
                               const int32_t* s2, const int8_t* start,
                               const int32_t* fink, const int32_t* find,
                               int D1, int Wp, int B, float match,
                               float mismatch, float gap_open,
                               float gap_extend, uint8_t* ptr, float* term,
                               void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const NwScores p{match, mismatch, gap_open, gap_extend};
  const MultiSteps ms{start, fink, find, term};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_multi<1>(xb, yb, valid, s1, s2, ms, D1, Wp, B, p, ptr, s);
    case 2: return run_multi<2>(xb, yb, valid, s1, s2, ms, D1, Wp, B, p, ptr, s);
    case 3: return run_multi<3>(xb, yb, valid, s1, s2, ms, D1, Wp, B, p, ptr, s);
    case 4: return run_multi<4>(xb, yb, valid, s1, s2, ms, D1, Wp, B, p, ptr, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* marginalign_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
