// Banded 5-state pair-HMM forward-backward posteriors for models whose gap
// states emit flat (sequence-independent) probabilities, backward first.
//
// Replaces the TPU kernel pair of marginalign_trna_tpu/ops/fb_pallas.py
// `_posteriors_pre`:
//   fb_backward (K2) <- `_make_bwd_kernel_pre_first`: scaled backward from
//                   the terminal cell; stores the match-state backward band
//                   bm, the cumulative log-scale bls per diagonal, and
//                   logZ = log(0.2 * sum_s b_s(0, 0)) + bls[0].
//   fb_forward (K3)  <- `_make_fwd_kernel_pre_post`: scaled forward
//                   consuming (bm, bls, logZ); writes the normalised
//                   posterior post = f_M * b_M * exp(ls + bls - logZ).
// The model comes in at run time as A[s][u] = T[s][u] * g_u (g_0 = 1, g_u =
// the flat emission of gap state u); the match emission band (premasked by
// valid) is precomputed outside.  Scaling follows the TPU kernels: rescale
// by the band max every 8 diagonals (backward at d % 8 == 0, forward at
// d % 8 == 7), a step with no mass uses factor 1, and the d-2 term is
// divided by the previous factor on the diagonal after a rescale.  Built
// without multiply-add contraction (-fmad=false) and with the plain
// version's order of operations, they round like the plain versions, bit
// for bit: the posterior's exp(ls + bls - logZ) factor turns one ulp of a
// ~5000-sized log-scale (4.9e-4) into the same relative error, so
// differently rounded scalings would disagree by more than the 2e-4
// posterior tolerance on kilobase segments.
//
// What bounds them on an H100: per cell the backward streams 5 B in and
// 4 B out, the forward 9 B in and 4 B out, against ~35 multiply-adds, so a
// full card would be memory bound; at the REL path's 1024 lanes each lane's
// chain of D1 dependent diagonals bounds them first.  Both run one warp
// per lane (common.cuh's warp-per-lane layout, as S, M, K1 and K4):
// ceil(Wp / 32) consecutive band rows a thread (mk::WarpRows), the
// frontier and what the next diagonals read of it in registers (K2: the gap
// states of d+1 and e_M * b_M of d+1 and d+2; K3: the gap mixes of d-1 and
// the match mixes of d-1 and d-2).  A band shift by s1 or s2 is the same
// for every row of a lane (the band wrapping at Wp, as the plain versions'
// `shift` wraps), so at one row a thread each of the five reads of the
// previous generations is one shuffle from the lane holding the row it
// reads (`RelLane::move`), at more rows one shuffle of the edge row
// (mk::WarpRows).  The rescale's band max is a warp reduction.  No block
// barrier on a diagonal: a block of 8 or 16 lanes (`rel_lanes`: 8 at the
// REL path's 1024 lanes, 128 blocks) stages a tile of diagonals (16 at one
// row a thread, else 8: whole rescale periods, K2 walking them downwards
// and rescaling at each period's low end, K3 upwards and at its high end,
// so a whole tile runs unrolled with its rescale and division steps known)
// while it computes the previous one, and bm (K2) or post (K3) leaves
// through a shared-memory tile as lane-contiguous rows: one barrier a
// tile.  The float bands (em; K3 also bm) come by the tensor memory
// accelerator where B % 4 == 0 and Wp <= 64 (`rel_tma`: K4 found that
// cp.async's 4-byte copies bound it, and TMA slower above Wp 64), else by
// cp.async; valid, s1 and (K3) bls by cp.async.
//
// On an H100 80GB HBM3 at the REL path's [3072, 24, 1024] (kernel_ab.py's
// rel and probe_rel groups): K2 0.70 ms, K3 0.76, against 4.84 and 5.97 for
// the block-per-32-lanes design they replace.  A warp's instructions a
// diagonal set the pace at eight warps an SM: a first version that moved
// the gap pairs through selects and computed every swizzled offset took
// 1.16 ms for K2 (0.95 without device memory).  Now the recursion and the
// copies overlap in part: K2 without device memory after the first tiles
// takes 0.55 ms, without the recursion 0.49.  TMA beat cp.async by 4% (K2)
// and 18% (K3), 16-diagonal tiles beat 8 by 11%; a third stage buffer and
// a 64-register cap were slower.
#include <string.h>

#include "common.cuh"

namespace {

struct FbCoef {
  float a[25];  // a[s * 5 + u]
};

// ------------------------------------------------- K2, K3: warp per lane

// Diagonals a tile at rpt band rows a thread: 16 at one row (every path's
// Wp 24: fewer block barriers; kernel_ab.py's probe_rel), 8 for wider
// bands; whole rescale periods either way.
__host__ __device__ constexpr int rel_kt(int rpt) { return rpt == 1 ? 16 : 8; }
static_assert(rel_kt(1) % 8 == 0 && rel_kt(2) % 8 == 0,
              "tiles hold whole rescale periods");
constexpr int REL_STAGES = 2;  // input tiles: the one computed, 1 in flight

// A stage buffer holds a tile's inputs for the block's LPB lanes: n float
// planes (K2: em; K3: em, bm), n per-lane records [LPB][kt] (s1; K3 also
// bls), then valid as a byte tile (mk::byte_stride's layout).  A plane is,
// with TMA, the box [kt][Wp][LPB] as the map copies it (mk::swizzled; its
// floats rounded up to 256, so that planes stay 1024-byte aligned), else
// lane w's row k of tile diagonal kb at w * rel_stride + kb * Wp + k (an
// odd stride, so that the copies, which move LPB lanes of one row, hit LPB
// banks).  An output tile holds lane w's rows at the cp.async offsets,
// then (K2) bls [LPB][kt].
struct RelIn {
  float* p;
  int32_t* s1;
  float* bls;
  uint8_t* v;
};

__host__ __device__ inline int rel_stride(int Wp, int kt) {
  return kt * Wp + 1;
}
__host__ __device__ inline size_t rel_plane(int Wp, int kt, int lpb,
                                            bool tma) {
  return tma ? ((size_t)kt * Wp * lpb + 255) / 256 * 256
             : (size_t)lpb * rel_stride(Wp, kt);
}
// Bytes of a stage buffer of n planes and n records (K2: 1, K3: 2),
// rounded up to 1024 with TMA, else to 16.
__host__ __device__ inline size_t rel_in_bytes(int n, int Wp, int kt,
                                               int lpb, bool tma) {
  const size_t a = tma ? 1024 : 16;
  const size_t b =
      (n * rel_plane(Wp, kt, lpb, tma) + (size_t)n * lpb * kt) * 4 +
      (size_t)kt * Wp * mk::byte_stride(lpb);
  return (b + a - 1) / a * a;
}
__host__ __device__ inline size_t rel_out_bytes(bool bls, int Wp, int kt,
                                                int lpb) {
  return ((size_t)lpb * (rel_stride(Wp, kt) + (bls ? kt : 0)) * 4 + 15) /
         16 * 16;
}
// REL_STAGES stage buffers and two output tiles; with TMA 1024 bytes to
// align the stages and the stages' barriers.
inline size_t rel_smem(bool fwd, int Wp, int lpb, bool tma) {
  const int kt = rel_kt(mk::rows_per_thread(Wp));
  return (tma ? 1024 + 8 * REL_STAGES : 0) +
         REL_STAGES * rel_in_bytes(fwd ? 2 : 1, Wp, kt, lpb, tma) +
         2 * rel_out_bytes(!fwd, Wp, kt, lpb);
}

__device__ inline RelIn rel_in(uint8_t* p, int n, int Wp, int kt, int lpb,
                               bool tma) {
  float* planes = reinterpret_cast<float*>(p);
  int32_t* s1 =
      reinterpret_cast<int32_t*>(planes + n * rel_plane(Wp, kt, lpb, tma));
  return RelIn{planes, s1, reinterpret_cast<float*>(s1 + lpb * kt),
               reinterpret_cast<uint8_t*>(s1 + n * lpb * kt)};
}

// The float bands' tensor maps (K2: em; K3: em, bm; unused by cp.async).
struct RelMaps {
  CUtensorMap m[2];
};

// Starts the copy of diagonals d0 .. d0 + n - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into stage buffer S (the caller commits the cp.async
// group): the NP float bands (TMA: thread 0 asks for their boxes, to land
// on barrier bar; cp.async: thread tid copies lane tid % LPB of rows
// tid / LPB + 32 i, so a warp moves 32 / LPB rows of LPB lanes a step), s1
// and, unless it is null, bls, and the valid bytes.
template <int NP, int LPB, int KT, bool TMA>
__device__ __forceinline__ void rel_stage(
    const RelIn& S, const float* const (&band)[NP], const RelMaps& maps,
    uint64_t* bar, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ s1, const float* __restrict__ bls, int d0,
    int n, int b0, int Wp, int B, bool vec) {
  const int l = threadIdx.x % LPB, b = b0 + l;
  const size_t plane = rel_plane(Wp, KT, LPB, TMA);
  if (TMA) {
    if (threadIdx.x == 0) {
      mk::tma_expect(bar, NP * KT * Wp * LPB * 4u);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::tma_load(S.p + q * plane, &maps.m[q], b0, 0, d0, bar);
    }
  } else if (b < B) {
    const size_t g = (size_t)d0 * Wp * B + b;
    float* s = S.p + l * rel_stride(Wp, KT);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::cp_async4(s + q * plane + r, band[q] + g + (size_t)r * B);
  }
  const int kb = threadIdx.x / LPB;  // the tile diagonal of its records
  if (kb < n && b < B) {
    const size_t o = (size_t)(d0 + kb) * B + b;
    mk::cp_async4(S.s1 + l * KT + kb, s1 + o);
    if (bls != nullptr) mk::cp_async4(S.bls + l * KT + kb, bls + o);
  }
  mk::stage_bytes<LPB>(S.v, valid, (size_t)d0 * Wp, n * Wp, b0, B, vec);
}

// Writes the rows of output tile O (diagonals d0 .. d0 + n - 1 of the
// block's lanes) to dst in rel_stage's order, and, unless bls is null, the
// bls records after them.
template <int LPB, int KT>
__device__ __forceinline__ void rel_flush(const float* O, int d0, int n,
                                          int b0, int Wp, int B,
                                          float* __restrict__ dst,
                                          float* __restrict__ bls) {
  const int l = threadIdx.x % LPB, b = b0 + l;
  if (b >= B) return;
  const size_t g = (size_t)d0 * Wp * B + b;
  const float* s = O + l * rel_stride(Wp, KT);
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
    dst[g + (size_t)r * B] = s[r];
  const int kb = threadIdx.x / LPB;
  if (bls != nullptr && kb < n)
    bls[(size_t)(d0 + kb) * B + b] = O[LPB * rel_stride(Wp, KT) + l * KT + kb];
}

// Lane w's band rows (mk::WarpRows: row k = RPT kk + r on thread kk), where
// its cells lie in a stage buffer, and the band's row moves.
template <int RPT, int LPB, bool TMA>
struct RelLane {
  static constexpr int KT = rel_kt(RPT), SB = mk::byte_stride(LPB);
  mk::WarpRows<RPT> rows;
  int Wp, w;
  size_t plane;
  // A row's plane offset at each tile diagonal (TMA: swizzled) or at
  // diagonal 0 (cp.async: a diagonal adds Wp), its valid byte's at
  // diagonal 0 (a diagonal adds Wp SB); rows past the band read row
  // Wp - 1 (their results are never used).  The TMA offsets stay in
  // registers only while every read names its diagonal by a constant (the
  // unrolled tiles: `at<true>`); a partial tile computes them.
  int off[TMA ? KT : 1][RPT], voff[RPT];

  __device__ RelLane(int Wp_, int w_)
      : rows(Wp_), Wp(Wp_), w(w_), plane(rel_plane(Wp_, KT, LPB, TMA)) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = min(row(r), Wp - 1);
      voff[r] = k * SB + w;
      if (TMA) {
#pragma unroll
        for (int kb = 0; kb < (TMA ? KT : 1); ++kb)
          off[kb][r] = mk::swizzled<LPB>(kb * Wp + k, w);
      } else {
        off[0][r] = w * rel_stride(Wp, KT) + k;
      }
    }
  }

  __device__ int row(int r) const { return rows.row(r); }
  template <bool FIXED>
  __device__ int at(int kb, int r) const {
    if constexpr (!TMA) return off[0][r] + kb * Wp;
    else if constexpr (FIXED) return off[kb][r];
    else return mk::swizzled<LPB>(kb * Wp + min(row(r), Wp - 1), w);
  }
  __device__ float valid(const RelIn& S, int kb, int r) const {
    return S.v[voff[r] + kb * Wp * SB] != 0 ? 1.f : 0.f;
  }

  // out = v at row k + t, the plain versions' `shift`: t = +-1 moves the
  // band one row (wrapping at Wp), any other t leaves it in place.  The
  // move is the same for the warp's rows; at one row a thread it is one
  // shuffle from the lane holding row k + t.
  template <class T>
  __device__ __forceinline__ void move(const T (&v)[RPT], T (&out)[RPT],
                                       int t) const {
    if constexpr (RPT == 1) {
      out[0] = __shfl_sync(mk::FULL, v[0],
                           t == 1 ? rows.up_src
                                  : (t == -1 ? rows.dn_src : rows.kk));
    } else {
      rows.roll(v, out, (t == 1) - (t == -1));
    }
  }
};

// Rescales frontier v by its band max over the rows in the band and the
// five states (a warp reduction; the max is exact, so its order does not
// matter), factor 1 where there is no mass; returns the factor.
template <int RPT>
__device__ __forceinline__ float rescale(const mk::WarpRows<RPT>& rows,
                                         int Wp, float (&v)[RPT][5]) {
  float m = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    if (rows.row(r) < Wp)
      m = fmaxf(m, fmaxf(fmaxf(fmaxf(v[r][0], v[r][1]),
                               fmaxf(v[r][2], v[r][3])), v[r][4]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(mk::FULL, m, o));
  const float c = m > 0.f ? m : 1.f;
  const float inv = 1.f / c;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int s = 0; s < 5; ++s) v[r][s] = v[r][s] * inv;
  return c;
}

// K2's lane: the scaled backward.  After step(d), nb holds generation d;
// p1, p2 hold e_M * b_M of d+1 and d+2 and g the gap states of d+1 (as the
// next step reads them, before their shifts), sh1 and sh2 the s1 of d+1
// and d+2.
template <int RPT, int LPB, bool TMA>
struct RelBackward {
  static constexpr int KT = rel_kt(RPT);
  // One diagonal's inputs.
  struct In {
    float e[RPT], v[RPT];
    int s1;
  };
  const FbCoef& A;
  RelLane<RPT, LPB, TMA> lane;
  int fd;
  bool at_fk[RPT];  // row k is the terminal row
  float bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;
  float nb[RPT][5], p1[RPT], p2[RPT], g[4][RPT];

  __device__ RelBackward(const FbCoef& A_, int Wp, int w, int fd_, int fk)
      : A(A_), lane(Wp, w), fd(fd_) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      at_fk[r] = lane.row(r) == fk;
      p1[r] = p2[r] = g[0][r] = g[1][r] = g[2][r] = g[3][r] = 0.f;
    }
  }

  // (FIXED: kb is a constant.)
  template <bool FIXED>
  __device__ __forceinline__ In load(const RelIn& S, int kb) const {
    In a;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      a.e[r] = S.p[lane.template at<FIXED>(kb, r)];
      a.v[r] = lane.valid(S, kb, r);
    }
    a.s1 = S.s1[lane.w * KT + kb];
    return a;
  }

  // Diagonals d0 + n - 1 down to d0 (a tile) from stage buffer S: the
  // lane's bm rows to out, its bls to obls.  A whole tile runs unrolled,
  // each diagonal's inputs read one diagonal ahead.
  __device__ __forceinline__ void tile(const RelIn& S, float* out,
                                       float* obls, int d0, int n) {
    if (n == KT) {
      In cur = load<true>(S, KT - 1);
#pragma unroll
      for (int kb = KT - 1; kb >= 0; --kb) {
        const In next = load<true>(S, kb > 0 ? kb - 1 : 0);
        step(d0 + kb, kb, cur, out, obls);
        cur = next;
      }
    } else {
      for (int kb = n - 1; kb >= 0; --kb)
        step(d0 + kb, kb, load<false>(S, kb), out, obls);
    }
  }

  // Generation d (tile diagonal kb, d % 8 == kb % 8), in the plain
  // version's order: q0 = e_M b_M of d+2 at row k + 1 - s2 (divided by the
  // previous factor at d % 8 == 7), the gap states of d+1 at rows k - s1
  // (1, 3) and k + 1 - s1 (2, 4); nb[s] = (sum_u A[s][u] q[u] + inj) *
  // valid.
  __device__ __forceinline__ void step(int d, int kb, const In& a,
                                       float* out, float* obls) {
    float q0[RPT], q[4][RPT];
    lane.move(p2, q0, 1 - (sh1 + sh2));
#pragma unroll
    for (int u = 0; u < 4; ++u) lane.move(g[u], q[u], (u & 1) - sh1);
    const bool divide = (kb & 7) == 7, at_fd = d == fd;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float x[5] = {divide ? q0[r] / cprev : q0[r], q[0][r], q[1][r],
                          q[2][r], q[3][r]};
      const float inj = at_fd & at_fk[r] ? 1.f : 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        float acc = A.a[s * 5] * x[0];
#pragma unroll
        for (int u = 1; u < 5; ++u) acc = acc + A.a[s * 5 + u] * x[u];
        nb[r][s] = (acc + inj) * a.v[r];
      }
    }
    sh2 = sh1;
    sh1 = a.s1;
    if ((kb & 7) == 0) {
      const float c = rescale(lane.rows, lane.Wp, nb);
      bls += logf(c);
      cprev = c;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (lane.row(r) < lane.Wp) out[kb * lane.Wp + lane.row(r)] = nb[r][0];
      p2[r] = p1[r];
      p1[r] = a.e[r] * nb[r][0];
#pragma unroll
      for (int s = 1; s < 5; ++s) g[s - 1][r] = nb[r][s];
    }
    if (lane.rows.kk == 0) obls[kb] = bls;
  }

  // logZ from generation 0 (row 0 is r = 0 of thread 0).
  __device__ void write_logz(float* __restrict__ logZ) const {
    if (lane.rows.kk != 0) return;
    const float z =
        0.2f * ((((nb[0][0] + nb[0][1]) + nb[0][2]) + nb[0][3]) + nb[0][4]);
    *logZ = logf(fmaxf(z, 1e-30f)) + bls;
  }
};

// K3's lane: the scaled forward.  f is the frontier of the last step;
// mm1, mm2 hold the match mixes of d-2 and d-1 and g the gap-target mixes
// of d-1 for step d (before their shifts), sprev the s1 of d-1.
template <int RPT, int LPB, bool TMA>
struct RelForward {
  static constexpr int KT = rel_kt(RPT);
  struct In {
    float e[RPT], bm[RPT], v[RPT];
    int s1;
    float bls;
  };
  const FbCoef& A;
  RelLane<RPT, LPB, TMA> lane;
  float lz, ls = 0.f, cprev = 1.f;
  int sprev = 0;
  float f[RPT][5], mm1[RPT], mm2[RPT], g[4][RPT];

  __device__ RelForward(const FbCoef& A_, int Wp, int w, float lz_)
      : A(A_), lane(Wp, w), lz(lz_) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      mm1[r] = mm2[r] = g[0][r] = g[1][r] = g[2][r] = g[3][r] = 0.f;
  }

  // (FIXED: kb is a constant.)
  template <bool FIXED>
  __device__ __forceinline__ In load(const RelIn& S, int kb) const {
    In a;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int o = lane.template at<FIXED>(kb, r);
      a.e[r] = S.p[o];
      a.bm[r] = S.p[lane.plane + o];
      a.v[r] = lane.valid(S, kb, r);
    }
    a.s1 = S.s1[lane.w * KT + kb];
    a.bls = S.bls[lane.w * KT + kb];
    return a;
  }

  // The posterior's scale alpha = exp(ls + bls - logZ) of the rescale
  // period starting at tile diagonal kb0, thread j for its diagonal
  // kb0 + j % 8 (ls moves only at a period's last diagonal, which computes
  // its own), to be shuffled out.
  __device__ __forceinline__ float scales(const RelIn& S, int kb0) const {
    return expf(ls + S.bls[lane.w * KT + kb0 + (lane.rows.kk & 7)] - lz);
  }

  // Diagonals d0 .. d0 + n - 1 (a tile) from stage buffer S: the lane's
  // posterior rows to out.  A whole tile but the first runs unrolled, each
  // diagonal's inputs read one diagonal ahead.
  __device__ __forceinline__ void tile(const RelIn& S, float* out, int d0,
                                       int n) {
    float a = scales(S, 0);
    int kb = 0;
    if (d0 == 0) {
      start(load<true>(S, 0), __shfl_sync(mk::FULL, a, 0), out);
      kb = 1;
    }
    if (kb == 0 && n == KT) {
      In cur = load<true>(S, 0);
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const In next = load<true>(S, q + 1 < KT ? q + 1 : q);
        if (q > 0 && (q & 7) == 0) a = scales(S, q);
        step(q, cur, __shfl_sync(mk::FULL, a, q & 7), out);
        cur = next;
      }
    } else {
      for (; kb < n; ++kb) {
        if ((kb & 7) == 0) a = scales(S, kb);
        step(kb, load<false>(S, kb), __shfl_sync(mk::FULL, a, kb & 7), out);
      }
    }
  }

  // d = 0: the uniform start distribution at row 0 (generation -1 is
  // empty, so the mixes of d-2 are zero).
  __device__ void start(const In& a, float alpha, float* out) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int s = 0; s < 5; ++s) f[r][s] = lane.row(r) == 0 ? 0.2f : 0.f;
    sprev = a.s1;
    emit(0, a, alpha, out);
  }

  // Generation d >= 1 (tile diagonal kb, d % 8 == kb % 8), in the plain
  // version's order: f_M = e * (the match mix of d-2 at row k + s2 - 1,
  // divided by the previous factor at d % 8 == 0), the gap states = the gap
  // mixes of d-1 at rows k + s1 (1, 3) and k + s1 - 1 (2, 4), times valid.
  __device__ __forceinline__ void step(int kb, const In& a, float alpha,
                                       float* out) {
    const int t1 = a.s1, t2 = t1 + sprev;
    sprev = t1;
    float mm[RPT], q[4][RPT];
    lane.move(mm1, mm, t2 - 1);
#pragma unroll
    for (int u = 0; u < 4; ++u) lane.move(g[u], q[u], t1 - (u & 1));
    const bool divide = (kb & 7) == 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      f[r][0] = a.e[r] * (divide ? mm[r] / cprev : mm[r]);
#pragma unroll
      for (int s = 1; s < 5; ++s) f[r][s] = q[s - 1][r] * a.v[r];
    }
    if ((kb & 7) == 7) {
      const float c = rescale(lane.rows, lane.Wp, f);
      ls += logf(c);
      cprev = c;
      alpha = expf(ls + a.bls - lz);
    }
    emit(kb, a, alpha, out);
  }

  // The posterior row f_M * b_M * alpha, then the mixes generation d
  // contributes: the match target at d+2 and the gap targets at d+1.
  __device__ __forceinline__ void emit(int kb, const In& a, float alpha,
                                       float* out) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (lane.row(r) < lane.Wp)
        out[kb * lane.Wp + lane.row(r)] = f[r][0] * a.bm[r] * alpha;
      float mx[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        float acc = f[r][0] * A.a[t];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc = acc + f[r][s] * A.a[s * 5 + t];
        mx[t] = acc;
      }
      mm1[r] = mm2[r];
      mm2[r] = mx[0];
#pragma unroll
      for (int t = 1; t < 5; ++t) g[t - 1][r] = mx[t];
    }
  }
};

// The block of LPB lanes of K2 / K3 (lane b0 + w on warp w): tile u of the
// walk (K2 from the top, K3 from d = 0) comes into stage buffer
// u % REL_STAGES, REL_STAGES - 1 tiles ahead, one cp.async group a tile
// (empty past the last, so that waits count tiles), and leaves from output
// tile u & 1 once the next tile's barrier has passed.
template <int LPB, int KT, bool TMA>
struct RelBlock {
  uint8_t* raw;
  int n, Wp;
  size_t nin, nout;
  uint64_t* bars;

  __device__ RelBlock(uint8_t* smem, bool fwd, int Wp_)
      : raw(TMA ? smem + ((1024 - mk::smem_addr(smem) % 1024) % 1024)
                : smem),
        n(fwd ? 2 : 1), Wp(Wp_), nin(rel_in_bytes(n, Wp_, KT, LPB, TMA)),
        nout(rel_out_bytes(!fwd, Wp_, KT, LPB)),
        bars(reinterpret_cast<uint64_t*>(raw + REL_STAGES * nin +
                                         2 * nout)) {
    if (TMA && threadIdx.x == 0) {
      for (int s = 0; s < REL_STAGES; ++s) mk::mbar_init(bars + s);
      mk::mbar_init_fence();
    }
    if (TMA) __syncthreads();
  }

  __device__ RelIn in(int u) const {
    return rel_in(raw + (u % REL_STAGES) * nin, n, Wp, KT, LPB, TMA);
  }
  __device__ uint64_t* bar(int u) const { return bars + u % REL_STAGES; }
  __device__ float* out(int u) const {
    return reinterpret_cast<float*>(raw + REL_STAGES * nin + (u & 1) * nout);
  }
  // Tile u has landed (this thread's copies, with TMA the barrier's phase
  // u / REL_STAGES, then everyone's): every warp is past tile u - 1.
  __device__ void wait(int u) const {
    mk::cp_async_wait_but<REL_STAGES - 2>();
    if (TMA) mk::mbar_wait(bar(u), (u / REL_STAGES) & 1);
    __syncthreads();
  }
};

template <int RPT, int LPB, bool TMA>
__global__ void __launch_bounds__(32 * LPB)
    rel_backward_kernel(const float* __restrict__ em,
                        const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ s1,
                        const int32_t* __restrict__ final_d,
                        const int32_t* __restrict__ final_k,
                        const __grid_constant__ RelMaps maps, FbCoef A,
                        int D1, int Wp, int B, int vec,
                        float* __restrict__ bm, float* __restrict__ bls,
                        float* __restrict__ logZ) {
  constexpr int KT = rel_kt(RPT);
  extern __shared__ __align__(16) uint8_t rel_raw[];
  const RelBlock<LPB, KT, TMA> blk(rel_raw, false, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  // Tile u from the top: its first diagonal and its count (the top tile is
  // partial when D1 is no multiple of KT).
  const int tiles = (D1 + KT - 1) / KT;
  auto first = [&](int u) { return (tiles - 1 - u) * KT; };
  auto count = [&](int u) { return min(KT, D1 - first(u)); };
  const float* const bands[1] = {em};
  auto stage = [&](int u) {
    if (u < tiles)
      rel_stage<1, LPB, KT, TMA>(blk.in(u), bands, maps, blk.bar(u), valid,
                                 s1, nullptr, first(u), count(u), b0, Wp, B,
                                 vec);
    mk::cp_async_commit();
  };
  RelBackward<RPT, LPB, TMA> lane(A, Wp, w, live ? final_d[b] : -1,
                                  live ? final_k[b] : -1);
  for (int u = 0; u < REL_STAGES - 1; ++u) stage(u);
  for (int u = 0; u < tiles; ++u) {
    blk.wait(u);
    if (u > 0)
      rel_flush<LPB, KT>(blk.out(u - 1), first(u - 1), count(u - 1), b0, Wp,
                         B, bm, bls);
    stage(u + REL_STAGES - 1);
    if (live) {
      float* o = blk.out(u);
      lane.tile(blk.in(u), o + w * rel_stride(Wp, KT),
                o + LPB * rel_stride(Wp, KT) + w * KT, first(u), count(u));
    }
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), 0, count(tiles - 1), b0, Wp, B, bm,
                     bls);
  if (live) lane.write_logz(logZ + b);
}

template <int RPT, int LPB, bool TMA>
__global__ void __launch_bounds__(32 * LPB)
    rel_forward_kernel(const float* __restrict__ em,
                       const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ s1,
                       const float* __restrict__ bm,
                       const float* __restrict__ bls,
                       const float* __restrict__ logZ,
                       const __grid_constant__ RelMaps maps, FbCoef A,
                       int D1, int Wp, int B, int vec,
                       float* __restrict__ post) {
  constexpr int KT = rel_kt(RPT);
  extern __shared__ __align__(16) uint8_t rel_raw[];
  const RelBlock<LPB, KT, TMA> blk(rel_raw, true, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const int tiles = (D1 + KT - 1) / KT;
  auto count = [&](int t) { return min(KT, D1 - t * KT); };
  const float* const bands[2] = {em, bm};
  auto stage = [&](int t) {
    if (t < tiles)
      rel_stage<2, LPB, KT, TMA>(blk.in(t), bands, maps, blk.bar(t), valid,
                                 s1, bls, t * KT, count(t), b0, Wp, B, vec);
    mk::cp_async_commit();
  };
  RelForward<RPT, LPB, TMA> lane(A, Wp, w, live ? logZ[b] : 0.f);
  for (int t = 0; t < REL_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    blk.wait(t);
    if (t > 0)
      rel_flush<LPB, KT>(blk.out(t - 1), (t - 1) * KT, count(t - 1), b0, Wp,
                         B, post, nullptr);
    stage(t + REL_STAGES - 1);
    if (live)
      lane.tile(blk.in(t), blk.out(t) + w * rel_stride(Wp, KT), t * KT,
                count(t));
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), (tiles - 1) * KT, count(tiles - 1),
                     b0, Wp, B, post, nullptr);
}

// Whether the pair's launch at (Wp, B) takes TMA, as K4's does (csrc/mea.cu
// `mea_tma`): B a multiple of 4, at most two rows a thread, an encoder.
bool rel_tma(int Wp, int B) {
  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&
         mk::tensor_map_encoder() != nullptr;
}

template <bool FWD, int LPB, bool TMA, int RPT>
const void* rel_kernel_of() {
  if constexpr (FWD) return (const void*)rel_forward_kernel<RPT, LPB, TMA>;
  else return (const void*)rel_backward_kernel<RPT, LPB, TMA>;
}

// (TMA only at one and two rows a thread: `rel_tma`; 16 lanes a block
// only there too: `rel_lanes`.)
template <bool FWD, int LPB, bool TMA>
const void* rel_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return rel_kernel_of<FWD, LPB, TMA, 1>();
    case 2: return rel_kernel_of<FWD, LPB, TMA, 2>();
    case 3:
      return TMA || LPB > 8 ? nullptr : rel_kernel_of<FWD, 8, false, 3>();
    case 4:
      return TMA || LPB > 8 ? nullptr : rel_kernel_of<FWD, 8, false, 4>();
  }
  return nullptr;
}

template <bool FWD>
const void* rel_kernel(int Wp, int lanes, bool tma) {
  switch (lanes) {
    case 8: return tma ? rel_kernel_rpt<FWD, 8, true>(Wp)
                       : rel_kernel_rpt<FWD, 8, false>(Wp);
    case 16: return tma ? rel_kernel_rpt<FWD, 16, true>(Wp)
                        : rel_kernel_rpt<FWD, 16, false>(Wp);
  }
  return nullptr;
}

// The lanes a block of K2's (fwd false) or K3's launch at (Wp, B):
// mk::warp_lanes' (16 where that block fits and B >= 16 x SMs, else 8),
// but 8 above two rows a thread, where 16 lanes' 512 threads get at most
// 128 registers and spill.
cudaError_t rel_lanes(bool fwd, int Wp, int B, bool tma, int* lanes) {
  const bool narrow = mk::rows_per_thread(Wp) > 2;
  return mk::warp_lanes(
      B,
      [=](int l) {
        return narrow && l > 8 ? SIZE_MAX : rel_smem(fwd, Wp, l, tma);
      },
      lanes);
}

// The kernel, lanes a block (rel_lanes) and shared memory of K2's (fwd
// false) or K3's launch at (Wp, B), with or without TMA, its shared memory
// opted in.
cudaError_t rel_setup(bool fwd, int Wp, int B, bool tma, const void** kernel,
                      int* lanes, size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  cudaError_t err = rel_lanes(fwd, Wp, B, tma, lanes);
  if (err != cudaSuccess) return err;
  *kernel = fwd ? rel_kernel<true>(Wp, *lanes, tma)
                : rel_kernel<false>(Wp, *lanes, tma);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = rel_smem(fwd, Wp, *lanes, tma);
  return mk::allow_smem(*kernel, *smem);
}

// Sets up K2's or K3's launch at (D1, Wp, B) on its float bands (K2: em;
// K3: em, bm): TMA where rel_tma allows it and every band maps, else
// cp.async.
cudaError_t rel_launch_setup(bool fwd, const float* const* bands, int D1,
                             int Wp, int B, RelMaps* maps,
                             const void** kernel, int* lanes, size_t* smem) {
  memset(maps, 0, sizeof(*maps));
  bool tma = rel_tma(Wp, B);
  cudaError_t err = rel_setup(fwd, Wp, B, tma, kernel, lanes, smem);
  if (err != cudaSuccess || !tma) return err;
  for (int q = 0; q < (fwd ? 2 : 1); ++q)
    if (!mk::band_map(&maps->m[q], bands[q], D1, Wp, B, *lanes,
                      rel_kt(mk::rows_per_thread(Wp))))
      return rel_setup(fwd, Wp, B, false, kernel, lanes, smem);
  return cudaSuccess;
}

// ------------------------------------------------------ multi-problem lanes
//
// fb_multi_forward   <- fb_pallas.py `_make_fwd_kernel_pre_multi`
//                       (`_posteriors_pre_multi`, first pallas_call): the
//                       scaled forward over lanes that hold several
//                       problems one after another, separated by SPACER
//                       empty diagonals (ops/band.py
//                       `pack_multi_banded_batch`).  Where `start` marks a
//                       problem's local d = 0, band row 0 is seeded with
//                       the start distribution: the gap-chain form
//                       overwrites (M 0.2, scaled gap states pi[t]), the
//                       generic form adds 0.2 to every state (the frontier
//                       is zero there: the spacers cleared it).  s2 is
//                       derived, s1(d) + s1(d - 1).  Writes the scaled
//                       match plane fm, the cumulative log-scale lsf of
//                       each diagonal, and the terminal sum term at the
//                       row `fink` marks (gap states weighted back by k in
//                       the chain form), 0 on other diagonals.  The rescale
//                       schedule keys on the global diagonal, so lsf runs
//                       on across every problem of a lane.
// fb_multi_backward  <- `_make_bwd_kernel_pre_multi` (second pallas_call):
//                       the scaled backward, run after the forward; at
//                       every terminal diagonal (`find` == d) it injects 1
//                       at row `fink` (chain: overwrite, with r[t] for the
//                       scaled gap states) and resets the cumulative scale
//                       to 0, and it writes the posterior
//                       post = fm * b_M * exp(lsf + bls - L), where L is
//                       log(term) + lsf at the owning problem's terminal
//                       diagonal, so each problem normalises by its own
//                       likelihood.
// The model comes as the 58 coefficients of both forms (common.cuh
// `FlatGapCoef`); `chain` picks the form, as the TPU kernels pick theirs
// when they are traced.  Rescaling as in the pair above.  Same bound as
// the pair above: 9-13 B per cell against ~35 operations, the chain of D1
// dependent diagonals first.  Design: a block owns 32 lanes x all Wp rows
// (common.cuh's block layout), the frontier in registers and shared memory,
// mixes published before the row shift, so each diagonal crosses shared
// memory once: one block barrier a diagonal, two on rescale steps
// (mk::band_max).

// The 12 shared-memory planes [Wp][32] of a block: gap states or mixes
// [2][4], the match term [3], the rescale's row maxima.
size_t fb_smem(int Wp) { return (size_t)12 * Wp * mk::LANES * sizeof(float); }

template <int RPT>
__global__ void __launch_bounds__(1024)
    fb_multi_forward_kernel(const float* __restrict__ em,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ s1,
                            const int8_t* __restrict__ start,
                            const int32_t* __restrict__ fink,
                            mk::FlatGapCoef K, int chain, int D1, int Wp,
                            int B, float* __restrict__ fm,
                            float* __restrict__ lsf,
                            float* __restrict__ term) {
  extern __shared__ float smem[];
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  float* shG = smem;             // [2][4][Wp][L] gap-target mixes of d-1
  float* shM = shG + 8 * plane;  // [3][Wp][L] match mix of d-2 (d mod 3)
  float* shR = shM + 3 * plane;  // [Wp][L] row maxima for the rescale
  for (int i = ty * L + lane; i < 12 * plane; i += TY * L) smem[i] = 0.f;

  float f[RPT][5];
  // Writes the mixes generation d contributes: gap targets at d+1 and the
  // match target at d+2.
  auto publish = [&](int d) {
    const int gout = ((d + 1) & 1) * 4 * plane;
    const int mout = ((d + 2) % 3) * plane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
      float mm;
      if (chain) {
        mm = K.t00 * f[r][0];
#pragma unroll
        for (int s = 1; s < 5; ++s) mm = mm + K.mc[s - 1] * f[r][s];
      } else {
        mm = f[r][0] * K.a[0];
#pragma unroll
        for (int s = 1; s < 5; ++s) mm = mm + f[r][s] * K.a[s * 5];
      }
      shM[mout + i] = mm;
#pragma unroll
      for (int u = 1; u < 5; ++u) {
        float g;
        if (chain) {
          g = f[r][0] + K.c[u - 1] * f[r][u];
        } else {
          g = f[r][0] * K.a[u];
#pragma unroll
          for (int s = 1; s < 5; ++s) g = g + f[r][s] * K.a[s * 5 + u];
        }
        shG[gout + (u - 1) * plane + i] = g;
      }
    }
  };

  float ls = 0.f, cprev = 1.f;
  int sprev = 0;
  __syncthreads();
  for (int d = 0; d < D1; ++d) {
    const size_t row = (size_t)d * B + b;
    const int t1 = live ? s1[row] : 0;
    const int t2 = t1 + sprev;
    sprev = t1;
    const bool seeds = live && start[row] != 0;
    const int fk = live ? fink[row] : -1;
    const int gin = (d & 1) * 4 * plane, min_ = (d % 3) * plane;
    const bool divide = d % 8 == 0;
    bool owns = false;  // this thread holds row fk
    float tv = 0.f;     // the terminal sum at row fk
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      float v = 0.f, e = 0.f;
      if (live) {
        const size_t c = mk::cell(d, k, b, Wp, B);
        v = (float)valid[c];
        e = em[c];
      }
      float mm = shM[min_ + mk::wrap(k + t2 - 1, Wp) * L + lane];
      if (divide) mm = mm / cprev;
      const float g1 = shG[gin + mk::wrap(k + t1, Wp) * L + lane];
      const float g2 = shG[gin + plane + mk::wrap(k + t1 - 1, Wp) * L + lane];
      const float g3 =
          shG[gin + 2 * plane + mk::wrap(k + t1, Wp) * L + lane];
      const float g4 =
          shG[gin + 3 * plane + mk::wrap(k + t1 - 1, Wp) * L + lane];
      const bool seed = seeds && k == 0;
      if (chain) {
        f[r][0] = seed ? 0.2f : e * mm;
        f[r][1] = seed ? K.pi[0] : g1 * v;
        f[r][2] = seed ? K.pi[1] : g2 * v;
        f[r][3] = seed ? K.pi[2] : g3 * v;
        f[r][4] = seed ? K.pi[3] : g4 * v;
      } else {
        const float inj = seed ? 0.2f : 0.f;
        f[r][0] = e * mm * v + inj;
        f[r][1] = g1 * v + inj;
        f[r][2] = g2 * v + inj;
        f[r][3] = g3 * v + inj;
        f[r][4] = g4 * v + inj;
      }
      if (k == fk) {
        owns = true;
        if (chain) {
          tv = f[r][0];
#pragma unroll
          for (int s = 1; s < 5; ++s) tv = tv + K.k[s - 1] * f[r][s];
        } else {
          tv = (((f[r][0] + f[r][1]) + f[r][2]) + f[r][3]) + f[r][4];
        }
      }
    }
    if (d % 8 == 7) {
      const float m = mk::band_max<RPT>(f, shR, Wp, L, lane, ty, TY);
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
      tv = tv * inv;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) f[r][s] *= inv;
      ls += logf(c);
      cprev = c;
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int k = ty + r * TY;
        if (k < Wp) fm[mk::cell(d, k, b, Wp, B)] = f[r][0];
      }
      if (ty == 0) lsf[row] = ls;
      if (owns) term[row] = tv;
      else if (ty == 0 && (fk < 0 || fk >= Wp)) term[row] = 0.f;
    }
    publish(d);
    __syncthreads();
  }
}

template <int RPT>
__global__ void __launch_bounds__(1024)
    fb_multi_backward_kernel(const float* __restrict__ fm,
                             const float* __restrict__ lsf,
                             const float* __restrict__ Lp,
                             const float* __restrict__ em,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ s1,
                             const int32_t* __restrict__ fink,
                             const int32_t* __restrict__ find,
                             mk::FlatGapCoef K, int chain, int D1, int Wp,
                             int B, float* __restrict__ post) {
  extern __shared__ float smem[];
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  float* shG = smem;              // [2][4][Wp][L] gap states of d+1 (parity)
  float* shP = shG + 8 * plane;   // [3][Wp][L] e_M * b_M of d+2 (d mod 3)
  float* shR = shP + 3 * plane;   // [Wp][L] row maxima for the rescale
  for (int i = ty * L + lane; i < 12 * plane; i += TY * L) smem[i] = 0.f;

  float bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;  // s1 at d+1 and d+2
  float nb[RPT][5];
  __syncthreads();

  for (int d = D1 - 1; d >= 0; --d) {
    const size_t row = (size_t)d * B + b;
    const int s1n = sh1, s2n = sh1 + sh2;
    const int gin = ((d + 1) & 1) * 4 * plane, gout = (d & 1) * 4 * plane;
    const int pin = ((d + 2) % 3) * plane, pout = (d % 3) * plane;
    const bool divide = d % 8 == 7;
    const int fk = live ? fink[row] : -1;
    const bool is_term = live && find[row] == d;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const float v = live ? (float)valid[mk::cell(d, k, b, Wp, B)] : 0.f;
      const int kx = mk::wrap(k - s1n, Wp) * L + lane;
      const int ky = mk::wrap(k + 1 - s1n, Wp) * L + lane;
      float q[5];
      q[0] = shP[pin + mk::wrap(k + 1 - s2n, Wp) * L + lane];
      if (divide) q[0] = q[0] / cprev;
      q[1] = shG[gin + kx];
      q[2] = shG[gin + plane + ky];
      q[3] = shG[gin + 2 * plane + kx];
      q[4] = shG[gin + 3 * plane + ky];
      if (chain) {
        // fink is -1 off terminal diagonals, so it gates by itself.
        const bool inj = k == fk;
        float acc0 = K.t00 * q[0];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc0 = acc0 + K.m0[s - 1] * q[s];
        nb[r][0] = (inj ? 1.f : acc0) * v;
#pragma unroll
        for (int s = 1; s < 5; ++s) {
          const float accs = q[0] + K.cb[s - 1] * q[s];
          nb[r][s] = (inj ? K.r[s - 1] : accs) * v;
        }
      } else {
        const float injv = (is_term && k == fk) ? 1.f : 0.f;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          float acc = q[0] * K.a[s * 5];
#pragma unroll
          for (int u = 1; u < 5; ++u) acc = acc + q[u] * K.a[s * 5 + u];
          nb[r][s] = (acc + injv) * v;
        }
      }
    }
    sh2 = sh1;
    sh1 = live ? s1[row] : 0;
    // Each problem's scale baseline starts at its terminal diagonal.
    if (is_term) bls = 0.f;
    if (d % 8 == 0) {
      const float m = mk::band_max<RPT>(nb, shR, Wp, L, lane, ty, TY);
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) nb[r][s] *= inv;
      bls += logf(c);
      cprev = c;
    }
    const float alpha = live ? expf(lsf[row] + bls - Lp[row]) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
      float e = 0.f;
      if (live) {
        const size_t c = mk::cell(d, k, b, Wp, B);
        post[c] = fm[c] * nb[r][0] * alpha;
        e = em[c];
      }
      shP[pout + i] = e * nb[r][0];
#pragma unroll
      for (int g = 0; g < 4; ++g) shG[gout + g * plane + i] = nb[r][g + 1];
    }
    __syncthreads();
  }
}

template <int RPT>
cudaError_t run_multi_forward(const float* em, const uint8_t* valid,
                              const int32_t* s1, const int8_t* start,
                              const int32_t* fink,
                              const mk::FlatGapCoef& K, int chain, int D1,
                              int Wp, int B, float* fm, float* lsf,
                              float* term, cudaStream_t stream) {
  cudaError_t err = mk::allow_smem(
      (const void*)fb_multi_forward_kernel<RPT>, fb_smem(Wp));
  if (err != cudaSuccess) return err;
  fb_multi_forward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fb_smem(Wp), stream>>>(
          em, valid, s1, start, fink, K, chain, D1, Wp, B, fm, lsf, term);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t run_multi_backward(const float* fm, const float* lsf,
                               const float* Lp, const float* em,
                               const uint8_t* valid, const int32_t* s1,
                               const int32_t* fink, const int32_t* find,
                               const mk::FlatGapCoef& K, int chain, int D1,
                               int Wp, int B, float* post,
                               cudaStream_t stream) {
  cudaError_t err = mk::allow_smem(
      (const void*)fb_multi_backward_kernel<RPT>, fb_smem(Wp));
  if (err != cudaSuccess) return err;
  fb_multi_backward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fb_smem(Wp), stream>>>(
          fm, lsf, Lp, em, valid, s1, fink, find, K, chain, D1, Wp, B,
          post);
  return cudaGetLastError();
}

FbCoef load_coef(const float* coef) {
  FbCoef A;
  for (int i = 0; i < 25; ++i) A.a[i] = coef[i];
  return A;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 25 floats A[s][u]; device pointers for everything else.  Each returns
// a cudaError_t code.
extern "C" int fb_backward_launch(const uint8_t* valid, const float* em,
                                  const int32_t* s1, const int32_t* final_d,
                                  const int32_t* final_k, const float* coef,
                                  int D1, int Wp, int B, float* bm,
                                  float* bls, float* logZ, void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  FbCoef A = load_coef(coef);
  RelMaps maps;
  const void* kernel;
  int lanes;
  size_t smem;
  const float* bands[1] = {em};
  cudaError_t err =
      rel_launch_setup(false, bands, D1, Wp, B, &maps, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  int vec = mk::words_aligned(B, {valid});
  void* args[] = {&em, &valid, &s1, &final_d, &final_k, &maps, &A,
                  &D1, &Wp,    &B,  &vec,     &bm,      &bls,  &logZ};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

extern "C" int fb_forward_launch(const float* em, const uint8_t* valid,
                                 const int32_t* s1, const float* bm,
                                 const float* bls, const float* logZ,
                                 const float* coef, int D1, int Wp, int B,
                                 float* post, void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  FbCoef A = load_coef(coef);
  RelMaps maps;
  const void* kernel;
  int lanes;
  size_t smem;
  const float* bands[2] = {em, bm};
  cudaError_t err =
      rel_launch_setup(true, bands, D1, Wp, B, &maps, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  int vec = mk::words_aligned(B, {valid});
  void* args[] = {&em, &valid, &s1, &bm,  &bls, &logZ, &maps,
                  &A,  &D1,    &Wp, &B,   &vec, &post};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What K2's (backward != 0) or K3's launch at band width Wp over B lanes
// gets on this device (mk::kernel_info's out[5]; its lanes a block are
// out[3] / 32), with TMA where B allows it.
extern "C" int fb_rel_info(int backward, int Wp, int B, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = rel_setup(!backward, Wp, B, rel_tma(Wp, B), &kernel,
                              &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

// `coef` is a HOST pointer to the 58 floats of `mk::FlatGapCoef`.
extern "C" int fb_multi_forward_launch(const float* em, const uint8_t* valid,
                                       const int32_t* s1, const int8_t* start,
                                       const int32_t* fink, const float* coef,
                                       int chain, int D1, int Wp, int B,
                                       float* fm, float* lsf, float* term,
                                       void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const mk::FlatGapCoef K = mk::load_flat_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_multi_forward<1>(em, valid, s1, start, fink, K, chain, D1, Wp, B, fm, lsf, term, s);
    case 2: return run_multi_forward<2>(em, valid, s1, start, fink, K, chain, D1, Wp, B, fm, lsf, term, s);
    case 3: return run_multi_forward<3>(em, valid, s1, start, fink, K, chain, D1, Wp, B, fm, lsf, term, s);
    case 4: return run_multi_forward<4>(em, valid, s1, start, fink, K, chain, D1, Wp, B, fm, lsf, term, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int fb_multi_backward_launch(const float* fm, const float* lsf,
                                        const float* Lp, const float* em,
                                        const uint8_t* valid,
                                        const int32_t* s1,
                                        const int32_t* fink,
                                        const int32_t* find,
                                        const float* coef, int chain, int D1,
                                        int Wp, int B, float* post,
                                        void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const mk::FlatGapCoef K = mk::load_flat_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_multi_backward<1>(fm, lsf, Lp, em, valid, s1, fink, find, K, chain, D1, Wp, B, post, s);
    case 2: return run_multi_backward<2>(fm, lsf, Lp, em, valid, s1, fink, find, K, chain, D1, Wp, B, post, s);
    case 3: return run_multi_backward<3>(fm, lsf, Lp, em, valid, s1, fink, find, K, chain, D1, Wp, B, post, s);
    case 4: return run_multi_backward<4>(fm, lsf, Lp, em, valid, s1, fink, find, K, chain, D1, Wp, B, post, s);
    default: return cudaErrorInvalidValue;
  }
}
