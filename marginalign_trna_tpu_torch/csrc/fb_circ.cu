// The flat-gap forward-backward in the circular band layout: one scaled
// backward and one scaled forward recursion, each generic over where the
// match emissions come from (the emission source) and the forward over
// what leaves the kernel (the sink).
//
// Replaces the TPU kernels of marginalign_trna_tpu/ops/fb_pallas.py:
//   sv_backward  <- `_sv_backward_call` (`_make_bwd_kernel_circ_sv`): from
//                   the signed emission stream es (valid = es >= 0, match
//                   emission = max(es, 0)) the match-state backward band bm,
//                   the cumulative log-scale bls per diagonal and
//                   logZ = log(max(0.2 * zrow, 1e-30)) + bls[0].
//   cx_forward   <- `_cx_from_es` (`_make_fwd_kernel_circ_cx`): the scaled
//                   forward; post = f_M * b_M * exp(ls + bls - logZ) (the
//                   origin cell excluded) adds into one of four per-position
//                   accumulators by read code.  Before the add, the
//                   accumulators roll down one row (a reference position
//                   moves one row per diagonal), and the row fr[d] of the
//                   position completing at d leaves into fl[c][d] and is
//                   zeroed.  After the last diagonal the accumulators leave
//                   as tails.
//   mw_forward   <- `_mw_from_es` (`_make_fwd_kernel_circ_mw`): the same
//                   forward; post leaves in the band-relative layout
//                   (rel[k] = circ[(k + lo) mod Wp], lom = lo mod Wp), and
//                   post (the origin cell excluded) adds into a column
//                   accumulator that rolls like cx's and flushes at fr, and
//                   a row accumulator that stays put (a read position keeps
//                   its circular row) and flushes at frr (flc, flr, tails
//                   tc, tr).
// The serving kernels circ_backward_emv / _codes / _codes_es and
// circ_post_es / _emv / _codes are in csrc/fb_serve.cu, the checkpoint
// pair circ_ckpt_backward / circ_ckpt_post in csrc/fb_ckpt.cu.  Every
// kernel runs the recursions in the warp-per-lane layout
// (csrc/fb_circ.cuh): mw, cx, the serving forwards and the checkpoint
// posterior pass the forward's arithmetic (`WarpForward`, each with a sink
// of its own: "M: mw_forward" and "C: cx_forward" below), sv_backward, the
// serving backwards and the checkpoint backward and replay the backward's
// (`SvWarp`, `sv_walk`, over an emission source each).  The plain versions
// that fix the order of the arithmetic are ops/fb_circ_cuda.py's
// `_CircBackward` and `_CircForward`.
// In the circular layout row r holds read prefix index i = r (mod Wp), so
// every band motion is an unconditional roll by one row: the match move
// reads row k - 1 of generation d - 2 (forward) or k + 1 of d + 2
// (backward), gap states 2 and 4 row k -/+ 1 of d -/+ 1, gap states 1 and 3
// row k.  The model comes at run time (`CircCoef`) in one of two forms: the
// gap-chain form every cPecan model family takes (gap states exchange mass
// only with the match state; each gap mix is one multiply and one add) or
// the generic 5x5 mix.  Scaling as the TPU kernels: rescale by the band max
// at d % 8 == 0 (backward) and d % 8 == 7 (forward), factor 1 for a step
// with no mass, the d-2 term divided by the previous factor on the step
// after a rescale.  The schedule depends on d alone, so a kernel that stops
// at the last diagonal computes what the TPU kernels compute over their
// zero-padded steps.  Built with -fmad=false and with the plain versions'
// order of operations, so they round as the plain versions do.
//
// S, M and C: their sections below and in csrc/fb_circ.cuh.
#include "fb_circ.cuh"

namespace {

// ------------------------------------------------------------ M: mw_forward
//
// M runs the forward of the plain `_CircForward` in a layout of its own:
// one warp per lane, band row k = kk + 32 r on thread kk (RPT rows a
// thread, Wp <= 128), LPB lanes a block.  Every roll between rows is a warp shuffle and the
// rescale's band max a warp reduction, so a diagonal needs no block
// barrier; the frontier, the published mixes (the match mix of d-1 and
// d-2 and the gap mixes of d-1, those read one row down already rolled)
// and both accumulators stay in registers.  The inputs and outputs are
// [d][k][b] or [d][b], lanes fastest, so one warp's own accesses would be
// strided: the block stages the next MW_KT diagonals of its lanes (es, bm,
// bls, fr, frr, lom) into shared memory with cp.async while it computes
// the current ones, and collects each tile's band-relative posterior rows,
// flc and flr in shared memory, written out as lane-contiguous segments
// once the next tile's barrier has passed: one barrier per MW_KT
// diagonals.  Arithmetic in `_CircForward`'s order (-fmad=false), so it
// equals the plain version bit for bit.
//
// What bounds it on an H100 (kernel_ab.py's probe: variants with one part
// removed): instruction issue.  At [3072, 24, 4096], 2.85 ms against a
// 1.17 ms byte bound, ~28% of the time goes to the copies in and out, ~22%
// to the posterior and its sums, the recursion takes the rest; barriers,
// shuffles and expf take under 10% each.  Blocks of fewer than 8 lanes move
// half sectors (16 B) and run 2.7x slower; 16 lanes lead at 4096 lanes
// (two blocks, 32 warps an SM), 8 at 1024 lanes, where one warp's chain of
// dependent diagonals bounds it (1.39 ms).
constexpr int MW_KT = 8;  // diagonals a tile; d % 8 is the tile's kb

// A lane's values at one diagonal, staged as one 16-byte record.
struct __align__(16) MwLaneRec {
  float bls;
  int fr, frr, lom;
};

// One stage buffer (the inputs of a tile) or output tile, by lane w of the
// block: the records rec [LPB][MW_KT], the rows es, bm (stage) or the
// band-relative posterior rows post (output) [LPB][mw_stride(Wp)], row
// kb * Wp + k at diagonal kb of the tile, and flc, flr [LPB][MW_KT].  A
// lane's rows are contiguous, so a warp reads a diagonal's rows without
// bank conflicts; the stride is odd, so the copies, which move LPB lanes
// of one row at a time, hit LPB banks.
struct MwIn {
  MwLaneRec* rec;
  float* es;
  float* bm;
};
struct MwOut {
  float* post;
  float* flc;
  float* flr;
};

__host__ __device__ inline int mw_stride(int Wp) { return MW_KT * Wp + 1; }
__host__ __device__ inline size_t mw_in_floats(int Wp, int lpb) {
  return (size_t)lpb * (4 * MW_KT + 2 * mw_stride(Wp));
}
__host__ __device__ inline size_t mw_out_floats(int Wp, int lpb) {
  return (size_t)lpb * (mw_stride(Wp) + 2 * MW_KT);
}
// Two stage buffers and two output tiles: 8 lpb (24 Wp + 51) bytes.
inline size_t mw_smem(int Wp, int lpb) {
  return 2 * (mw_in_floats(Wp, lpb) + mw_out_floats(Wp, lpb)) *
         sizeof(float);
}

// The buffers at p (stage buffers 16-byte aligned: mw_in_floats is a
// multiple of 4).
__device__ inline MwIn mw_in(float* p, int Wp, int lpb) {
  float* es = p + 4 * MW_KT * lpb;
  return MwIn{reinterpret_cast<MwLaneRec*>(p), es, es + lpb * mw_stride(Wp)};
}
__device__ inline MwOut mw_out(float* p, int Wp, int lpb) {
  float* fl = p + lpb * mw_stride(Wp);
  return MwOut{p, fl, fl + lpb * MW_KT};
}

// Starts the copy of the tile of diagonals d0 .. d0 + MW_KT - 1 of the
// block's lanes b0 .. b0 + LPB - 1 into stage buffer S (one group): thread
// tid copies lane tid % LPB of rows tid / LPB + 32 i, so a warp moves 32 /
// LPB rows of LPB consecutive lanes a step.
template <int LPB>
__device__ __forceinline__ void mw_stage(
    const MwIn& S, int d0, int d1k, int b0, int Wp, int B,
    const float* __restrict__ es, const float* __restrict__ bm,
    const float* __restrict__ bls, const int32_t* __restrict__ fr,
    const int32_t* __restrict__ frr, const int32_t* __restrict__ lom) {
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b < B) {
    const int n = min(MW_KT, d1k - d0);
    const size_t g = (size_t)d0 * Wp * B + b;
    float* es_s = S.es + w * mw_stride(Wp);
    float* bm_s = S.bm + w * mw_stride(Wp);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32) {
      const size_t o = g + (size_t)r * B;
      mk::cp_async4(es_s + r, es + o);
      mk::cp_async4(bm_s + r, bm + o);
    }
    const int kb = threadIdx.x / LPB;
    if (kb < n) {
      const size_t o = (size_t)(d0 + kb) * B + b;
      MwLaneRec& rec = S.rec[w * MW_KT + kb];
      mk::cp_async4(&rec.bls, bls + o);
      mk::cp_async4(&rec.fr, fr + o);
      mk::cp_async4(&rec.frr, frr + o);
      mk::cp_async4(&rec.lom, lom + o);
    }
  }
  mk::cp_async_commit();
}

// Writes output tile O (diagonals d0 ..) of the block's lanes, in
// mw_stage's order.
template <int LPB>
__device__ __forceinline__ void mw_flush(const MwOut& O, int d0, int d1k,
                                         int b0, int Wp, int B,
                                         float* __restrict__ post,
                                         float* __restrict__ flc,
                                         float* __restrict__ flr) {
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b >= B) return;
  const int n = min(MW_KT, d1k - d0);
  const size_t g = (size_t)d0 * Wp * B + b;
  const float* post_s = O.post + w * mw_stride(Wp);
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
    post[g + (size_t)r * B] = post_s[r];
  const int kb = threadIdx.x / LPB;
  if (kb < n) {
    flc[(size_t)(d0 + kb) * B + b] = O.flc[w * MW_KT + kb];
    flr[(size_t)(d0 + kb) * B + b] = O.flr[w * MW_KT + kb];
  }
}

// M's lane: the forward and M's sink (the band-relative posterior row, the
// rolling column and the fixed row accumulator).
template <int RPT, int LPB>
struct MwWarp {
  WarpForward<RPT> fw;
  int Wp, kk;
  float accc[RPT], accr[RPT];  // column (rolling) and row accumulators

  __device__ MwWarp(const CircCoef& K_, int chain_, int Wp_, float lz_)
      : fw(K_, chain_, Wp_, lz_), Wp(Wp_), kk(threadIdx.x & 31) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) accc[r] = accr[r] = 0.f;
  }

  __device__ int row(int r) const { return kk + 32 * r; }

  // Diagonals d0 .. d0 + n - 1 (a tile) of lane w of the block from stage
  // buffer S into output tile O.  The posterior's scale
  // alpha = exp(ls + bls - logZ) of the tile's diagonals but the last is
  // computed up front, thread kb for diagonal kb (ls moves only at the
  // rescale of the last), and shuffled out.
  __device__ void tile(const MwIn& S, const MwOut& O, int w, int d0, int n) {
    const MwLaneRec* rec = S.rec + w * MW_KT;
    const float a = expf(fw.ls + rec[kk & 7].bls - fw.lz);
    const float* es = S.es + w * mw_stride(Wp) + kk;
    const float* bm = S.bm + w * mw_stride(Wp) + kk;
    float* post = O.post + w * mw_stride(Wp);
    for (int kb = 0; kb < n; ++kb)
      step(d0 + kb, kb, es + kb * Wp, bm + kb * Wp, rec[kb],
           __shfl_sync(mk::FULL, a, kb), post + kb * Wp,
           O.flc + w * MW_KT + kb, O.flr + w * MW_KT + kb);
  }

  // Generation d (tile row kb): es, bm at the thread's first row, rec the
  // lane's record, post_rel the lane's band-relative output row.
  __device__ void step(int d, int kb, const float* es, const float* bm,
                       const MwLaneRec rec, float alpha, float* post_rel,
                       float* flc, float* flr) {
    float post[RPT];
    if (fw.cells(d, kb, es)) alpha = expf(fw.ls + rec.bls - fw.lz);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      post[r] = row(r) < Wp ? fw.f[r][0] * bm[32 * r] * alpha : 0.f;
    sink(d, rec, post, post_rel, flc, flr);
    fw.publish();
  }

  // The band-relative row, the column and row sums of post.
  __device__ void sink(int d, const MwLaneRec rec, const float (&post)[RPT],
                       float* post_rel, float* flc, float* flr) {
    float rolled[RPT];
    roll_down<RPT>(accc, rolled, kk, Wp);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      if (k >= Wp) continue;
      const int rel = k - rec.lom < 0 ? k - rec.lom + Wp : k - rec.lom;
      post_rel[rel] = post[r];
      // The origin cell holds the start distribution and emits nothing.
      const float pm = d == 0 && k == 0 ? 0.f : post[r];
      const bool cflush = k == rec.fr;
      if (cflush) *flc = rolled[r];
      accc[r] = (cflush ? 0.f : rolled[r]) + pm;
      const bool rflush = k == rec.frr;
      if (rflush) *flr = accr[r];
      accr[r] = (rflush ? 0.f : accr[r]) + pm;
    }
    if (kk == 0) {
      if (rec.fr < 0 || rec.fr >= Wp) *flc = 0.f;
      if (rec.frr < 0 || rec.frr >= Wp) *flr = 0.f;
    }
  }

  __device__ void tails(float* __restrict__ tc, float* __restrict__ tr,
                        int b, int B) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      if (k >= Wp) continue;
      tc[(size_t)k * B + b] = accc[r];
      tr[(size_t)k * B + b] = accr[r];
    }
  }
};

template <int RPT, int LPB>
__global__ void __launch_bounds__(32 * LPB)
    mw_forward_kernel(const float* __restrict__ es,
                      const int32_t* __restrict__ fr,
                      const int32_t* __restrict__ frr,
                      const int32_t* __restrict__ lom,
                      const float* __restrict__ bm,
                      const float* __restrict__ bls,
                      const float* __restrict__ logZ, CircCoef K, int chain,
                      int d1k, int Wp, int B, float* __restrict__ post,
                      float* __restrict__ flc, float* __restrict__ flr,
                      float* __restrict__ tc, float* __restrict__ tr) {
  extern __shared__ __align__(16) float mw_raw[];
  const int nin = (int)mw_in_floats(Wp, LPB);
  const int nout = (int)mw_out_floats(Wp, LPB);
  // Stage buffer and output tile of tile t (by parity).
  auto in = [&](int t) { return mw_in(mw_raw + (t & 1) * nin, Wp, LPB); };
  auto out = [&](int t) {
    return mw_out(mw_raw + 2 * nin + (t & 1) * nout, Wp, LPB);
  };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  MwWarp<RPT, LPB> lane(K, chain, Wp, live ? logZ[b] : 0.f);
  const int tiles = (d1k + MW_KT - 1) / MW_KT;
  mw_stage<LPB>(in(0), 0, d1k, b0, Wp, B, es, bm, bls, fr, frr, lom);
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (this thread's copies, then everyone's), every
    // warp is past tile t - 1, whose outputs leave now.
    mk::cp_async_wait();
    __syncthreads();
    if (t > 0)
      mw_flush<LPB>(out(t - 1), (t - 1) * MW_KT, d1k, b0, Wp, B, post, flc,
                    flr);
    if (t + 1 < tiles)
      mw_stage<LPB>(in(t + 1), (t + 1) * MW_KT, d1k, b0, Wp, B, es, bm, bls,
                    fr, frr, lom);
    if (live)
      lane.tile(in(t), out(t), w, t * MW_KT, min(MW_KT, d1k - t * MW_KT));
  }
  __syncthreads();
  mw_flush<LPB>(out(tiles - 1), (tiles - 1) * MW_KT, d1k, b0, Wp, B, post,
                flc, flr);
  if (live) lane.tails(tc, tr, b, B);
}

// ------------------------------------------------------------ C: cx_forward
//
// C runs M's forward (WarpForward) in M's layout with a sink of its own:
// one warp per lane, band row k = kk + 32 r on thread kk (RPT rows a
// thread, Wp <= 128), LPB lanes a block (mk::warp_lanes).  The four
// accumulators by read code sit in registers, each rolled down one row per
// diagonal by a shuffle as M rolls its column accumulator; the row fr[d]
// of the position completing at d leaves into fl[c][d] before d's
// posterior adds in, the origin cell adds nothing, and after the last
// diagonal the accumulators leave as the tails.  The block stages tiles of
// CX_KT diagonals of its lanes (es, bm, bls, fr and the read codes yb)
// with cp.async one tile ahead, and collects each tile's fl in shared
// memory, written out as lane-contiguous segments once the next tile's
// barrier has passed: one barrier per tile.  No posterior band is stored.
// Arithmetic in `_CircForward`'s order (-fmad=false), so it equals the plain
// version bit for bit.
//
// What bounds it on an H100 80GB HBM3 at a 700 W power limit
// (kernel_ab.py's probe_cx group, the caller batch [128, 24, 65536]: 2.17
// ms against a 0.61 ms byte bound):
// instruction issue along each warp's chain, as M.  The sink's four
// rolls (a shuffle each) and selects a step take ~38% (1.35 ms without
// it), device memory ~16% (1.81 ms without it after the first tiles),
// the barrier ~4%; tiles of 16 diagonals ran 27% slower and plain copies
// in place of cp.async 9% slower.  At Wp 96 / 128 its 111-122 registers
// and 120-159 KB a block leave one block of 8 warps an SM.
constexpr int CX_KT = 8;  // diagonals a tile
static_assert(CX_KT % 8 == 0, "tiles hold whole rescale periods");

// A lane's values at one diagonal, staged as one 8-byte record.
struct __align__(8) CxLaneRec {
  float bls;
  int fr;
};

// A stage buffer: the records rec [LPB][CX_KT], es and bm rows
// [LPB][cx_stride(Wp)] (a lane's rows contiguous, as M's), then the read
// codes [CX_KT Wp][byte_stride(LPB)] lanes-fastest (mk::stage_bytes).  An
// output tile: fl [LPB][4 CX_KT + 1], row c * CX_KT + kb of lane w at
// w * (4 CX_KT + 1) (an odd stride).
struct CxIn {
  CxLaneRec* rec;
  float* es;
  float* bm;
  uint8_t* yb;
};

constexpr int CX_OUT_STRIDE = 4 * CX_KT + 1;
__host__ __device__ inline int cx_stride(int Wp) { return CX_KT * Wp + 1; }
__host__ __device__ inline size_t cx_in_floats(int Wp, int lpb) {
  const size_t codes = (size_t)CX_KT * Wp * mk::byte_stride(lpb) / 4;
  return ((size_t)lpb * (2 * CX_KT + 2 * cx_stride(Wp)) + codes + 3) / 4 * 4;
}
__host__ __device__ inline size_t cx_out_floats(int lpb) {
  return ((size_t)lpb * CX_OUT_STRIDE + 3) / 4 * 4;
}
// Two stage buffers and two output tiles.
inline size_t cx_smem(int Wp, int lpb) {
  return 2 * (cx_in_floats(Wp, lpb) + cx_out_floats(lpb)) * sizeof(float);
}

__device__ inline CxIn cx_in(float* p, int Wp, int lpb) {
  float* es = p + 2 * CX_KT * lpb;
  float* bm = es + lpb * cx_stride(Wp);
  return CxIn{reinterpret_cast<CxLaneRec*>(p), es, bm,
              reinterpret_cast<uint8_t*>(bm + lpb * cx_stride(Wp))};
}

// Starts the copy of the tile of diagonals d0 .. d0 + n - 1 of the block's
// lanes b0 .. b0 + LPB - 1 into stage buffer S (one group), as mw_stage
// copies; the codes as words of four lanes where `vec`.
template <int LPB>
__device__ __forceinline__ void cx_stage(
    const CxIn& S, int d0, int n, int b0, int Wp, int B, bool vec,
    const float* __restrict__ es, const float* __restrict__ bm,
    const float* __restrict__ bls, const int32_t* __restrict__ fr,
    const int8_t* __restrict__ yb) {
  const int w = threadIdx.x % LPB;
  if (b0 + w < B) {
    const size_t g = (size_t)d0 * Wp * B + b0 + w;
    float* es_s = S.es + w * cx_stride(Wp);
    float* bm_s = S.bm + w * cx_stride(Wp);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32) {
      const size_t at = g + (size_t)r * B;
      mk::cp_async4(es_s + r, es + at);
      mk::cp_async4(bm_s + r, bm + at);
    }
    const int kb = threadIdx.x / LPB;
    if (kb < n) {
      const size_t at = (size_t)(d0 + kb) * B + b0 + w;
      CxLaneRec& rec = S.rec[w * CX_KT + kb];
      mk::cp_async4(&rec.bls, bls + at);
      mk::cp_async4(&rec.fr, fr + at);
    }
  }
  mk::stage_bytes<LPB>(S.yb, yb, (size_t)d0 * Wp, n * Wp, b0, B, vec);
  mk::cp_async_commit();
}

// Writes fl of output tile O (diagonals d0 .. d0 + n - 1).
template <int LPB>
__device__ __forceinline__ void cx_flush(const float* O, int d0, int n,
                                         int d1k, int b0, int B,
                                         float* __restrict__ fl) {
  const int w = threadIdx.x % LPB;
  if (b0 + w >= B) return;
  for (int j = threadIdx.x / LPB; j < 4 * CX_KT; j += 32) {
    const int c = j / CX_KT, kb = j % CX_KT;
    if (kb < n)
      fl[((size_t)c * d1k + d0 + kb) * B + b0 + w] =
          O[w * CX_OUT_STRIDE + j];
  }
}

// C's lane: the forward and the four code accumulators, its rows
// k = kk + 32 r.
template <int RPT, int LPB>
struct CxWarp {
  WarpForward<RPT> fw;
  int Wp, kk;
  float acc[4][RPT];  // by read code, rolling

  __device__ CxWarp(const CircCoef& K_, int chain_, int Wp_, float lz_)
      : fw(K_, chain_, Wp_, lz_), Wp(Wp_), kk(threadIdx.x & 31) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[c][r] = 0.f;
  }

  __device__ int row(int r) const { return kk + 32 * r; }

  // Diagonals d0 .. d0 + n - 1 (a tile) of lane w from stage buffer S into
  // output tile O.  As M does, the posterior's scale of each rescale
  // period's diagonals but its last is computed up front, thread j for
  // the period's diagonal j, and shuffled out.
  __device__ void tile(const CxIn& S, float* O, int w, int d0, int n) {
    const CxLaneRec* rec = S.rec + w * CX_KT;
    const float* es = S.es + w * cx_stride(Wp) + kk;
    const float* bm = S.bm + w * cx_stride(Wp) + kk;
    const uint8_t* yb = S.yb + kk * mk::byte_stride(LPB) + w;
    float* fl = O + w * CX_OUT_STRIDE;
    float a = 0.f;
    for (int kb = 0; kb < n; ++kb) {
      if ((kb & 7) == 0) a = expf(fw.ls + rec[kb + (kk & 7)].bls - fw.lz);
      float alpha = __shfl_sync(mk::FULL, a, kb & 7);
      if (fw.cells(d0 + kb, kb, es + kb * Wp))
        alpha = expf(fw.ls + rec[kb].bls - fw.lz);
      float post[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        post[r] = row(r) < Wp ? fw.f[r][0] * bm[kb * Wp + 32 * r] * alpha
                              : 0.f;
      sink(d0 + kb, rec[kb].fr, post, yb + kb * Wp * mk::byte_stride(LPB),
           fl + kb);
      fw.publish();
    }
  }

  // The completing row leaves into fl[c * CX_KT] (0 where fr is outside
  // the band), then post adds into its read code's accumulator; yb points
  // at the thread's first row of the diagonal's codes.
  __device__ void sink(int d, int fr, const float (&post)[RPT],
                       const uint8_t* yb, float* fl) {
    int code[RPT];
    float pv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      code[r] = k < Wp ? (int8_t)yb[32 * r * mk::byte_stride(LPB)] : -1;
      // The origin cell holds the start distribution and emits nothing.
      pv[r] = d == 0 && k == 0 ? 0.f : post[r];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float rolled[RPT];
      roll_down<RPT>(acc[c], rolled, kk, Wp);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int k = row(r);
        if (k >= Wp) continue;
        const bool flush = k == fr;
        if (flush) fl[c * CX_KT] = rolled[r];
        acc[c][r] = (flush ? 0.f : rolled[r]) + (code[r] == c ? pv[r] : 0.f);
      }
    }
    if (kk == 0 && (fr < 0 || fr >= Wp)) {
#pragma unroll
      for (int c = 0; c < 4; ++c) fl[c * CX_KT] = 0.f;
    }
  }

  __device__ void tails(float* __restrict__ tails, int b, int B) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      if (k >= Wp) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tails[((size_t)c * Wp + k) * B + b] = acc[c][r];
    }
  }
};

template <int RPT, int LPB>
__global__ void __launch_bounds__(32 * LPB)
    cx_forward_kernel(const float* __restrict__ es,
                      const int8_t* __restrict__ yb,
                      const int32_t* __restrict__ fr,
                      const float* __restrict__ bm,
                      const float* __restrict__ bls,
                      const float* __restrict__ logZ, CircCoef K, int chain,
                      int d1k, int Wp, int B, float* __restrict__ fl,
                      float* __restrict__ tails) {
  extern __shared__ __align__(16) float cx_raw[];
  const int nin = (int)cx_in_floats(Wp, LPB);
  const int nout = (int)cx_out_floats(LPB);
  // Stage buffer and output tile of tile t (by parity).
  auto in = [&](int t) { return cx_in(cx_raw + (t & 1) * nin, Wp, LPB); };
  auto out = [&](int t) { return cx_raw + 2 * nin + (t & 1) * nout; };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const bool vec = B % 4 == 0 && (uintptr_t)yb % 4 == 0;
  CxWarp<RPT, LPB> lane(K, chain, Wp, live ? logZ[b] : 0.f);
  const int tiles = (d1k + CX_KT - 1) / CX_KT;
  auto count = [&](int t) { return min(CX_KT, d1k - t * CX_KT); };
  cx_stage<LPB>(in(0), 0, count(0), b0, Wp, B, vec, es, bm, bls, fr, yb);
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (this thread's copies, then everyone's), every
    // warp is past tile t - 1, whose fl leaves now.
    mk::cp_async_wait();
    __syncthreads();  // tile t in, tile t - 1 done
    if (t > 0)
      cx_flush<LPB>(out(t - 1), (t - 1) * CX_KT, count(t - 1), d1k, b0, B,
                    fl);
    if (t + 1 < tiles)
      cx_stage<LPB>(in(t + 1), (t + 1) * CX_KT, count(t + 1), b0, Wp, B,
                    vec, es, bm, bls, fr, yb);
    if (live) lane.tile(in(t), out(t), w, t * CX_KT, count(t));
  }
  __syncthreads();
  cx_flush<LPB>(out(tiles - 1), (tiles - 1) * CX_KT, count(tiles - 1), d1k,
                b0, B, fl);
  if (live) lane.tails(tails, b, B);
}

// ----------------------------------------------------------- S: sv_backward
//
// S: the walk of csrc/fb_circ.cuh (`sv_walk`, `SvWarp`) over the signed
// stream es.  At most 64 registers a thread, so that two blocks of 16
// lanes (four of 8) fit an SM's registers.
template <int RPT, int LPB>
__global__ void __launch_bounds__(32 * LPB, 32 / LPB)
    sv_backward_kernel(const float* __restrict__ es,
                       const int32_t* __restrict__ fink,
                       const int32_t* __restrict__ find, CircCoef K,
                       int chain, int d1k, int Wp, int B,
                       float* __restrict__ bm, float* __restrict__ bls,
                       float* __restrict__ logZ) {
  extern __shared__ __align__(16) float sv_raw[];
  sv_walk<RPT, LPB, SRC_ES>(sv_raw, es, SrcBytes{}, nullptr, fink, find, K,
                            chain, d1k, Wp, B, false, bm, bls, logZ,
                            nullptr);
}

// ---------------------------------------------------------------- launches

// The lanes a block M takes for B lanes at band width Wp on the current
// device: 16 where that block fits shared memory and every SM still gets
// a block (B >= 16 x SMs), else 8.  Fewer than 8 lanes move half sectors
// and more than 16 ran slower (kernel_ab.py's probe group, PERF.md).
cudaError_t mw_lanes(int Wp, int B, int* lanes) {
  int dev = 0, sms = 0, smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const bool wide = mw_smem(Wp, 16) <= (size_t)smem && B >= 16 * sms;
  if (!wide && mw_smem(Wp, 8) > (size_t)smem) return cudaErrorInvalidValue;
  *lanes = wide ? 16 : 8;
  return cudaSuccess;
}

template <int LPB>
const void* mw_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)mw_forward_kernel<1, LPB>;
    case 2: return (const void*)mw_forward_kernel<2, LPB>;
    case 3: return (const void*)mw_forward_kernel<3, LPB>;
    case 4: return (const void*)mw_forward_kernel<4, LPB>;
  }
  return nullptr;
}

// M's kernel for band width Wp and `lanes` lanes a block.
const void* mw_kernel(int Wp, int lanes) {
  switch (lanes) {
    case 8: return mw_kernel_rpt<8>(Wp);
    case 16: return mw_kernel_rpt<16>(Wp);
  }
  return nullptr;
}

// The kernel, lanes a block and shared memory of M's launch at (Wp, B),
// its shared memory opted in.
cudaError_t mw_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  cudaError_t err = mw_lanes(Wp, B, lanes);
  if (err != cudaSuccess) return err;
  *kernel = mw_kernel(Wp, *lanes);
  *smem = mw_smem(Wp, *lanes);
  return *kernel ? mk::allow_smem(*kernel, *smem) : cudaErrorInvalidValue;
}

template <int LPB>
const void* cx_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)cx_forward_kernel<1, LPB>;
    case 2: return (const void*)cx_forward_kernel<2, LPB>;
    case 3: return (const void*)cx_forward_kernel<3, LPB>;
    case 4: return (const void*)cx_forward_kernel<4, LPB>;
  }
  return nullptr;
}

// The kernel, lanes a block (mk::warp_lanes) and shared memory of C's
// launch at (Wp, B), its shared memory opted in.
cudaError_t cx_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  cudaError_t err =
      mk::warp_lanes(B, [Wp](int l) { return cx_smem(Wp, l); }, lanes);
  if (err != cudaSuccess) return err;
  switch (*lanes) {
    case 8: *kernel = cx_kernel_rpt<8>(Wp); break;
    case 16: *kernel = cx_kernel_rpt<16>(Wp); break;
    default: return cudaErrorInvalidValue;
  }
  *smem = cx_smem(Wp, *lanes);
  return *kernel ? mk::allow_smem(*kernel, *smem) : cudaErrorInvalidValue;
}

template <int LPB>
const void* sv_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)sv_backward_kernel<1, LPB>;
    case 2: return (const void*)sv_backward_kernel<2, LPB>;
    case 3: return (const void*)sv_backward_kernel<3, LPB>;
    case 4: return (const void*)sv_backward_kernel<4, LPB>;
  }
  return nullptr;
}

// The kernel, lanes a block (mk::warp_lanes) and shared memory of S's
// launch at (Wp, B), its shared memory opted in.
cudaError_t sv_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  cudaError_t err =
      mk::warp_lanes(B, [Wp](int l) { return sv_smem(Wp, l); }, lanes);
  if (err != cudaSuccess) return err;
  switch (*lanes) {
    case 8: *kernel = sv_kernel_rpt<8>(Wp); break;
    case 16: *kernel = sv_kernel_rpt<16>(Wp); break;
    default: return cudaErrorInvalidValue;
  }
  *smem = sv_smem(Wp, *lanes);
  return *kernel ? mk::allow_smem(*kernel, *smem) : cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 58 floats of `CircCoef`, `table` a HOST pointer to the 25 match
// emissions Ematch[ref][read]; device pointers for everything else.  Each
// returns a cudaError_t code.
extern "C" int sv_backward_launch(const float* es, const int32_t* fink,
                                  const int32_t* find, const float* coef,
                                  int chain, int d1k, int Wp, int B,
                                  float* bm, float* bls, float* logZ,
                                  void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = sv_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  CircCoef K = load_coef(coef);
  void* args[] = {&es, &fink, &find, &K,  &chain, &d1k,
                  &Wp, &B,    &bm,   &bls, &logZ};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What S's launch at band width Wp over B lanes gets on this device
// (mk::kernel_info's out[5]; its lanes a block are out[3] / 32).
extern "C" int sv_backward_info(int Wp, int B, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = sv_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

extern "C" int cx_forward_launch(const float* es, const int8_t* yb,
                                 const int32_t* fr, const float* bm,
                                 const float* bls, const float* logZ,
                                 const float* coef, int chain, int d1k,
                                 int Wp, int B, float* fl, float* tails,
                                 void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = cx_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  CircCoef K = load_coef(coef);
  void* args[] = {&es, &yb, &fr,  &bm, &bls, &logZ, &K,    &chain,
                  &d1k, &Wp, &B, &fl, &tails};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What C's launch at band width Wp over B lanes gets on this device
// (mk::kernel_info's out[5]; its lanes a block are out[3] / 32).
extern "C" int cx_forward_info(int Wp, int B, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = cx_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

extern "C" int mw_forward_launch(const float* es, const int32_t* fr,
                                 const int32_t* frr, const int32_t* lom,
                                 const float* bm, const float* bls,
                                 const float* logZ, const float* coef,
                                 int chain, int d1k, int Wp, int B,
                                 float* post, float* flc, float* flr,
                                 float* tc, float* tr, void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = mw_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  CircCoef K = load_coef(coef);
  void* args[] = {&es,  &fr,    &frr, &lom, &bm, &bls,  &logZ, &K,  &chain,
                  &d1k, &Wp,    &B,   &post, &flc, &flr, &tc,  &tr};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What M's launch at band width Wp over B lanes gets on this device
// (mk::kernel_info's out[5]; its lanes a block are out[3] / 32).
extern "C" int mw_forward_info(int Wp, int B, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = mw_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}
