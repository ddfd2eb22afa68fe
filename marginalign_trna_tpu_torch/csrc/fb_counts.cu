// Baum-Welch expected counts (the EM E-step) over banded 5-state pair-HMM
// batches, for models given as run-time tables with generic (not
// necessarily flat) gap emissions, one model per EM trial.
//
// Replaces the TPU kernels of marginalign_trna_tpu/ops/fb_pallas_counts.py
// (single-problem lanes; a serial trial is Ntr = 1):
//   counts_fwd_all   <- `_fwd_all_impl` (`_counts_pallas_jit` :360 and
//                       `_counts_pallas_trials_jit` :924): the scaled forward
//                       storing all five states of every diagonal (f_all),
//                       the cumulative log-scale lsf and the terminal sum;
//   counts_bwd       <- `_bwd_counts_impl` (:397, :974): the scaled backward
//                       writing the posterior match band and accumulating per
//                       lane the 25 transition and 20 gap-by-code partials;
//   counts_fwd_ckpt  <- `_fwd_ckpt_impl` (`_counts_ckpt_jit` :1659,
//                       `_counts_ckpt_trials_jit` :1796): the same forward,
//                       storing only each 8-diagonal block's last two
//                       frontiers and scale state;
//   counts_bwd_ckpt  <- `_bwd_counts_ckpt_impl` (:1704, :1844): per block,
//                       the forward recomputed from the previous block's
//                       checkpoint into shared memory, then the backward of
//                       counts_bwd with 25 match partials and no posterior.
//
// The same four over multi-problem lanes (template flag MULTI: several
// problems per lane, SPACER empty diagonals apart, a serial trial Ntr = 1):
//   counts_multi_fwd_all   <- `_fwd_all_multi_impl` (pallas_calls
//                             `_counts_pallas_multi_jit` :763 and
//                             `_counts_pallas_multi_trials_jit` :1091): the
//                             start distribution enters at row 0 of each
//                             problem's first diagonal, the terminal sum
//                             reads the per-diagonal terminal row;
//   counts_multi_bwd       <- `_bwd_counts_multi_impl` (:806, :1148): the
//                             backward injects at every terminal cell and
//                             restarts its log-scale there, normalises by the
//                             owning problem's L, and counts no emission at a
//                             problem's first diagonal;
//   counts_multi_fwd_ckpt  <- `_fwd_ckpt_multi_impl` (`_counts_ckpt_multi_jit`
//                             :2257, `_counts_ckpt_multi_trials_jit` :2390);
//   counts_multi_bwd_ckpt  <- `_bwd_counts_ckpt_multi_impl` (:2308, :2449):
//                             block 0 recomputes from the zero frontier, and
//                             every block re-seeds the starts inside it.
//
// and the generic forward-backward of marginalign_trna_tpu/ops/fb_pallas.py
// for models whose gap emissions are not flat (one model):
//   fb_generic_fwd   <- `_fwd_body` (`_run_forward` :480, pallas_calls :519
//                       dynamic tables and :526 baked tables): the same
//                       forward, storing only the scaled match plane F_match,
//                       lsf and the terminal sums;
//   fb_generic_bwd   <- `_bwd_body` (`_run_backward` :693, pallas_calls :747
//                       and :753): the same backward, writing the posterior
//                       match band F_match * b_M * exp(lsf + bls - logZ) and
//                       counting nothing.
// Run-time tables cover both TPU variants: the baked variant only skips
// terms that are statically zero and folds a flat gap row into a scalar,
// which rounds exactly like the lookup and the sum in the same order.
//
// Every kernel takes the warp per lane layout: one warp per lane (and
// trial, blockIdx.y), band row k on thread k (Wp <= 32), the row shifts as
// warp shuffles, tiles of 8 diagonals staged with cp.async, so no kernel
// takes a block barrier per diagonal.  Four kernels serve the ten entry
// points:
//   counts_fwd_ckpt_kernel<MULTI, LPB, OUT>: the forward; its output mode
//     OUT picks the checkpoints (counts_fwd_ckpt), F_match (fb_generic_fwd)
//     or f_all (counts_fwd_all), each gathered in a per-warp record and
//     written out as lane-contiguous rows once a tile;
//   counts_bwd_ckpt_kernel<MULTI>: the checkpoint backward, 4 lanes a
//     block, the recompute and the counts in shared memory;
//   generic_bwd_kernel<LPB>: the generic backward, F_match tiles in a
//     3-buffer ring, each posterior written over its F_match value;
//   counts_stored_bwd_kernel<MULTI, LPB>: the stored backward, f_all tiles
//     in a 2-buffer ring, each posterior written over its f_M value, the
//     transition partials in registers and the gap counts in per-thread
//     bins.
// LPB, the lanes a block (8 or 16), is mk::warp_lanes'.  The recursions
// are one source (mix_to, fwd_recur, bwd_recur; warp_fwd_cell,
// warp_rescale, warp_mixes for the forwards and the checkpoint backward's
// recompute; warp_bwd_q for the backwards).
//
// Arithmetic: the plain versions' (ops/fb_counts_cuda.py) operation for
// operation, built without multiply-add contraction (-fmad=false), so
// f_all, lsf, the terminal sums, the checkpoints, F_match and the
// posterior band round identically.  The count partials are summed per
// thread over the diagonals and over the rows once at the end, with fused
// multiply-adds for the transition partials; that order differs from the
// plain versions' (rows first, then diagonals), so the counts agree to
// float32 summation error.
//
// What bounds them on an H100: counts_fwd_all writes 20 B per cell and
// counts_bwd reads 20 B and writes 4 B, so a full card would be memory
// bound; counts_fwd_ckpt writes ~5 B per cell and trial; counts_bwd_ckpt
// does a forward again, the backward and the counts (~225 operations per
// cell) and is operation bound.  The generic pair moves 7 B per cell forward
// (codes in, F_match out) and 11 B backward (F_match and codes in,
// posterior out).  The warp-per-lane kernels issue ~110-140 instructions a
// warp and diagonal (the stored backward more, with its counts), so where
// lanes are many they are bound by instruction issue and where they are
// few by each warp's serial chain of diagonals: on an H100 80GB HBM3 at
// 700 W (kernel_ab.py's counts group) the generic pair takes 0.97 / 1.25
// ms at [3072, 24, 1024] (one block of 8 warps an SM, ~550 cycles a
// diagonal), 5.7x / 4.9x its byte bounds, and 0.96 / 1.23 ms at
// [128, 24, 32768], 4.3x / 3.6x; the stored pair 3.78 / 5.80 ms at the EM
// batch [3, 512, 24, 8192] (one block of 16 warps an SM), 2.0x / 2.5x its
// byte bounds, the forward's flush of f_all a quarter of its time.  counts_bwd_ckpt_kernel keeps each
// diagonal inside a warp (no barrier), bins the emission counts by code,
// and sizes a block at 128 threads: ptxas gives it 127 registers (128 with
// MULTI), no spills and no stack, with 45,472 B of shared memory a block
// at Wp 24 (four blocks, 16 warps, per SM; three at Wp 32).  There the
// recomputed forward takes ~40% of its time and 8 of a warp's 32 rows
// idle.
#include "common.cuh"

namespace {

constexpr int NS = 5;
constexpr int K = 8;             // diagonals per rescale period / tile
constexpr int MAX_WP = 32;       // band rows: one a thread of a warp

// The recursions, one source for every kernel of this file: the mix
// sum_s f[s] * T[s][t] of a forward frontier, a forward cell from its
// emissions e and shifted mixes m, and a backward cell from the shifted
// e * b values q (tab: T, in registers).
template <typename Tab>
__device__ __forceinline__ float mix_to(const float (&f)[5], const Tab& tab,
                                        int t) {
  float acc = f[0] * tab[t];
#pragma unroll
  for (int s = 1; s < NS; ++s) acc = acc + f[s] * tab[s * 5 + t];
  return acc;
}

__device__ __forceinline__ void fwd_recur(const float (&e)[5],
                                          const float (&m)[5], float v,
                                          float (&f)[5]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) f[s] = (e[s] * m[s]) * v;
}

template <typename Tab>
__device__ __forceinline__ void bwd_recur(const float (&q)[5], const Tab& tab,
                                          float inj, float v,
                                          float (&nb)[5]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float acc = q[0] * tab[s * 5];
#pragma unroll
    for (int u = 1; u < NS; ++u) acc = acc + q[u] * tab[s * 5 + u];
    nb[s] = (acc + inj) * v;
  }
}

__device__ __forceinline__ float sum5(const float (&v)[5]) {
  return (((v[0] + v[1]) + v[2]) + v[3]) + v[4];
}

// ---------------------------------------------------------------------------
// The checkpoint backward (counts_bwd_ckpt, counts_multi_bwd_ckpt).  One
// warp per lane, one band row per thread (Wp <= 32), CK_WARPS lanes per
// block: the recursions cross rows with warp shuffles, so a diagonal needs
// no block barrier, and each thread keeps its row's delay lines (the
// forward's mixes of d-1 and d-2, the backward's e * b of d+1 and d+2) and
// the 25 transition partials in registers.  Loads of [d, k, b] coalesce
// only across lanes, so the block stages the codes of its lanes, the
// per-diagonal streams and the checkpoint of the next 8-diagonal block
// through shared memory with cp.async while it computes the current one,
// then unpacks them (codes packed with the valid bit and the count bins):
// two barriers per 8 diagonals.  The recomputed frontiers sit in shared
// memory, one row per thread; the gap and match emission counts go to bins
// owned per thread and indexed by code (no one-hot selects), the
// transition partials accumulate with fused multiply-adds.
constexpr int CK_WARPS = 4;            // lanes per block: 4 consecutive
constexpr int CK_THREADS = 32 * CK_WARPS;
constexpr int N_EGB = 24;              // gap bins: code * 4 + state - 1
constexpr int N_MCB = 26;              // match bins: x * 5 + y, 25 = none
constexpr int N_LANE = 5;              // per-lane streams: s1, start, fink,
                                       // find, L
constexpr uint32_t CK_NO_CELL = 5u | (5u << 8) | (25u << 24);
using mk::FULL;

// Shared memory of one block, sized by Wp.  The stage holds the next
// 8-diagonal block as it arrives (cp.async): the code streams as words of
// the block's 4 lanes, the per-lane streams and the checkpoint.  It is
// unpacked into `cell` (x | y << 8 | valid << 16 | match bin << 24) and
// the per-lane arrays before the block is computed, while the stage
// fills with the block after it.
struct CkptSmem {
  float* tab;         // T (25), em6[x * 6 + y], eg6[(s - 1) * 6 + c]
  int* lane;          // [N_LANE][K][CK_WARPS] of the block being computed
  uint32_t* cell;     // [K][CK_WARPS][Wp]
  uint32_t* st_code;  // [3][K][Wp] stage: xb, yb, valid words
  int* st_lane;       // [N_LANE][K][CK_WARPS] stage
  float* st_ck;       // [2 * NS][Wp][CK_WARPS] stage: checkpoint
  float* st_cs;       // [4][CK_WARPS] stage: ls, cprev, s1 (and 0)
  float* fs;          // [K][NS][CK_WARPS][Wp] recomputed frontiers
  float* egb;         // [N_EGB][CK_WARPS][Wp]
  float* mcb;         // [N_MCB][CK_WARPS][Wp]
};

__host__ __device__ inline size_t ckpt_smem_floats(int Wp) {
  return 88 + 2 * N_LANE * K * CK_WARPS + K * CK_WARPS * Wp + 3 * K * Wp +
         2 * NS * Wp * CK_WARPS + 4 * CK_WARPS +
         (size_t)(K * NS + N_EGB + N_MCB) * CK_WARPS * Wp;
}

__device__ inline CkptSmem ckpt_smem(float* base, int Wp) {
  CkptSmem m;
  m.tab = base;
  m.lane = reinterpret_cast<int*>(base + 88);
  m.st_lane = m.lane + N_LANE * K * CK_WARPS;
  m.st_cs = reinterpret_cast<float*>(m.st_lane + N_LANE * K * CK_WARPS);
  m.st_ck = m.st_cs + 4 * CK_WARPS;
  m.cell = reinterpret_cast<uint32_t*>(m.st_ck + 2 * NS * Wp * CK_WARPS);
  m.st_code = m.cell + K * CK_WARPS * Wp;
  m.fs = reinterpret_cast<float*>(m.st_code + 3 * K * Wp);
  m.egb = m.fs + K * NS * CK_WARPS * Wp;
  m.mcb = m.egb + N_EGB * CK_WARPS * Wp;
  return m;
}

using mk::cp_async16;
using mk::cp_async4;
using mk::cp_async_commit;
using mk::cp_async_wait;

// Starts the copy of 8-diagonal block blk of the block's lanes b0..b0+3
// into the stage: asynchronous when a block's 4 lanes are 4 aligned words
// of every stream (vec: B % 4 == 0), else plain loads and stores.
template <bool MULTI>
__device__ __forceinline__ void stage_block(
    const CkptSmem& S, bool vec, int blk, int b0, int t, int tid, int Wp,
    int B, int d1k, int G, const int8_t* __restrict__ xb,
    const int8_t* __restrict__ yb, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ s1, const int8_t* __restrict__ start,
    const int32_t* __restrict__ fink, const int32_t* __restrict__ find,
    const float* __restrict__ logZ, const float* __restrict__ ckpt,
    const float* __restrict__ cs) {
  const int ck = t * G + blk - 1;  // the previous block's checkpoint
  if (vec) {
    for (int i = tid; i < 3 * K * Wp; i += CK_THREADS) {
      const int q = i / (K * Wp), r = i % (K * Wp);  // r = kb * Wp + k
      const int8_t* src = q == 0 ? xb
                          : q == 1 ? yb
                                   : reinterpret_cast<const int8_t*>(valid);
      cp_async4(S.st_code + i,
                src + ((size_t)blk * K * Wp + r) * B + b0);
    }
    for (int i = tid; i < N_LANE * K; i += CK_THREADS) {
      const int q = i / K, kb = i % K;
      const size_t at = (size_t)(blk * K + kb) * B + b0;
      int* dst = S.st_lane + (q * K + kb) * CK_WARPS;
      if (q == 0) cp_async16(dst, s1 + at);
      if (MULTI && q == 1) cp_async4(dst, start + at);
      if (MULTI && q == 2) cp_async16(dst, fink + at);
      if (MULTI && q == 3) cp_async16(dst, find + at);
      if (MULTI && q == 4)
        cp_async16(dst, logZ + (size_t)t * d1k * B + at);
    }
    if (blk > 0) {
      for (int i = tid; i < 2 * NS * Wp; i += CK_THREADS)
        cp_async16(S.st_ck + i * CK_WARPS,
                   ckpt + ((size_t)ck * 2 * NS * Wp + i) * B + b0);
      if (tid < 4) cp_async16(S.st_cs + tid * CK_WARPS,
                              cs + ((size_t)ck * 4 + tid) * B + b0);
    }
    cp_async_commit();
    return;
  }
  uint8_t* code = reinterpret_cast<uint8_t*>(S.st_code);
  for (int i = tid; i < 3 * K * Wp * CK_WARPS; i += CK_THREADS) {
    const int w = i % CK_WARPS, j = i / CK_WARPS;
    const int q = j / (K * Wp), r = j % (K * Wp);
    const int8_t* src = q == 0 ? xb
                        : q == 1 ? yb
                                 : reinterpret_cast<const int8_t*>(valid);
    code[i] = b0 + w < B ? src[((size_t)blk * K * Wp + r) * B + b0 + w] : 0;
  }
  for (int i = tid; i < N_LANE * K * CK_WARPS; i += CK_THREADS) {
    const int w = i % CK_WARPS, kb = (i / CK_WARPS) % K;
    const int q = i / (K * CK_WARPS);
    const bool in = b0 + w < B;
    const size_t at = (size_t)(blk * K + kb) * B + b0 + w;
    int val = 0;
    if (q == 0) val = in ? s1[at] : 0;
    if (MULTI && q == 1) {  // the int8 start flags, packed as in a word
      reinterpret_cast<int8_t*>(S.st_lane + (K + kb) * CK_WARPS)[w] =
          in ? start[at] : 0;
      continue;
    }
    if (MULTI && q == 2) val = in ? fink[at] : -1;
    if (MULTI && q == 3) val = in ? find[at] : -1;
    if (MULTI && q == 4) {
      reinterpret_cast<float*>(S.st_lane)[i] =
          in ? logZ[(size_t)t * d1k * B + at] : 0.f;
      continue;
    }
    S.st_lane[i] = val;
  }
  if (blk > 0) {
    for (int i = tid; i < 2 * NS * Wp * CK_WARPS; i += CK_THREADS) {
      const int w = i % CK_WARPS;
      S.st_ck[i] = b0 + w < B
                       ? ckpt[((size_t)ck * 2 * NS * Wp + i / CK_WARPS) * B +
                              b0 + w]
                       : 0.f;
    }
    if (tid < 4 * CK_WARPS)
      S.st_cs[tid] = b0 + tid % CK_WARPS < B
                         ? cs[((size_t)ck * 4 + tid / CK_WARPS) * B + b0 +
                              tid % CK_WARPS]
                         : 0.f;
  }
}

// Per-lane maximum of a row's five states over the warp's band rows.
__device__ __forceinline__ float warp_band_max(const float (&v)[5], bool row) {
  float m = row ? fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])), v[4])
                : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// The forward recursion of one lane in the warp-per-lane layout (band row
// k on thread k): the checkpoint forward and the checkpoint backward's
// recompute both run it, in fwd_recur's order.  A frontier publishes its
// mixes (warp_mixes: the match mix of d-1 and d-2, mM1 and mM2, and the
// gap mixes of d-1, mG); a cell reads them from rows k + t2 - 1 (match),
// k + t1 (gap states 1, 3) and k + t1 - 1 (2, 4) by shuffles.

// One forward diagonal: f becomes the unscaled frontier of the cell
// (emissions e, validity v); the match mix is divided by cprev on the
// diagonal after a rescale (`divide`); MULTI adds the start distribution
// at row 0 where a problem starts (`seed`).
template <bool MULTI>
__device__ __forceinline__ void warp_fwd_cell(float (&f)[5],
                                              const float (&e)[5], float v,
                                              float mM2, const float (&mG)[4],
                                              int k, int t1, int t2, int Wp,
                                              bool divide, float cprev,
                                              bool seed) {
  const int ra = mk::wrap(k + t2 - 1, Wp);
  const int rb = mk::wrap(k + t1, Wp), rc = mk::wrap(k + t1 - 1, Wp);
  float m[5];
  m[0] = __shfl_sync(FULL, mM2, ra);
  if (divide) m[0] = m[0] / cprev;
  m[1] = __shfl_sync(FULL, mG[0], rb);
  m[2] = __shfl_sync(FULL, mG[1], rc);
  m[3] = __shfl_sync(FULL, mG[2], rb);
  m[4] = __shfl_sync(FULL, mG[3], rc);
  fwd_recur(e, m, v, f);
  if constexpr (MULTI) {
    const float inj = (seed && k == 0) ? 0.2f : 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) f[s] = f[s] + inj;
  }
}

// The rescale of a frontier by its band max over the warp's band rows
// (`row`: this thread's row is in the band); returns the factor c, the
// frontier is multiplied by 1 / c.
__device__ __forceinline__ float warp_rescale(float (&f)[5], bool row) {
  const float mx = warp_band_max(f, row);
  const float c = mx > 0.f ? mx : 1.f;
  const float inv = 1.f / c;
#pragma unroll
  for (int s = 0; s < NS; ++s) f[s] *= inv;
  return c;
}

// The mixes frontier f publishes for the next two diagonals.
__device__ __forceinline__ void warp_mixes(const float (&f)[5],
                                           const float (&Tr)[25], float& mM1,
                                           float& mM2, float (&mG)[4]) {
  mM2 = mM1;
  mM1 = mix_to(f, Tr, 0);
#pragma unroll
  for (int u = 0; u < 4; ++u) mG[u] = mix_to(f, Tr, u + 1);
}

// The backward recursion's inputs q of band row k (thread k), by
// shuffles: e_M * b_M of d+2 (p2) from row k + 1 - s2n, divided by cprev
// on the diagonal before a rescale (`divide`), and e_s * b_s of d+1 (g1)
// from rows k - s1n (states 1, 3) and k + 1 - s1n (2, 4).  Every backward
// of this file takes them so, in bwd_recur's order.
__device__ __forceinline__ void warp_bwd_q(float p2, const float (&g1)[4],
                                           int k, int s1n, int s2n, int Wp,
                                           bool divide, float cprev,
                                           float (&q)[5]) {
  const int ra = mk::wrap(k + 1 - s2n, Wp);
  const int rb = mk::wrap(k - s1n, Wp), rc = mk::wrap(k + 1 - s1n, Wp);
  q[0] = __shfl_sync(FULL, p2, ra);
  if (divide) q[0] = q[0] / cprev;
  q[1] = __shfl_sync(FULL, g1[0], rb);
  q[2] = __shfl_sync(FULL, g1[1], rc);
  q[3] = __shfl_sync(FULL, g1[2], rb);
  q[4] = __shfl_sync(FULL, g1[3], rc);
}

template <bool MULTI>
__global__ void __launch_bounds__(CK_THREADS)
    counts_bwd_ckpt_kernel(const float* __restrict__ T,
                           const float* __restrict__ Em,
                           const float* __restrict__ Eg,
                           const float* __restrict__ ckpt,
                           const float* __restrict__ cs,
                           const int8_t* __restrict__ xb,
                           const int8_t* __restrict__ yb,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ s1,
                           const int8_t* __restrict__ start,
                           const int32_t* __restrict__ fink,
                           const int32_t* __restrict__ find,
                           const float* __restrict__ logZ, int d1k, int Wp,
                           int B, float* __restrict__ tcp,
                           float* __restrict__ egp, float* __restrict__ mcp) {
  extern __shared__ __align__(16) float ck_raw[];
  const CkptSmem S = ckpt_smem(ck_raw, Wp);
  const int tid = threadIdx.x;
  const int k = tid & 31;            // band row
  const int w = tid >> 5;            // the warp's lane in the block
  const int b0 = blockIdx.x * CK_WARPS;
  const int b = b0 + w;
  const int t = blockIdx.y;
  const bool live = b < B;           // warp-uniform
  const bool row = k < Wp;
  const int G = d1k / K;
  // The stage copies a block's 4 lanes as one word of each byte stream and
  // 16 bytes of each word stream.
  static_assert(CK_WARPS == 4, "the stage packs 4 lanes per word");
  uintptr_t a4 = (uintptr_t)xb | (uintptr_t)yb | (uintptr_t)valid;
  uintptr_t a16 = (uintptr_t)s1 | (uintptr_t)ckpt | (uintptr_t)cs;
  if (MULTI) {
    a4 |= (uintptr_t)start;
    a16 |= (uintptr_t)fink | (uintptr_t)find | (uintptr_t)logZ;
  }
  const bool vec = B % CK_WARPS == 0 && a4 % 4 == 0 && a16 % 16 == 0;
  const float* em6 = S.tab + 25;
  const float* eg6 = S.tab + 61;
  // Band row k of the warp's lane in a [..][CK_WARPS][Wp] array.
  const int own = w * Wp + k;
  const int plane = CK_WARPS * Wp;
  for (int i = tid; i < 85; i += CK_THREADS) {
    float val;
    if (i < 25) {
      val = T[t * 25 + i];
    } else if (i < 61) {
      const int x = (i - 25) / 6, y = (i - 25) % 6;
      val = x < 5 && y < 5 ? Em[t * 25 + x * 5 + y] : 0.f;
    } else {
      const int s = (i - 61) / 6 + 1, c = (i - 61) % 6;
      val = c < 5 ? Eg[t * 25 + s * 5 + c] : 0.f;
    }
    S.tab[i] = val;
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < N_EGB; ++j) S.egb[j * plane + own] = 0.f;
#pragma unroll
    for (int j = 0; j < N_MCB; ++j) S.mcb[j * plane + own] = 0.f;
  }
  __syncthreads();
  float Tr[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) Tr[i] = S.tab[i];
  const int fk = live && !MULTI ? fink[b] : -1;
  const int fd = live && !MULTI ? find[b] : -1;
  const float lz0 = live && !MULTI ? logZ[(size_t)t * B + b] : 0.f;
  float bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;                   // s1 at d+1 and d+2
  float p1 = 0.f, p2 = 0.f;               // e_M * b_M of d+1, d+2
  float g1[4] = {0.f, 0.f, 0.f, 0.f};     // e_s * b_s of d+1
  float tca[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) tca[j] = 0.f;
  const int* s1b = S.lane;                // [K][CK_WARPS] per stream
  const int* startb = S.lane + K * CK_WARPS;
  const int* finkb = S.lane + 2 * K * CK_WARPS;
  const int* findb = S.lane + 3 * K * CK_WARPS;
  const float* lzb = reinterpret_cast<const float*>(S.lane) + 4 * K * CK_WARPS;

  // Iteration blk unpacks the stage (block blk), starts the copy of block
  // blk - 1 into it and computes block blk; iteration G only starts the
  // first copy.
  for (int blk = G; blk >= 0; --blk) {
    float f[5], fp[5];
    float lsF = 0.f, cprevF = 1.f;
    int sprev = 0;
    if (blk < G) {
      // The stage holds block blk once this thread's copies land and every
      // warp is past the last block's compute.
      cp_async_wait();
      __syncthreads();
      const uint8_t* code = reinterpret_cast<const uint8_t*>(S.st_code);
      for (int i = tid; i < K * Wp * CK_WARPS; i += CK_THREADS) {
        const int ww = i % CK_WARPS, r = i / CK_WARPS;  // r = kb * Wp + kk
        const int x = (int8_t)code[i];
        const int y = (int8_t)code[K * Wp * CK_WARPS + i];
        const uint32_t v = code[2 * K * Wp * CK_WARPS + i];
        const uint32_t xi = x >= 0 && x < 5 ? x : 5;
        const uint32_t yi = y >= 0 && y < 5 ? y : 5;
        const uint32_t mb = xi < 5 && yi < 5 ? xi * 5 + yi : 25;
        S.cell[((r / Wp) * CK_WARPS + ww) * Wp + r % Wp] =
            b0 + ww < B ? xi | (yi << 8) | (v << 16) | (mb << 24)
                        : CK_NO_CELL;
      }
      for (int i = tid; i < N_LANE * K * CK_WARPS; i += CK_THREADS) {
        if (MULTI && i / (K * CK_WARPS) == 1)
          S.lane[i] = reinterpret_cast<const int8_t*>(
              S.st_lane + (i / CK_WARPS) * CK_WARPS)[i % CK_WARPS];
        else
          S.lane[i] = S.st_lane[i];
      }
      // The previous block's checkpoint (blocks > 0).
      const bool have = live && blk > 0;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const bool ok = have && row;
        f[s] = ok ? S.st_ck[(s * Wp + k) * CK_WARPS + w] : 0.f;
        fp[s] = ok ? S.st_ck[((NS + s) * Wp + k) * CK_WARPS + w] : 0.f;
      }
      if (have) {
        lsF = S.st_cs[w];
        cprevF = S.st_cs[CK_WARPS + w];
        sprev = (int)S.st_cs[2 * CK_WARPS + w];
      }
      __syncthreads();
    }
    if (blk > 0)
      stage_block<MULTI>(S, vec, blk - 1, b0, t, tid, Wp, B, d1k, G, xb, yb,
                         valid, s1, start, fink, find, logZ, ckpt, cs);
    if (blk == G || !live) continue;

    // Recompute the block's forward: block 0 of single-problem lanes from
    // the start distribution at d = 0, MULTI's block 0 from the zero
    // frontier (its problems' starts seeded as the forward did), the
    // others from the previous block's checkpoint.
    float mM1, mM2, mG[4];
    int kb0 = 0;
    if (blk == 0 && !MULTI) {
#pragma unroll
      for (int s = 0; s < NS; ++s) f[s] = k == 0 ? 0.2f : 0.f;
      sprev = s1b[w];
      mM2 = 0.f;  // d = 1 has no d-2 term
      if (row) {
#pragma unroll
        for (int s = 0; s < NS; ++s) S.fs[s * plane + own] = f[s];
      }
      kb0 = 1;
    } else {
      mM2 = mix_to(fp, Tr, 0);
    }
    mM1 = mix_to(f, Tr, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) mG[u] = mix_to(f, Tr, u + 1);
    const float lsA = lsF;  // the log-scale of diagonals kb < K - 1
    for (int kb = kb0; kb < K; ++kb) {
      const int t1 = s1b[kb * CK_WARPS + w];
      const int t2 = t1 + sprev;
      sprev = t1;
      const uint32_t word = row ? S.cell[kb * plane + own] : CK_NO_CELL;
      const int xi = word & 0xff, yi = (word >> 8) & 0xff;
      const float v = (float)((word >> 16) & 0xff);
      const float e[5] = {em6[xi * 6 + yi], eg6[xi], eg6[6 + yi],
                          eg6[12 + xi], eg6[18 + yi]};
      warp_fwd_cell<MULTI>(f, e, v, mM2, mG, k, t1, t2, Wp, kb == 0, cprevF,
                           MULTI && startb[kb * CK_WARPS + w] != 0);
      if (kb == K - 1) {
        const float c = warp_rescale(f, row);
        lsF += logf(c);
        cprevF = c;
      }
      if (row) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          S.fs[(kb * NS + s) * plane + own] = f[s];
      }
      warp_mixes(f, Tr, mM1, mM2, mG);
    }

    // The backward over the block, with the counts.
    for (int kb = K - 1; kb >= 0; --kb) {
      const int d = blk * K + kb;
      const int s1n = sh1, s2n = sh1 + sh2;
      const uint32_t word = row ? S.cell[kb * plane + own] : CK_NO_CELL;
      const int xi = word & 0xff, yi = (word >> 8) & 0xff;
      const float v = (float)((word >> 16) & 0xff);
      float q[5], nb[5];
      warp_bwd_q(p2, g1, k, s1n, s2n, Wp, kb == K - 1, cprev, q);
      float inj;
      int inj_row = -1;
      if constexpr (MULTI) {
        inj_row = findb[kb * CK_WARPS + w] == d ? finkb[kb * CK_WARPS + w]
                                                : -1;
        inj = k == inj_row ? 1.f : 0.f;
      } else {
        inj = (d == fd && k == fk) ? 1.f : 0.f;
      }
      bwd_recur(q, Tr, inj, v, nb);
      sh2 = sh1;
      sh1 = s1b[kb * CK_WARPS + w];
      if (MULTI && inj_row >= 0) bls = 0.f;
      const float lz = MULTI ? lzb[kb * CK_WARPS + w] : lz0;
      const float lsd = kb == K - 1 ? lsF : lsA;
      float alpha0, alpha1;
      if (kb == 0) {
        const float mx = warp_band_max(nb, row);
        const float c = mx > 0.f ? mx : 1.f;
        const float inv = 1.f / c;
#pragma unroll
        for (int s = 0; s < NS; ++s) nb[s] *= inv;
        bls += logf(c);
        cprev = c;
        alpha0 = expf(lsd + bls - lz);
        alpha1 = alpha0 * inv;
      } else {
        alpha0 = expf(lsd + bls - lz);
        alpha1 = alpha0;
      }
      // No emission at a problem's first diagonal.
      const bool bound = MULTI ? startb[kb * CK_WARPS + w] != 0 : d == 0;
      const float a0n = alpha0 * (bound ? 0.f : 1.f);
      if (row) {
        float fv[5];
#pragma unroll
        for (int s = 0; s < NS; ++s) fv[s] = S.fs[(kb * NS + s) * plane + own];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float fa = fv[s] * alpha1;
#pragma unroll
          for (int u = 0; u < NS; ++u)
            tca[s * 5 + u] = __fmaf_rn(fa, q[u], tca[s * 5 + u]);
        }
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          const int code = (s & 1) ? xi : yi;  // states 1, 3: the ref base
          S.egb[(code * 4 + s - 1) * plane + own] += (fv[s] * nb[s]) * a0n;
        }
        S.mcb[(word >> 24) * plane + own] += (fv[0] * nb[0]) * a0n;
      }
      p2 = p1;
      p1 = em6[xi * 6 + yi] * nb[0];
      g1[0] = eg6[xi] * nb[1];
      g1[1] = eg6[6 + yi] * nb[2];
      g1[2] = eg6[12 + xi] * nb[3];
      g1[3] = eg6[18 + yi] * nb[4];
    }
  }

  // Per-lane sums over the warp's rows (a fixed tree).  The transition
  // partials go through the frontier buffer, free now, so that tca is
  // only ever indexed statically and stays in registers.
  if (!live) return;
  if (row) {
#pragma unroll
    for (int j = 0; j < 25; ++j) S.fs[j * plane + own] = tca[j];
  }
  __syncwarp();
#pragma unroll 1
  for (int j = 0; j < 25; ++j) {
    const float s = warp_sum(row ? S.fs[j * plane + own] : 0.f);
    if (k == 0) tcp[((size_t)t * 25 + j) * B + b] = s;
  }
#pragma unroll 1
  for (int j = 0; j < 20; ++j) {  // j = (state - 1) * 5 + code
    const float s = warp_sum(
        row ? S.egb[((j % 5) * 4 + j / 5) * plane + own] : 0.f);
    if (k == 0) egp[((size_t)t * 20 + j) * B + b] = s;
  }
#pragma unroll 1
  for (int j = 0; j < 25; ++j) {
    const float s = warp_sum(row ? S.mcb[j * plane + own] : 0.f);
    if (k == 0) mcp[((size_t)t * 25 + j) * B + b] = s;
  }
}

// ---------------------------------------------------------------------------
// The checkpoint forward (counts_fwd_ckpt, counts_multi_fwd_ckpt) in the
// checkpoint backward's layout: one warp per lane and trial, band row k on
// thread k (Wp <= 32), the recursion of the backward's recompute
// (warp_fwd_cell, warp_rescale, warp_mixes), so a diagonal needs no block
// barrier.  A block holds LPB consecutive lanes of one trial (mk::
// warp_lanes picks LPB).  It stages the codes, the valid band and the
// per-diagonal streams of its lanes one tile of K diagonals ahead with
// cp.async (byte planes lanes-fastest, mk::stage_bytes), and each warp
// collects its tile's outputs (the checkpoint: the tile's last two
// frontiers, cs, lsf and term) in a record of its own in shared memory,
// which the block writes out as
// lane-contiguous segments once the next tile's barrier has passed: one
// barrier per tile.  A tile is one checkpoint block, so the division after
// a rescale falls on its first row and the rescale on its last, and a
// whole tile runs unrolled.  Arithmetic in the template forward's order
// (-fmad=false, no fused multiply-add), so it equals the plain version bit
// for bit.  Its output mode OUT makes the same kernel the generic forward
// (CF_MATCH: fb_generic_fwd, one trial; a warp's record holds the tile's
// scaled match plane in place of the checkpoint, and no cs leaves) and
// the stored forward (CF_ALL: counts_fwd_all, counts_multi_fwd_all; the
// record holds the tile's five scaled planes, whose f_all rows are
// contiguous, so they leave as the match plane does).  For the generic
// forward a store of F_match from each row's thread in place of the record
// costs +22-72%, plain copies in place of cp.async +59-119% (kernel_ab.py's
// probe_generic group).  CF_ALL's flush of 5 K Wp rows a lane and tile
// takes a quarter of its time on the EM batch [3, 512, 24, 8192] (3.79 ms,
// 2.89 without it after the first tiles; at Wp 32 6.20 and 3.43): every
// block flushes right after its barrier.  8-lane blocks, two an SM at 128
// registers, ran slower (4.15 ms; kernel_ab.py's probe_stored group), and
// so did the rows written a share after each diagonal of the next tile or
// as 16-byte stores of four lanes (PERF.md).
//
// What bounds it on an H100 80GB HBM3 at a 700 W power limit
// (kernel_ab.py's probe_counts group, the EM batch [3, 512, 24, 8192]:
// 2.84 ms against a 0.58 ms byte bound):
// instruction issue at ~0.65 instructions a cycle and scheduler.  A
// diagonal is ~112 instructions a warp (the five mixes 45, the shuffle
// sources' wraps and the emission lookups most of the rest), ~140 with
// the copies; device memory and the copies ~22% (2.26 ms without them
// after the first tiles), the barrier ~2%.  128 registers leave one block
// of 16 warps an SM; 8 lanes at <= 80 registers (24 warps) ran no faster,
// the 64-register cap spills, a rolled tile loop is 35% slower, plain
// copies in place of cp.async 62% slower.  8 of a warp's 32 threads idle
// at Wp 24, 24 at Wp 8, where a block of 4 row threads per 32 lanes (one
// barrier a diagonal) ran twice as fast.
// A trial's emissions in shared memory: Ematch as em6[x * 6 + y], then
// the gap emissions in pairs by code, (Egap[1][c], Egap[3][c]) and
// (Egap[2][c], Egap[4][c]), so a cell's four take two 8-byte loads; zero
// at code 5 (outside 0..4).
constexpr int CF_NTAB = 64;  // 36 + 12 + 12 floats, padded
constexpr int CF_EG = 36;    // the first pair

// The checkpoint forward's outputs (its OUT): the checkpoints, the scaled
// match plane F_match (the generic forward) or all five scaled planes
// f_all (the stored forward).
enum CfOut { CF_CKPT = 0, CF_MATCH = 1, CF_ALL = 2 };

// Floats from `n` up, as a lane's stride in a block's shared records whose
// rows the block copies LPB lanes at a time (32 / LPB rows a warp): lane w's
// row r at w * stride + r hits bank (w * stride + r) % 32, all 32 of them
// where stride % 32 == 32 / LPB.
__host__ __device__ constexpr int lane_stride(int n, int lpb) {
  return n + ((32 / lpb - n % 32) % 32 + 32) % 32;
}

// Floats of a warp's output record: CF_CKPT the checkpoint [2 NS][Wp], term
// [K], lsf [K], cs [4] and one more; CF_MATCH the tile's scaled match plane
// F_match [K][Wp] (row kb * Wp + k), term [K], lsf [K] and one more (odd
// strides: the flush reads LPB lanes' records at one offset without bank
// conflicts); CF_ALL the tile's f_all rows [K][NS][Wp] (row (kb NS + s)
// Wp + k), term [K] and lsf [K] at a lane_stride.
__host__ __device__ inline int cf_lead(int Wp, int out) {
  return out == CF_CKPT ? 2 * NS * Wp : (out == CF_MATCH ? 1 : NS) * K * Wp;
}
__host__ __device__ inline int cf_rec(int Wp, int out, int lpb) {
  return out == CF_ALL ? lane_stride(cf_lead(Wp, out) + 2 * K, lpb)
                       : cf_lead(Wp, out) + (out == CF_MATCH ? 2 * K + 1
                                                             : 2 * K + 5);
}
// A stage buffer: the xb, yb and valid tiles [K Wp][byte_stride(LPB)], the
// start tile [K][byte_stride(LPB)] (MULTI), then s1 and fink [LPB][K] (a
// lane's K values as two 16-byte words).
__host__ __device__ inline int cf_plane(int Wp, int lpb) {
  return K * Wp * mk::byte_stride(lpb);
}
__host__ __device__ inline size_t cf_in_bytes(int Wp, int lpb) {
  const size_t n = 3 * (size_t)cf_plane(Wp, lpb) +
                   K * mk::byte_stride(lpb) + 2 * K * lpb * sizeof(int);
  return (n + 15) / 16 * 16;
}
__host__ __device__ inline size_t cf_out_bytes(int Wp, int lpb, int out) {
  return ((size_t)lpb * cf_rec(Wp, out, lpb) * sizeof(float) + 15) / 16 * 16;
}
// The trial's tables, two stage buffers and two output tiles.
inline size_t cf_smem(int Wp, int lpb, int out) {
  return CF_NTAB * sizeof(float) +
         2 * (cf_in_bytes(Wp, lpb) + cf_out_bytes(Wp, lpb, out));
}

struct CfIn {
  uint8_t* x;
  uint8_t* y;
  uint8_t* v;
  uint8_t* st;
  int* s1;
  int* fk;
};

__device__ inline CfIn cf_in(uint8_t* p, int Wp, int lpb) {
  const int pl = cf_plane(Wp, lpb);
  int* words = reinterpret_cast<int*>(p + 3 * pl + K * mk::byte_stride(lpb));
  return CfIn{p, p + pl, p + 2 * pl, p + 3 * pl, words, words + K * lpb};
}

// Starts the copy of the tile of diagonals d0 .. d0 + K - 1 of the block's
// lanes b0 .. b0 + LPB - 1 into stage buffer S (one group).
template <bool MULTI, int LPB>
__device__ __forceinline__ void cf_stage(
    const CfIn& S, int d0, int b0, int Wp, int B, bool vec,
    const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ s1,
    const int8_t* __restrict__ start, const int32_t* __restrict__ fink) {
  const size_t r0 = (size_t)d0 * Wp;
  mk::stage_bytes<LPB>(S.x, xb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.y, yb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.v, valid, r0, K * Wp, b0, B, vec);
  if (MULTI) mk::stage_bytes<LPB>(S.st, start, d0, K, b0, B, vec);
  for (int q = threadIdx.x; q < K * LPB; q += 32 * LPB) {
    const int kb = q / LPB, w = q % LPB;
    if (b0 + w < B) {
      const size_t at = (size_t)(d0 + kb) * B + b0 + w;
      mk::cp_async4(S.s1 + w * K + kb, s1 + at);
      if (MULTI) mk::cp_async4(S.fk + w * K + kb, fink + at);
    }
  }
  mk::cp_async_commit();
}

// Writes output tile O (checkpoint block g) of the block's lanes of
// trial t: thread tid moves lane tid % LPB, so LPB threads write LPB
// consecutive lanes of a row.  CF_MATCH: `ckpt` is F_match [d1k][Wp][B]
// (one trial), whose rows of tile g are the record's leading K Wp floats;
// CF_ALL: `ckpt` is f_all [ntr][d1k][NS][Wp][B], whose rows of tile g are
// the record's leading K NS Wp floats.
template <int LPB, int OUT>
__device__ __forceinline__ void cf_flush(const float* O, int g, int G,
                                         int d1k, int t, int b0, int Wp,
                                         int B, float* __restrict__ ckpt,
                                         float* __restrict__ cs,
                                         float* __restrict__ lsf,
                                         float* __restrict__ term) {
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b >= B) return;
  const int i0 = threadIdx.x / LPB;  // 0 .. 31
  const int nck = cf_lead(Wp, OUT);
  const float* o = O + w * cf_rec(Wp, OUT, LPB);
  float* ck = ckpt + ((size_t)t * G + g) * nck * B + b;
  for (int r = i0; r < nck; r += 32) ck[(size_t)r * B] = o[r];
  if (i0 < K) {
    const size_t at = ((size_t)t * d1k + g * K + i0) * B + b;
    term[at] = o[nck + i0];
    lsf[at] = o[nck + K + i0];
    if (OUT == CF_CKPT && i0 < 4)
      cs[(((size_t)t * G + g) * 4 + i0) * B + b] = o[nck + 2 * K + i0];
  }
}

// Value i (known at compile time) of the four in v.
__device__ __forceinline__ int word_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The forward of one lane and trial, band row k on thread k; CF_MATCH
// keeps the scaled match plane of every diagonal in place of the
// checkpoint, CF_ALL all five scaled planes.
template <bool MULTI, int LPB, int OUT>
struct CfWarp {
  float Tr[25];
  const float* em6;
  const float2* eg13;  // by the reference code x: states 1, 3
  const float2* eg24;  // by the read code y: states 2, 4
  int k, Wp, fk;
  bool row;
  float f[5];
  float mM1 = 0.f, mM2 = 0.f, mG[4] = {0.f, 0.f, 0.f, 0.f};
  float ls = 0.f, cprev = 1.f;
  int sprev = 0;

  __device__ CfWarp(const float* __restrict__ T, const float* tab, int t,
                    int Wp_, int fk_, bool live)
      : em6(tab), eg13(reinterpret_cast<const float2*>(tab + CF_EG)),
        eg24(reinterpret_cast<const float2*>(tab + CF_EG + 12)),
        k(threadIdx.x & 31), Wp(Wp_), fk(fk_), row(k < Wp_) {
#pragma unroll
    for (int i = 0; i < 25; ++i) Tr[i] = live ? T[t * 25 + i] : 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) f[s] = 0.f;
  }

  // Tile g (diagonals K g .. K g + K - 1) of lane w from stage buffer S
  // into the warp's output record o.
  __device__ void tile(const CfIn& S, float* o, int g, int w) {
    constexpr int BS = mk::byte_stride(LPB);
    const int cell = (row ? k : 0) * BS + w, step = Wp * BS;
    const int lead = cf_lead(Wp, OUT);
    float* o_term = o + lead;
    // A diagonal without its problem's terminal cell in the band keeps
    // term 0.
    if (k < K) o_term[k] = 0.f;
    __syncwarp();
    const float lsA = ls;  // the log-scale of rows kb < K - 1
    const int4* s1w = reinterpret_cast<const int4*>(S.s1 + w * K);
    const int4* fkw = reinterpret_cast<const int4*>(S.fk + w * K);
    const int4 s1v[2] = {s1w[0], s1w[1]};
    int4 fkv[2];
    if (MULTI) fkv[0] = fkw[0], fkv[1] = fkw[1];
#pragma unroll
    for (int kb = 0; kb < K; ++kb) {
      const int t1 = word_of(s1v[kb / 4], kb % 4);
      const int x = (int8_t)S.x[cell + kb * step];
      const int y = (int8_t)S.y[cell + kb * step];
      const int xi = row && (unsigned)x < 5u ? x : 5;
      const int yi = row && (unsigned)y < 5u ? y : 5;
      const float v = row ? (float)S.v[cell + kb * step] : 0.f;
      if (!MULTI && kb == 0 && g == 0) {
        // d = 0 is pure initialisation: the start distribution.
#pragma unroll
        for (int s = 0; s < NS; ++s) f[s] = k == 0 ? 0.2f : 0.f;
        sprev = t1;
      } else {
        const int t2 = t1 + sprev;
        sprev = t1;
        const float2 gx = eg13[xi], gy = eg24[yi];
        const float e[5] = {em6[xi * 6 + yi], gx.x, gy.x, gx.y, gy.y};
        if (OUT == CF_CKPT && kb == K - 1 && row) {  // the checkpoint's
                                                     // previous frontier
#pragma unroll
          for (int s = 0; s < NS; ++s) o[(NS + s) * Wp + k] = f[s];
        }
        warp_fwd_cell<MULTI>(f, e, v, mM2, mG, k, t1, t2, Wp, kb == 0,
                             cprev, MULTI && S.st[kb * BS + w] != 0);
      }
      float tv = sum5(f);
      if (kb == K - 1) {
        const float c = warp_rescale(f, row);
        tv = tv * (1.f / c);
        ls += logf(c);
        cprev = c;
      }
      const int fkd = MULTI ? word_of(fkv[kb / 4], kb % 4) : fk;
      if (row && k == fkd) o_term[kb] = tv;
      if (OUT == CF_MATCH && row) o[kb * Wp + k] = f[0];
      if (OUT == CF_ALL && row) {
#pragma unroll
        for (int s = 0; s < NS; ++s) o[(kb * NS + s) * Wp + k] = f[s];
      }
      warp_mixes(f, Tr, mM1, mM2, mG);
    }
    if (OUT == CF_CKPT && row) {
#pragma unroll
      for (int s = 0; s < NS; ++s) o[s * Wp + k] = f[s];
    }
    if (k < K) o[lead + K + k] = k == K - 1 ? ls : lsA;
    if (OUT == CF_CKPT && k < 4)
      o[lead + 2 * K + k] =
          k == 0 ? ls : (k == 1 ? cprev : (k == 2 ? (float)sprev : 0.f));
  }
};

// A trial's emissions as CfWarp reads them (em6, then the gap pairs).
__device__ __forceinline__ void cf_tables(float* tab,
                                          const float* __restrict__ Em,
                                          const float* __restrict__ Eg,
                                          int t) {
  for (int j = threadIdx.x; j < CF_NTAB; j += blockDim.x) {
    float val = 0.f;
    if (j < 36) {
      const int x = j / 6, y = j % 6;
      val = x < 5 && y < 5 ? Em[t * 25 + x * 5 + y] : 0.f;
    } else if (j < CF_EG + 24) {
      // Pair c of states (1, 3) by x, then of (2, 4) by y.
      const int q = j - CF_EG, c = (q % 12) / 2;
      const int s = (q < 12 ? 1 : 2) + 2 * (q % 2);
      val = c < 5 ? Eg[t * 25 + s * 5 + c] : 0.f;
    }
    tab[j] = val;
  }
}

template <bool MULTI, int LPB, int OUT>
__global__ void __launch_bounds__(32 * LPB)
    counts_fwd_ckpt_kernel(const float* __restrict__ T,
                           const float* __restrict__ Em,
                           const float* __restrict__ Eg,
                           const int8_t* __restrict__ xb,
                           const int8_t* __restrict__ yb,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ s1,
                           const int8_t* __restrict__ start,
                           const int32_t* __restrict__ fink, int d1k,
                           int Wp, int B, float* __restrict__ ckpt,
                           float* __restrict__ cs, float* __restrict__ lsf,
                           float* __restrict__ term) {
  extern __shared__ __align__(16) float cf_raw[];
  float* tab = cf_raw;  // [CF_NTAB]
  uint8_t* buf = reinterpret_cast<uint8_t*>(cf_raw + CF_NTAB);
  const size_t nin = cf_in_bytes(Wp, LPB),
               nout = cf_out_bytes(Wp, LPB, OUT);
  // Stage buffer and output tile of tile g (by parity).
  auto in = [&](int g) { return cf_in(buf + (g & 1) * nin, Wp, LPB); };
  auto out = [&](int g) {
    return reinterpret_cast<float*>(buf + 2 * nin + (g & 1) * nout);
  };
  const int tid = threadIdx.x, w = tid >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w, t = blockIdx.y;
  const bool live = b < B;  // warp-uniform
  const int G = d1k / K;
  uintptr_t a4 = (uintptr_t)xb | (uintptr_t)yb | (uintptr_t)valid;
  if (MULTI) a4 |= (uintptr_t)start;
  const bool vec = B % 4 == 0 && a4 % 4 == 0;
  cf_tables(tab, Em, Eg, t);
  cf_stage<MULTI, LPB>(in(0), 0, b0, Wp, B, vec, xb, yb, valid, s1, start,
                       fink);
  CfWarp<MULTI, LPB, OUT> lane(T, tab, t, Wp,
                                 live && !MULTI ? fink[b] : -1, live);
  for (int g = 0; g < G; ++g) {
    // Tile g has landed (this thread's copies, then everyone's; the first
    // barrier also publishes the tables), every warp is past tile g - 1,
    // whose outputs leave now.
    mk::cp_async_wait();
    __syncthreads();
    if (g > 0)
      cf_flush<LPB, OUT>(out(g - 1), g - 1, G, d1k, t, b0, Wp, B, ckpt, cs,
                         lsf, term);
    if (g + 1 < G)
      cf_stage<MULTI, LPB>(in(g + 1), (g + 1) * K, b0, Wp, B, vec, xb, yb,
                           valid, s1, start, fink);
    if (live) lane.tile(in(g), out(g) + w * cf_rec(Wp, OUT, LPB), g, w);
  }
  __syncthreads();
  cf_flush<LPB, OUT>(out(G - 1), G - 1, G, d1k, t, b0, Wp, B, ckpt, cs, lsf,
                     term);
}

// ---------------------------------------------------------------------------
// The generic backward (fb_generic_bwd) in the checkpoint pair's layout:
// one warp per lane, band row k on thread k (Wp <= 32), the backward
// recursion of counts_bwd_ckpt_kernel (bwd_recur, its shuffles and
// warp_band_max) without the recompute and without counts, so a diagonal
// needs no block barrier.  A block holds LPB consecutive lanes (mk::
// warp_lanes).  Tiles of K descending diagonals are staged by cp.async one
// tile ahead into a ring of GB_RING buffers (S's scheme, csrc/fb_circ.cu
// sv_backward_kernel): the tile's F_match rows per lane, its code bytes
// lanes-fastest (mk::stage_bytes), s1 and lsf per lane.  Each posterior
// F_match * b_M * alpha is written over the F_match value it is made from,
// and the tile leaves from there as lane-contiguous rows while the next
// one is computed: one barrier per tile.  Arithmetic in the template
// backward's order (-fmad=false), so it equals the plain version bit for
// bit.  The unrolled tile takes 180 registers at 8 lanes a block (one
// block an SM) and 128 at 16; capping 8 lanes at 128 (two blocks) is 17%
// slower on the 1024-lane generic batch, a rolled tile loop 22%, tiles
// copied without cp.async 2.4x (kernel_ab.py's probe_generic group).
constexpr int GB_RING = 3;  // tile buffers: computed, leaving, arriving

// A ring buffer: the F_match (then posterior) rows [LPB][gb_stride(Wp)]
// (lane w's row k of tile row kb at w * stride + kb * Wp + k; an odd
// stride, so the copies, which move LPB lanes of one row at a time, hit
// LPB banks), s1 and lsf [LPB][K], then the xb, yb and valid tiles
// [K Wp][byte_stride(LPB)].
__host__ __device__ inline int gb_stride(int Wp) { return K * Wp + 1; }
__host__ __device__ inline size_t gb_buf_bytes(int Wp, int lpb) {
  const size_t n = (size_t)lpb * (gb_stride(Wp) + 2 * K) * sizeof(float) +
                   3 * (size_t)cf_plane(Wp, lpb);
  return (n + 15) / 16 * 16;
}
// The model's emissions and the ring.
inline size_t gb_smem(int Wp, int lpb) {
  return CF_NTAB * sizeof(float) + GB_RING * gb_buf_bytes(Wp, lpb);
}

struct GbBuf {
  float* fm;
  int* s1;
  float* lsf;
  uint8_t* x;
  uint8_t* y;
  uint8_t* v;
};

// The buffer at p (16-byte aligned).
__device__ inline GbBuf gb_buf(uint8_t* p, int Wp, int lpb) {
  float* fm = reinterpret_cast<float*>(p);
  int* s1 = reinterpret_cast<int*>(fm + lpb * gb_stride(Wp));
  float* lsf = reinterpret_cast<float*>(s1 + lpb * K);
  uint8_t* x = reinterpret_cast<uint8_t*>(lsf + lpb * K);
  const int pl = cf_plane(Wp, lpb);
  return GbBuf{fm, s1, lsf, x, x + pl, x + 2 * pl};
}

// Starts the copy of the tile of diagonals d0 .. d0 + K - 1 of the block's
// lanes b0 .. b0 + LPB - 1 into buffer S (one group): thread tid copies
// lane tid % LPB of F_match rows tid / LPB + 32 i.
template <int LPB>
__device__ __forceinline__ void gb_stage(
    const GbBuf& S, int d0, int b0, int Wp, int B, bool vec,
    const float* __restrict__ fmatch, const float* __restrict__ lsf,
    const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ s1) {
  const size_t r0 = (size_t)d0 * Wp;
  mk::stage_bytes<LPB>(S.x, xb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.y, yb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.v, valid, r0, K * Wp, b0, B, vec);
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b < B) {
    const float* src = fmatch + r0 * B + b;
    float* dst = S.fm + w * gb_stride(Wp);
    for (int r = threadIdx.x / LPB; r < K * Wp; r += 32)
      mk::cp_async4(dst + r, src + (size_t)r * B);
    const int kb = threadIdx.x / LPB;
    if (kb < K) {
      const size_t at = (size_t)(d0 + kb) * B + b;
      mk::cp_async4(S.s1 + w * K + kb, s1 + at);
      mk::cp_async4(S.lsf + w * K + kb, lsf + at);
    }
  }
  mk::cp_async_commit();
}

// Writes the posterior rows of buffer O (diagonals d0 ..) in gb_stage's
// order: LPB threads write LPB consecutive lanes of a row.
template <int LPB>
__device__ __forceinline__ void gb_flush(const GbBuf& O, int d0, int b0,
                                         int Wp, int B,
                                         float* __restrict__ post) {
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b >= B) return;
  float* dst = post + (size_t)d0 * Wp * B + b;
  const float* src = O.fm + w * gb_stride(Wp);
  for (int r = threadIdx.x / LPB; r < K * Wp; r += 32)
    dst[(size_t)r * B] = src[r];
}

// The backward of one lane, band row k on thread k.
template <int LPB>
struct GbWarp {
  float Tr[25];
  const float* em6;
  const float2* eg13;  // by the reference code x: states 1, 3
  const float2* eg24;  // by the read code y: states 2, 4
  int k, Wp, fk, fd;
  bool row;
  float lz, bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;                // s1 at d+1 and d+2
  float p1 = 0.f, p2 = 0.f;            // e_M * b_M of d+1, d+2
  float g1[4] = {0.f, 0.f, 0.f, 0.f};  // e_s * b_s of d+1

  __device__ GbWarp(const float* __restrict__ T, const float* tab, int Wp_,
                    int fk_, int fd_, float lz_, bool live)
      : em6(tab), eg13(reinterpret_cast<const float2*>(tab + CF_EG)),
        eg24(reinterpret_cast<const float2*>(tab + CF_EG + 12)),
        k(threadIdx.x & 31), Wp(Wp_), fk(fk_), fd(fd_), row(k < Wp_),
        lz(lz_) {
#pragma unroll
    for (int i = 0; i < 25; ++i) Tr[i] = live ? T[i] : 0.f;
  }

  // Tile g (diagonals K g + K - 1 down to K g) of lane w in buffer S: each
  // posterior over its F_match value.
  __device__ void tile(const GbBuf& S, int g, int w) {
#pragma unroll
    for (int kb = K - 1; kb >= 0; --kb) step(S, g * K + kb, kb, w);
  }

  // Diagonal d, row kb of its tile.
  __device__ void step(const GbBuf& S, int d, int kb, int w) {
    constexpr int BS = mk::byte_stride(LPB);
    const int cell = (row ? k : 0) * BS + w + kb * Wp * BS;
    const int x = (int8_t)S.x[cell], y = (int8_t)S.y[cell];
    const int xi = row && (unsigned)x < 5u ? x : 5;
    const int yi = row && (unsigned)y < 5u ? y : 5;
    const float v = row ? (float)S.v[cell] : 0.f;
    const int s1n = sh1, s2n = sh1 + sh2;
    float q[5], nb[5];
    warp_bwd_q(p2, g1, k, s1n, s2n, Wp, kb == K - 1, cprev, q);
    bwd_recur(q, Tr, (d == fd && k == fk) ? 1.f : 0.f, v, nb);
    sh2 = sh1;
    sh1 = S.s1[w * K + kb];
    if (kb == 0) {
      const float c = warp_rescale(nb, row);
      bls += logf(c);
      cprev = c;
    }
    const float alpha0 = expf(S.lsf[w * K + kb] + bls - lz);
    float* fm = S.fm + w * gb_stride(Wp) + kb * Wp + k;
    if (row) *fm = (*fm * nb[0]) * alpha0;
    const float2 gx = eg13[xi], gy = eg24[yi];
    p2 = p1;
    p1 = em6[xi * 6 + yi] * nb[0];
    g1[0] = gx.x * nb[1];
    g1[1] = gy.x * nb[2];
    g1[2] = gx.y * nb[3];
    g1[3] = gy.y * nb[4];
  }
};

template <int LPB>
__global__ void __launch_bounds__(32 * LPB)
    generic_bwd_kernel(const float* __restrict__ T,
                       const float* __restrict__ Em,
                       const float* __restrict__ Eg,
                       const float* __restrict__ fmatch,
                       const float* __restrict__ lsf,
                       const int8_t* __restrict__ xb,
                       const int8_t* __restrict__ yb,
                       const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ s1,
                       const int32_t* __restrict__ fink,
                       const int32_t* __restrict__ find,
                       const float* __restrict__ logZ, int d1k, int Wp,
                       int B, float* __restrict__ post) {
  extern __shared__ __align__(16) float gb_raw[];
  float* tab = gb_raw;  // [CF_NTAB]
  uint8_t* ring = reinterpret_cast<uint8_t*>(gb_raw + CF_NTAB);
  const size_t nbuf = gb_buf_bytes(Wp, LPB);
  // The buffer of the u-th tile from the top.
  auto buf = [&](int u) {
    return gb_buf(ring + (u % GB_RING) * nbuf, Wp, LPB);
  };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const int G = d1k / K;
  const bool vec = B % 4 == 0 &&
                   ((uintptr_t)xb | (uintptr_t)yb | (uintptr_t)valid) % 4 == 0;
  cf_tables(tab, Em, Eg, 0);
  gb_stage<LPB>(buf(0), (G - 1) * K, b0, Wp, B, vec, fmatch, lsf, xb, yb,
                valid, s1);
  GbWarp<LPB> lane(T, tab, Wp, live ? fink[b] : -1, live ? find[b] : -1,
                   live ? logZ[b] : 0.f, live);
  for (int u = 0; u < G; ++u) {
    // Every warp is past tile u - 1, which leaves now; tile u + 1 arrives
    // in the buffer tile u - 2 left from (the first barrier also
    // publishes the tables).
    mk::cp_async_wait();  // this thread's copies of tile u,
    __syncthreads();      // then everyone's: tile u has landed
    if (u > 0) gb_flush<LPB>(buf(u - 1), (G - u) * K, b0, Wp, B, post);
    if (u + 1 < G)
      gb_stage<LPB>(buf(u + 1), (G - 2 - u) * K, b0, Wp, B, vec, fmatch,
                    lsf, xb, yb, valid, s1);
    if (live) lane.tile(buf(u), G - 1 - u, w);
  }
  __syncthreads();
  gb_flush<LPB>(buf(G - 1), 0, b0, Wp, B, post);
}

// ---------------------------------------------------------------------------
// The stored backward (counts_bwd, counts_multi_bwd) in the generic
// backward's layout: one warp per lane and trial, band row k on thread k
// (Wp <= 32), the checkpoint backward's recursion (bwd_recur through
// shuffles, the rescale a warp max) without its recompute, so a diagonal
// needs no block barrier.  A block holds LPB consecutive lanes of one trial
// (mk::warp_lanes).  Tiles of K descending diagonals are staged by cp.async
// one tile ahead into a ring of SB_RING buffers: the tile's f_all rows
// [K][NS][Wp] per lane, its code bytes lanes-fastest (mk::stage_bytes), s1
// and lsf per lane, and over multi-problem lanes the start bytes and fink,
// find and L per lane.  Each posterior f_M * b_M * alpha0 is written over
// the f_M value it is made from, and the tile's posterior rows leave from
// there as lane-contiguous rows before the buffer is staged again: two
// barriers per tile.  A thread keeps its row's 25 transition partials in
// registers (fused multiply-adds) and its 16 gap-by-code counts in bins of
// its own in shared memory, indexed code * 4 + state - 1 (code 5, outside
// 0..4, counts nothing); the warp sums both over its rows once at the end.
// Arithmetic of the posterior in the plain version's order (-fmad=false),
// so it equals it bit for bit; the partials agree to float32 summation
// error.  A ring of 3 buffers (one barrier a tile) does not fit 16 lanes
// beside the bins (259 KB at Wp 24); at 8 lanes, one block of 8 warps an
// SM, it is 33% slower on the EM batch [3, 512, 24, 8192] (5.80 ms);
// copies without cp.async +48%; the counts take ~5% and the flush ~6%
// (kernel_ab.py's probe_stored group).  Per-warp output tiles in place of
// the f_M slots (one barrier a tile) ran slower too (PERF.md).
constexpr int SB_RING = 2;  // tile buffers: computed and leaving, arriving

// A ring buffer: the f_all (then posterior) rows [LPB][sb_stride] (lane
// w's row (kb NS + s) Wp + k at w * stride + that), s1 and lsf [LPB][K],
// with MULTI fink, find and L [LPB][K]; then the xb, yb and valid tiles
// [K Wp][byte_stride(LPB)] and with MULTI the start tile
// [K][byte_stride(LPB)].
__host__ __device__ inline int sb_stride(int Wp, int lpb) {
  return lane_stride(K * NS * Wp, lpb);
}
__host__ __device__ inline size_t sb_buf_bytes(int Wp, int lpb, bool multi) {
  const size_t n =
      (size_t)lpb * (sb_stride(Wp, lpb) + (multi ? 5 : 2) * K) *
          sizeof(float) +
      3 * (size_t)cf_plane(Wp, lpb) + (multi ? K * mk::byte_stride(lpb) : 0);
  return (n + 15) / 16 * 16;
}
// The trial's emissions, the gap bins [N_EGB][LPB][Wp] and the ring.
inline size_t sb_smem(int Wp, int lpb, bool multi) {
  return (CF_NTAB + (size_t)N_EGB * lpb * Wp) * sizeof(float) +
         SB_RING * sb_buf_bytes(Wp, lpb, multi);
}

struct SbBuf {
  float* fa;
  int* s1;
  float* lsf;
  int* fk;
  int* fd;
  float* lz;
  uint8_t* x;
  uint8_t* y;
  uint8_t* v;
  uint8_t* st;
};

// The buffer at p (16-byte aligned).
__device__ inline SbBuf sb_buf(uint8_t* p, int Wp, int lpb, bool multi) {
  SbBuf S;
  const int per = multi ? lpb * K : 0;
  S.fa = reinterpret_cast<float*>(p);
  S.s1 = reinterpret_cast<int*>(S.fa + lpb * sb_stride(Wp, lpb));
  S.lsf = reinterpret_cast<float*>(S.s1 + lpb * K);
  S.fk = reinterpret_cast<int*>(S.lsf + lpb * K);
  S.fd = S.fk + per;
  S.lz = reinterpret_cast<float*>(S.fd + per);
  S.x = reinterpret_cast<uint8_t*>(S.lz + per);
  const int pl = cf_plane(Wp, lpb);
  S.y = S.x + pl;
  S.v = S.x + 2 * pl;
  S.st = S.x + 3 * pl;
  return S;
}

// Starts the copy of the tile of diagonals d0 .. d0 + K - 1 of the block's
// lanes b0 .. b0 + LPB - 1 of trial t into buffer S (one group): thread
// tid copies lane tid % LPB of f_all rows tid / LPB + 32 i.
template <bool MULTI, int LPB>
__device__ __forceinline__ void sb_stage(
    const SbBuf& S, int t, int d0, int d1k, int b0, int Wp, int B, bool vec,
    const float* __restrict__ f_all, const float* __restrict__ lsf,
    const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ s1,
    const int8_t* __restrict__ start, const int32_t* __restrict__ fink,
    const int32_t* __restrict__ find, const float* __restrict__ L) {
  const size_t r0 = (size_t)d0 * Wp;
  mk::stage_bytes<LPB>(S.x, xb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.y, yb, r0, K * Wp, b0, B, vec);
  mk::stage_bytes<LPB>(S.v, valid, r0, K * Wp, b0, B, vec);
  if (MULTI) mk::stage_bytes<LPB>(S.st, start, d0, K, b0, B, vec);
  const int w = threadIdx.x % LPB, b = b0 + w;
  if (b < B) {
    const size_t td = (size_t)t * d1k + d0;  // the trial's diagonal d0
    const float* src = f_all + td * NS * Wp * B + b;
    float* dst = S.fa + w * sb_stride(Wp, LPB);
    for (int r = threadIdx.x / LPB; r < K * NS * Wp; r += 32)
      mk::cp_async4(dst + r, src + (size_t)r * B);
    const int kb = threadIdx.x / LPB;
    if (kb < K) {
      const size_t at = (size_t)(d0 + kb) * B + b, tat = (td + kb) * B + b;
      mk::cp_async4(S.s1 + w * K + kb, s1 + at);
      mk::cp_async4(S.lsf + w * K + kb, lsf + tat);
      if (MULTI) {
        mk::cp_async4(S.fk + w * K + kb, fink + at);
        mk::cp_async4(S.fd + w * K + kb, find + at);
        mk::cp_async4(S.lz + w * K + kb, L + tat);
      }
    }
  }
  mk::cp_async_commit();
}

// Writes the posterior rows of buffer O (diagonals d0 .. d0 + K - 1 of
// trial t): thread tid moves row tid / LPB of lane tid % LPB on each
// diagonal, so LPB threads write LPB consecutive lanes of a row.
template <int LPB>
__device__ __forceinline__ void sb_flush(const SbBuf& O, int t, int d0,
                                         int d1k, int b0, int Wp, int B,
                                         float* __restrict__ post) {
  const int w = threadIdx.x % LPB, b = b0 + w, k = threadIdx.x / LPB;
  if (b >= B || k >= Wp) return;
  float* dst = post + (((size_t)t * d1k + d0) * Wp + k) * B + b;
  const float* src = O.fa + w * sb_stride(Wp, LPB) + k;
#pragma unroll
  for (int kb = 0; kb < K; ++kb) dst[(size_t)kb * Wp * B] = src[kb * NS * Wp];
}

// The backward of one lane and trial, band row k on thread k, with its
// count partials.
template <bool MULTI, int LPB>
struct SbWarp {
  float Tr[25];
  const float* em6;
  const float2* eg13;  // by the reference code x: states 1, 3
  const float2* eg24;  // by the read code y: states 2, 4
  float* egb;          // this row's gap bins: bin j at egb[j * LPB * Wp]
  int k, Wp, fk, fd;
  bool row;
  float lz0, bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;                // s1 at d+1 and d+2
  float p1 = 0.f, p2 = 0.f;            // e_M * b_M of d+1, d+2
  float g1[4] = {0.f, 0.f, 0.f, 0.f};  // e_s * b_s of d+1
  float tca[25];                       // transition partials, s * 5 + u

  __device__ SbWarp(const float* __restrict__ T, const float* tab,
                    float* egb_, int t, int Wp_, int fk_, int fd_,
                    float lz_, bool live)
      : em6(tab), eg13(reinterpret_cast<const float2*>(tab + CF_EG)),
        eg24(reinterpret_cast<const float2*>(tab + CF_EG + 12)),
        egb(egb_), k(threadIdx.x & 31), Wp(Wp_), fk(fk_), fd(fd_),
        row(k < Wp_), lz0(lz_) {
#pragma unroll
    for (int i = 0; i < 25; ++i) Tr[i] = live ? T[t * 25 + i] : 0.f;
#pragma unroll
    for (int j = 0; j < 25; ++j) tca[j] = 0.f;
    if (row) {
#pragma unroll
      for (int j = 0; j < N_EGB; ++j) egb[j * LPB * Wp] = 0.f;
    }
  }

  // Tile g (diagonals K g + K - 1 down to K g) of lane w in buffer S.
  __device__ void tile(const SbBuf& S, int g, int w) {
#pragma unroll
    for (int kb = K - 1; kb >= 0; --kb) step(S, g * K + kb, kb, w);
  }

  // Diagonal d, row kb of its tile.
  __device__ void step(const SbBuf& S, int d, int kb, int w) {
    constexpr int BS = mk::byte_stride(LPB);
    const int cell = (row ? k : 0) * BS + w + kb * Wp * BS;
    const int x = (int8_t)S.x[cell], y = (int8_t)S.y[cell];
    const int xi = row && (unsigned)x < 5u ? x : 5;
    const int yi = row && (unsigned)y < 5u ? y : 5;
    const float v = row ? (float)S.v[cell] : 0.f;
    const int s1n = sh1, s2n = sh1 + sh2;
    float q[5], nb[5];
    warp_bwd_q(p2, g1, k, s1n, s2n, Wp, kb == K - 1, cprev, q);
    // The row of the terminal cell on d if one is there, else -1.
    int inj_row = d == fd ? fk : -1;
    float lz = lz0;
    if constexpr (MULTI) {
      inj_row = S.fd[w * K + kb] == d ? S.fk[w * K + kb] : -1;
      lz = S.lz[w * K + kb];
    }
    bwd_recur(q, Tr, k == inj_row ? 1.f : 0.f, v, nb);
    sh2 = sh1;
    sh1 = S.s1[w * K + kb];
    // A problem's backward restarts its log-scale at its terminal cell.
    if (MULTI && inj_row >= 0) bls = 0.f;
    const float lsd = S.lsf[w * K + kb];
    float alpha0, alpha1;
    if (kb == 0) {
      const float c = warp_rescale(nb, row);
      bls += logf(c);
      cprev = c;
      alpha0 = expf(lsd + bls - lz);
      alpha1 = alpha0 * (1.f / c);
    } else {
      alpha0 = expf(lsd + bls - lz);
      alpha1 = alpha0;
    }
    // No emission at a problem's first diagonal.
    const bool bound = MULTI ? S.st[kb * BS + w] != 0 : d == 0;
    const float a0n = alpha0 * (bound ? 0.f : 1.f);
    if (row) {
      float* fa = S.fa + w * sb_stride(Wp, LPB) + kb * NS * Wp + k;
      float fv[5];
#pragma unroll
      for (int s = 0; s < NS; ++s) fv[s] = fa[s * Wp];
      *fa = (fv[0] * nb[0]) * alpha0;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float fs = fv[s] * alpha1;
#pragma unroll
        for (int u = 0; u < NS; ++u)
          tca[s * 5 + u] = __fmaf_rn(fs, q[u], tca[s * 5 + u]);
      }
#pragma unroll
      for (int s = 1; s < NS; ++s) {
        const int code = (s & 1) ? xi : yi;  // states 1, 3: the ref base
        egb[(code * 4 + s - 1) * LPB * Wp] += (fv[s] * nb[s]) * a0n;
      }
    }
    const float2 gx = eg13[xi], gy = eg24[yi];
    p2 = p1;
    p1 = em6[xi * 6 + yi] * nb[0];
    g1[0] = gx.x * nb[1];
    g1[1] = gy.x * nb[2];
    g1[2] = gx.y * nb[3];
    g1[3] = gy.y * nb[4];
  }

  // The lane's partials summed over its rows (a fixed tree) into tcp [t][25]
  // and egp [t][20] (row (state - 1) * 5 + code).
  __device__ void finish(int t, int b, int B, float* __restrict__ tcp,
                         float* __restrict__ egp) {
#pragma unroll
    for (int j = 0; j < 25; ++j) {
      const float s = warp_sum(row ? tca[j] : 0.f);
      if (k == 0) tcp[((size_t)t * 25 + j) * B + b] = s;
    }
#pragma unroll 1
    for (int j = 0; j < 20; ++j) {
      const float s = warp_sum(row ? egb[((j % 5) * 4 + j / 5) * LPB * Wp]
                                   : 0.f);
      if (k == 0) egp[((size_t)t * 20 + j) * B + b] = s;
    }
  }
};

// f_all [ntr][d1k][NS][Wp][B] and lsf [ntr][d1k][B] from the stored
// forward; post [ntr][d1k][Wp][B] and the count partials are written.
// Single-problem lanes: fink, find [B] and logZ [ntr][B].  MULTI: fink,
// find [d1k][B] (a problem's terminal row and diagonal at its terminal
// diagonal, else -1), logZ the per-diagonal log-likelihood L [ntr][d1k][B]
// of the problem owning the diagonal, and start [d1k][B]: the backward
// injects at every terminal cell and restarts its log-scale there, and
// each problem's first diagonal emits nothing.
template <bool MULTI, int LPB>
__global__ void __launch_bounds__(32 * LPB, 16 / LPB)
    counts_stored_bwd_kernel(const float* __restrict__ T,
                             const float* __restrict__ Em,
                             const float* __restrict__ Eg,
                             const float* __restrict__ f_all,
                             const float* __restrict__ lsf,
                             const int8_t* __restrict__ xb,
                             const int8_t* __restrict__ yb,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ s1,
                             const int8_t* __restrict__ start,
                             const int32_t* __restrict__ fink,
                             const int32_t* __restrict__ find,
                             const float* __restrict__ logZ, int d1k, int Wp,
                             int B, float* __restrict__ post,
                             float* __restrict__ tcp,
                             float* __restrict__ egp) {
  extern __shared__ __align__(16) float sb_raw[];
  float* tab = sb_raw;              // [CF_NTAB]
  float* egb = sb_raw + CF_NTAB;    // [N_EGB][LPB][Wp]
  uint8_t* ring = reinterpret_cast<uint8_t*>(egb + N_EGB * LPB * Wp);
  const size_t nbuf = sb_buf_bytes(Wp, LPB, MULTI);
  // The buffer of the u-th tile from the top.
  auto buf = [&](int u) {
    return sb_buf(ring + (u % SB_RING) * nbuf, Wp, LPB, MULTI);
  };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w, t = blockIdx.y;
  const bool live = b < B;  // warp-uniform
  const int G = d1k / K;
  uintptr_t a4 = (uintptr_t)xb | (uintptr_t)yb | (uintptr_t)valid;
  if (MULTI) a4 |= (uintptr_t)start;
  const bool vec = B % 4 == 0 && a4 % 4 == 0;
  auto stage = [&](int u) {
    sb_stage<MULTI, LPB>(buf(u), t, (G - 1 - u) * K, d1k, b0, Wp, B, vec,
                         f_all, lsf, xb, yb, valid, s1, start, fink, find,
                         logZ);
  };
  cf_tables(tab, Em, Eg, t);
  stage(0);
  const bool one = live && !MULTI;  // the lane's terminal cell and logZ
  SbWarp<MULTI, LPB> lane(T, tab, egb + w * Wp + (threadIdx.x & 31), t, Wp,
                          one ? fink[b] : -1, one ? find[b] : -1,
                          one ? logZ[(size_t)t * B + b] : 0.f, live);
  for (int u = 0; u < G; ++u) {
    // Every warp is past tile u - 1, which leaves now; tile u + 1 arrives
    // in its buffer once that has left (the first barrier also publishes
    // the tables).
    mk::cp_async_wait();  // this thread's copies of tile u,
    __syncthreads();      // then everyone's: tile u has landed
    if (u > 0) sb_flush<LPB>(buf(u - 1), t, (G - u) * K, d1k, b0, Wp, B, post);
    if (u + 1 < G) {
      if (SB_RING == 2) __syncthreads();  // tile u - 1 has left
      stage(u + 1);
    }
    if (live) lane.tile(buf(u), G - 1 - u, w);
  }
  __syncthreads();
  sb_flush<LPB>(buf(G - 1), t, 0, d1k, b0, Wp, B, post);
  if (live) lane.finish(t, b, B, tcp, egp);
}

bool bad_shape(int ntr, int d1k, int Wp, int B) {
  return ntr < 1 || B < 1 || d1k < K || d1k % K != 0 || Wp < 1 ||
         Wp > MAX_WP;
}

// The kernel, lanes a block (mk::warp_lanes over the launch's lanes and
// trials) and shared memory of the checkpoint forward's launch in output
// mode OUT (CF_MATCH: the generic forward's, CF_ALL: the stored
// forward's), its shared memory opted in.
template <bool MULTI, int OUT>
cudaError_t cf_setup(int ntr, int Wp, int B, const void** kernel,
                     int* lanes, size_t* smem) {
  cudaError_t err = mk::warp_lanes(
      B * ntr, [Wp](int l) { return cf_smem(Wp, l, OUT); }, lanes);
  if (err != cudaSuccess) return err;
  *kernel = *lanes == 8
                ? (const void*)counts_fwd_ckpt_kernel<MULTI, 8, OUT>
                : (const void*)counts_fwd_ckpt_kernel<MULTI, 16, OUT>;
  *smem = cf_smem(Wp, *lanes, OUT);
  return mk::allow_smem(*kernel, *smem);
}

// The generic backward's kernel, lanes a block (mk::warp_lanes) and shared
// memory, opted in.
cudaError_t gb_setup(int Wp, int B, const void** kernel, int* lanes,
                     size_t* smem) {
  cudaError_t err = mk::warp_lanes(
      B, [Wp](int l) { return gb_smem(Wp, l); }, lanes);
  if (err != cudaSuccess) return err;
  *kernel = *lanes == 8 ? (const void*)generic_bwd_kernel<8>
                        : (const void*)generic_bwd_kernel<16>;
  *smem = gb_smem(Wp, *lanes);
  return mk::allow_smem(*kernel, *smem);
}

// The stored backward's kernel, lanes a block (mk::warp_lanes over the
// launch's lanes and trials) and shared memory, opted in.
template <bool MULTI>
cudaError_t sb_setup(int ntr, int Wp, int B, const void** kernel,
                     int* lanes, size_t* smem) {
  cudaError_t err = mk::warp_lanes(
      B * ntr, [Wp](int l) { return sb_smem(Wp, l, MULTI); }, lanes);
  if (err != cudaSuccess) return err;
  *kernel = *lanes == 8 ? (const void*)counts_stored_bwd_kernel<MULTI, 8>
                        : (const void*)counts_stored_bwd_kernel<MULTI, 16>;
  *smem = sb_smem(Wp, *lanes, MULTI);
  return mk::allow_smem(*kernel, *smem);
}

// The checkpoint forward in output mode OUT; `ckpt` is the checkpoints,
// F_match or f_all, `cs` unused (may be 0) but for CF_CKPT.
template <bool MULTI, int OUT = CF_CKPT>
int ckpt_fwd_launch(const float* T, const float* Em, const float* Eg,
                    const int8_t* xb, const int8_t* yb, const uint8_t* valid,
                    const int32_t* s1, const int8_t* start,
                    const int32_t* fink, int ntr, int d1k, int Wp, int B,
                    float* ckpt, float* cs, float* lsf, float* term,
                    void* stream) {
  if (bad_shape(ntr, d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = cf_setup<MULTI, OUT>(ntr, Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&T,   &Em, &Eg, &xb,   &yb, &valid, &s1,  &start,
                  &fink, &d1k, &Wp, &B,  &ckpt, &cs, &lsf,   &term};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes, ntr),
                          dim3(32 * lanes), args, smem, (cudaStream_t)stream);
}

template <bool MULTI>
int stored_bwd_launch(const float* T, const float* Em, const float* Eg,
                      const float* f_all, const float* lsf, const int8_t* xb,
                      const int8_t* yb, const uint8_t* valid,
                      const int32_t* s1, const int8_t* start,
                      const int32_t* fink, const int32_t* find,
                      const float* logZ, int ntr, int d1k, int Wp, int B,
                      float* post, float* tcp, float* egp, void* stream) {
  if (bad_shape(ntr, d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = sb_setup<MULTI>(ntr, Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&T,    &Em,   &Eg,   &f_all, &lsf, &xb, &yb,
                  &valid, &s1,  &start, &fink, &find, &logZ, &d1k,
                  &Wp,   &B,    &post, &tcp,   &egp};
  const dim3 grid((B + lanes - 1) / lanes, ntr);
  return cudaLaunchKernel(kernel, grid, dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

template <bool MULTI>
int ckpt_bwd_launch(const float* T, const float* Em, const float* Eg,
                    const float* ckpt, const float* cs, const int8_t* xb,
                    const int8_t* yb, const uint8_t* valid,
                    const int32_t* s1, const int8_t* start,
                    const int32_t* fink, const int32_t* find,
                    const float* logZ, int ntr, int d1k, int Wp, int B,
                    float* tcp, float* egp, float* mcp, void* stream) {
  if (bad_shape(ntr, d1k, Wp, B)) return cudaErrorInvalidValue;
  const size_t bytes = ckpt_smem_floats(Wp) * sizeof(float);
  cudaError_t err = mk::allow_smem(
      (const void*)counts_bwd_ckpt_kernel<MULTI>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + CK_WARPS - 1) / CK_WARPS, ntr);
  counts_bwd_ckpt_kernel<MULTI><<<grid, CK_THREADS, bytes,
                                  (cudaStream_t)stream>>>(
      T, Em, Eg, ckpt, cs, xb, yb, valid, s1, start, fink, find, logZ, d1k,
      Wp, B, tcp, egp, mcp);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes); every pointer is a device
// pointer.  T, Em, Eg are [ntr, 5, 5]; the streams [d1k, Wp, B] and s1
// [d1k, B] are shared by the trials; outputs carry the trials axis first.
// `cs` is unused (may be 0) by counts_fwd_all, `post` by counts_bwd_ckpt
// and `mcp` by counts_bwd.  Each returns a cudaError_t code.
// counts_fwd_all is the checkpoint forward's kernel in its CF_ALL mode,
// counts_bwd is counts_stored_bwd_kernel.
extern "C" int counts_fwd_all_launch(
    const float* T, const float* Em, const float* Eg, const int8_t* xb,
    const int8_t* yb, const uint8_t* valid, const int32_t* s1,
    const int32_t* fink, int ntr, int d1k, int Wp, int B, float* f_all,
    float* cs, float* lsf, float* term, void* stream) {
  return ckpt_fwd_launch<false, CF_ALL>(T, Em, Eg, xb, yb, valid, s1,
                                        nullptr, fink, ntr, d1k, Wp, B, f_all,
                                        nullptr, lsf, term, stream);
}

extern "C" int counts_fwd_ckpt_launch(
    const float* T, const float* Em, const float* Eg, const int8_t* xb,
    const int8_t* yb, const uint8_t* valid, const int32_t* s1,
    const int32_t* fink, int ntr, int d1k, int Wp, int B, float* ckpt,
    float* cs, float* lsf, float* term, void* stream) {
  return ckpt_fwd_launch<false>(T, Em, Eg, xb, yb, valid, s1, nullptr, fink,
                                ntr, d1k, Wp, B, ckpt, cs, lsf, term, stream);
}

extern "C" int counts_bwd_launch(
    const float* T, const float* Em, const float* Eg, const float* f_all,
    const float* lsf, const int8_t* xb, const int8_t* yb,
    const uint8_t* valid, const int32_t* s1, const int32_t* fink,
    const int32_t* find, const float* logZ, int ntr, int d1k, int Wp, int B,
    float* post, float* tcp, float* egp, float* mcp, void* stream) {
  return stored_bwd_launch<false>(T, Em, Eg, f_all, lsf, xb, yb, valid, s1,
                                  nullptr, fink, find, logZ, ntr, d1k, Wp, B,
                                  post, tcp, egp, stream);
}

extern "C" int counts_bwd_ckpt_launch(
    const float* T, const float* Em, const float* Eg, const float* ckpt,
    const float* cs, const int8_t* xb, const int8_t* yb,
    const uint8_t* valid, const int32_t* s1, const int32_t* fink,
    const int32_t* find, const float* logZ, int ntr, int d1k, int Wp, int B,
    float* post, float* tcp, float* egp, float* mcp, void* stream) {
  return ckpt_bwd_launch<false>(T, Em, Eg, ckpt, cs, xb, yb, valid, s1,
                                nullptr, fink, find, logZ, ntr, d1k, Wp, B,
                                tcp, egp, mcp, stream);
}

// The generic forward-backward pair of one model (T, Em, Eg [5, 5]):
// fb_generic_fwd (counts_fwd_ckpt_kernel's CF_MATCH mode) writes F_match
// [d1k, Wp, B], lsf and term [d1k, B]; fb_generic_bwd (generic_bwd_kernel)
// reads F_match, lsf and logZ [B] and writes the posterior band
// [d1k, Wp, B].
extern "C" int fb_generic_fwd_launch(
    const float* T, const float* Em, const float* Eg, const int8_t* xb,
    const int8_t* yb, const uint8_t* valid, const int32_t* s1,
    const int32_t* fink, int d1k, int Wp, int B, float* fmatch, float* lsf,
    float* term, void* stream) {
  return ckpt_fwd_launch<false, CF_MATCH>(T, Em, Eg, xb, yb, valid, s1,
                                          nullptr, fink, 1, d1k, Wp, B,
                                          fmatch, nullptr, lsf, term, stream);
}

extern "C" int fb_generic_bwd_launch(
    const float* T, const float* Em, const float* Eg, const float* fmatch,
    const float* lsf, const int8_t* xb, const int8_t* yb,
    const uint8_t* valid, const int32_t* s1, const int32_t* fink,
    const int32_t* find, const float* logZ, int d1k, int Wp, int B,
    float* post, void* stream) {
  if (bad_shape(1, d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = gb_setup(Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&T,  &Em, &Eg, &fmatch, &lsf, &xb,  &yb, &valid, &s1,
                  &fink, &find, &logZ, &d1k, &Wp, &B, &post};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem, (cudaStream_t)stream);
}

// The counts pairs over multi-problem lanes (several problems per lane,
// SPACER empty diagonals apart): the streams as above plus start int8
// [d1k, B]; fink and find are per diagonal [d1k, B] (-1 off each problem's
// terminal diagonal) and the backwards take L [ntr, d1k, B], the
// log-likelihood of the problem that owns each diagonal, in place of logZ.
extern "C" int counts_multi_fwd_all_launch(
    const float* T, const float* Em, const float* Eg, const int8_t* xb,
    const int8_t* yb, const uint8_t* valid, const int32_t* s1,
    const int8_t* start, const int32_t* fink, int ntr, int d1k, int Wp,
    int B, float* f_all, float* cs, float* lsf, float* term, void* stream) {
  return ckpt_fwd_launch<true, CF_ALL>(T, Em, Eg, xb, yb, valid, s1, start,
                                       fink, ntr, d1k, Wp, B, f_all, nullptr,
                                       lsf, term, stream);
}

extern "C" int counts_multi_fwd_ckpt_launch(
    const float* T, const float* Em, const float* Eg, const int8_t* xb,
    const int8_t* yb, const uint8_t* valid, const int32_t* s1,
    const int8_t* start, const int32_t* fink, int ntr, int d1k, int Wp,
    int B, float* ckpt, float* cs, float* lsf, float* term, void* stream) {
  return ckpt_fwd_launch<true>(T, Em, Eg, xb, yb, valid, s1, start, fink,
                               ntr, d1k, Wp, B, ckpt, cs, lsf, term, stream);
}

extern "C" int counts_multi_bwd_launch(
    const float* T, const float* Em, const float* Eg, const float* f_all,
    const float* lsf, const int8_t* xb, const int8_t* yb,
    const uint8_t* valid, const int32_t* s1, const int8_t* start,
    const int32_t* fink, const int32_t* find, const float* L, int ntr,
    int d1k, int Wp, int B, float* post, float* tcp, float* egp, float* mcp,
    void* stream) {
  return stored_bwd_launch<true>(T, Em, Eg, f_all, lsf, xb, yb, valid, s1,
                                 start, fink, find, L, ntr, d1k, Wp, B, post,
                                 tcp, egp, stream);
}

extern "C" int counts_multi_bwd_ckpt_launch(
    const float* T, const float* Em, const float* Eg, const float* ckpt,
    const float* cs, const int8_t* xb, const int8_t* yb,
    const uint8_t* valid, const int32_t* s1, const int8_t* start,
    const int32_t* fink, const int32_t* find, const float* L, int ntr,
    int d1k, int Wp, int B, float* post, float* tcp, float* egp, float* mcp,
    void* stream) {
  return ckpt_bwd_launch<true>(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, start,
                               fink, find, L, ntr, d1k, Wp, B, tcp, egp, mcp,
                               stream);
}

// What the checkpoint backward's launches at band width Wp get on this
// device (mk::kernel_info's out[5]); multi picks counts_multi_bwd_ckpt.
extern "C" int counts_bwd_ckpt_info(int multi, int Wp, int* out) {
  const void* fn = multi ? (const void*)counts_bwd_ckpt_kernel<true>
                         : (const void*)counts_bwd_ckpt_kernel<false>;
  return mk::kernel_info(fn, ckpt_smem_floats(Wp) * sizeof(float),
                         CK_THREADS, out);
}

// What the checkpoint forward's launch of ntr trials over B lanes at band
// width Wp gets on this device (mk::kernel_info's out[5]; its lanes a
// block are out[3] / 32); multi picks counts_multi_fwd_ckpt.
extern "C" int counts_fwd_ckpt_info(int multi, int ntr, int Wp, int B,
                                    int* out) {
  if (bad_shape(ntr, K, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err =
      multi ? cf_setup<true, CF_CKPT>(ntr, Wp, B, &kernel, &lanes, &smem)
            : cf_setup<false, CF_CKPT>(ntr, Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

// What the generic pair's launch over B lanes at band width Wp gets on this
// device (mk::kernel_info's out[5]; its lanes a block are out[3] / 32):
// fb_generic_bwd when `backward`, else fb_generic_fwd.
extern "C" int fb_generic_info(int backward, int Wp, int B, int* out) {
  if (bad_shape(1, K, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err =
      backward ? gb_setup(Wp, B, &kernel, &lanes, &smem)
               : cf_setup<false, CF_MATCH>(1, Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

// What the stored pair's launch of ntr trials over B lanes at band width
// Wp gets on this device (mk::kernel_info's out[5]; its lanes a block are
// out[3] / 32): counts_bwd (multi: counts_multi_bwd) when `backward`, else
// counts_fwd_all (counts_multi_fwd_all).
extern "C" int counts_stored_info(int backward, int multi, int ntr, int Wp,
                                  int B, int* out) {
  if (bad_shape(ntr, K, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err;
  if (backward)
    err = multi ? sb_setup<true>(ntr, Wp, B, &kernel, &lanes, &smem)
                : sb_setup<false>(ntr, Wp, B, &kernel, &lanes, &smem);
  else
    err = multi ? cf_setup<true, CF_ALL>(ntr, Wp, B, &kernel, &lanes, &smem)
                : cf_setup<false, CF_ALL>(ntr, Wp, B, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}
