// Banded 5-state pair-HMM forward-backward posteriors over multi-problem
// lanes, forward first, for models whose gap states emit flat
// probabilities: the multi-lane pair in fb_rel.cuh's warp-per-lane layout
// (K2 / K3's, csrc/fb.cu, with the roles crossed), in a file of its own so
// that it builds beside fb.cu.
//
// Replaces the TPU kernel pair of marginalign_trna_tpu/ops/fb_pallas.py
// `_posteriors_pre_multi`:
//   fb_multi_forward <- `_make_fwd_kernel_pre_multi`: the scaled forward
//                   over lanes of problems SPACER empty diagonals apart
//                   (ops/band.py `pack_multi_banded_batch`), row 0 seeded
//                   where `start` marks a problem's first diagonal (the
//                   gap-chain form overwrites with M 0.2 and the scaled gap
//                   states pi[t], the generic form adds 0.2 to every
//                   state); writes the scaled match plane fm, the lane's
//                   cumulative log-scale lsf and the terminal sum term at
//                   the row `fink` marks (0 on other diagonals).
//   fb_multi_backward <- `_make_bwd_kernel_pre_multi`: the scaled backward,
//                   injecting at every terminal row (chain: overwrite with 1
//                   and r[t]; generic: add 1 on the problem's terminal
//                   diagonal) and restarting bls there; writes
//                   post = fm * b_M * exp(lsf + bls - L), L the owning
//                   problem's log-likelihood in the lane's forward scale.
// The model comes as the 58 coefficients of both forms (common.cuh
// `FlatGapCoef`; `chain` picks the forward's instance of its form, a
// run-time branch there cost it 11-25%, and the backward's branch around
// arithmetic); the match emission band (premasked by valid) is
// precomputed outside.  The rescale schedule keys on the lane's diagonal,
// so lsf runs on across every problem of a lane.
//
// On an H100 80GB HBM3 at the multi batch [1024, 24, 4096] (kernel_ab.py's
// multi and probe_multi groups) the forward takes 0.64 ms and the backward
// 0.82, against 1.75 and 2.57 for the block-per-32-lanes design they
// replace; by cp.async in place of TMA they took 20-25% longer, at 8 lanes
// a block 4-6% longer at 4096 and 8192 lanes, at 16 lanes 25-44% longer at
// 1024; the backward's exp on each diagonal costs 10%; without the
// recursion after the first tiles they take 0.43 and 0.51.
#include "fb_rel.cuh"

namespace {

// MF's lane: the scaled forward over multi-problem lanes, K3's recursion
// without its posterior.  f is the frontier of the last step; mm1, mm2
// hold the match mixes of d-2 and d-1 and g the gap-target mixes of d-1
// for step d (before their shifts), sprev the s1 of d-1.  A problem's start
// needs no special step: the spacers before it leave the frontier and its
// mixes zero, and d = 0 reads the zero mixes the lane starts with.
// CHAIN: the model's gap-chain form, else the generic one.
template <int RPT, int LPB, bool TMA, bool CHAIN>
struct MultiForward {
  static constexpr int KT = rel_kt(RPT);
  struct In {
    float e[RPT], v[RPT];
    int s1, fk;
    bool seed;  // a problem starts at this diagonal
  };
  const mk::FlatGapCoef& K;
  RelLane<RPT, LPB, TMA> lane;
  float ls = 0.f, cprev = 1.f;
  int sprev = 0;
  float f[RPT][5], mm1[RPT], mm2[RPT], g[4][RPT];

  __device__ MultiForward(const mk::FlatGapCoef& K_, int Wp, int w)
      : K(K_), lane(Wp, w) {
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
      a.e[r] = S.p[lane.template at<FIXED>(kb, r)];
      a.v[r] = lane.valid(S, kb, r);
    }
    a.s1 = lane.irec(S, 0, kb);
    a.fk = lane.irec(S, 1, kb);
    a.seed = lane.starts(S, kb);
    return a;
  }

  // Diagonals d0 .. d0 + n - 1 (a tile) from stage buffer S: the lane's fm
  // rows to out, its lsf and term records to olsf and oterm (term first
  // zeroed: a diagonal whose terminal row is not in the band keeps 0).  A
  // whole tile runs unrolled, each diagonal's inputs read one diagonal
  // ahead.
  __device__ __forceinline__ void tile(const RelIn& S, float* out,
                                       float* olsf, float* oterm, int n) {
    if (lane.rows.kk < KT) oterm[lane.rows.kk] = 0.f;
    __syncwarp();
    if (n == KT) {
      In cur = load<true>(S, 0);
#pragma unroll
      for (int kb = 0; kb < KT; ++kb) {
        const In next = load<true>(S, kb + 1 < KT ? kb + 1 : kb);
        step(kb, cur, out, olsf, oterm);
        cur = next;
      }
    } else {
      for (int kb = 0; kb < n; ++kb)
        step(kb, load<false>(S, kb), out, olsf, oterm);
    }
  }

  // Generation d (tile diagonal kb, d % 8 == kb % 8), in the plain
  // version's order: the match mix of d-2 at row k + s2 - 1 (divided by the
  // previous factor at d % 8 == 0), the gap mixes of d-1 at rows k + s1
  // (1, 3) and k + s1 - 1 (2, 4), row 0 seeded where a problem starts; the
  // terminal sum w of every row before the rescale at d % 8 == 7, times
  // its 1 / c there.
  __device__ __forceinline__ void step(int kb, const In& a, float* out,
                                       float* olsf, float* oterm) {
    const int t1 = a.s1, t2 = t1 + sprev;
    sprev = t1;
    float mm[RPT], q[4][RPT], w[RPT];
    lane.template move<true>(mm1, mm, t2 - 1);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      lane.template move<true>(g[u], q[u], t1 - (u & 1));
    const bool divide = (kb & 7) == 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float m = divide ? mm[r] / cprev : mm[r];
      const bool seed = a.seed & (lane.row(r) == 0);
      if constexpr (CHAIN) {
        f[r][0] = seed ? 0.2f : a.e[r] * m;
#pragma unroll
        for (int s = 1; s < 5; ++s)
          f[r][s] = seed ? K.pi[s - 1] : q[s - 1][r] * a.v[r];
        w[r] = f[r][0];
#pragma unroll
        for (int s = 1; s < 5; ++s) w[r] = w[r] + K.k[s - 1] * f[r][s];
      } else {
        const float inj = seed ? 0.2f : 0.f;
        f[r][0] = a.e[r] * m * a.v[r] + inj;
#pragma unroll
        for (int s = 1; s < 5; ++s) f[r][s] = q[s - 1][r] * a.v[r] + inj;
        w[r] = (((f[r][0] + f[r][1]) + f[r][2]) + f[r][3]) + f[r][4];
      }
    }
    if ((kb & 7) == 7) {
      const float c = rescale(lane.rows, lane.Wp, f);
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r) w[r] = w[r] * inv;
      ls += logf(c);
      cprev = c;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = lane.row(r);
      if (k < lane.Wp) out[kb * lane.Wp + k] = f[r][0];
      if ((k < lane.Wp) & (k == a.fk)) oterm[kb] = w[r];
      // The mixes generation d contributes: the match target at d+2 and
      // the gap targets at d+1.
      float mx[5];
      if constexpr (CHAIN) {
        mx[0] = K.t00 * f[r][0];
#pragma unroll
        for (int s = 1; s < 5; ++s) mx[0] = mx[0] + K.mc[s - 1] * f[r][s];
#pragma unroll
        for (int u = 1; u < 5; ++u) mx[u] = f[r][0] + K.c[u - 1] * f[r][u];
      } else {
#pragma unroll
        for (int t = 0; t < 5; ++t) {
          mx[t] = f[r][0] * K.a[t];
#pragma unroll
          for (int s = 1; s < 5; ++s) mx[t] = mx[t] + f[r][s] * K.a[s * 5 + t];
        }
      }
      mm1[r] = mm2[r];
      mm2[r] = mx[0];
#pragma unroll
      for (int u = 1; u < 5; ++u) g[u - 1][r] = mx[u];
    }
    if (lane.rows.kk == 0) olsf[kb] = ls;
  }
};

// MB's lane: the scaled backward over multi-problem lanes, K2's recursion
// with an injection at every terminal cell and K3's posterior.  After
// step(d), nb holds generation d; p1, p2 hold e_M * b_M of d+1 and d+2 and
// g the gap states of d+1 (as the next step reads them, before their
// shifts), sh1 and sh2 the s1 of d+1 and d+2.  bls restarts at each
// problem's terminal diagonal, so the posterior's scale
// alpha = exp(lsf + bls - L) is a lane scalar of each diagonal.  The
// model form is a run-time branch around arithmetic only: with an
// instance a form the 16-lane TMA kernel spilled 16-48 B at 128 registers.
template <int RPT, int LPB, bool TMA>
struct MultiBackward {
  static constexpr int KT = rel_kt(RPT);
  struct In {
    float e[RPT], fm[RPT], v[RPT];
    int s1, fk, fd;
    float lsf, L;
  };
  const mk::FlatGapCoef& K;
  const int chain;
  RelLane<RPT, LPB, TMA> lane;
  float bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;
  float nb[RPT][5], p1[RPT], p2[RPT], g[4][RPT];

  __device__ MultiBackward(const mk::FlatGapCoef& K_, int chain_, int Wp,
                           int w)
      : K(K_), chain(chain_), lane(Wp, w) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      p1[r] = p2[r] = g[0][r] = g[1][r] = g[2][r] = g[3][r] = 0.f;
  }

  // (FIXED: kb is a constant.)
  template <bool FIXED>
  __device__ __forceinline__ In load(const RelIn& S, int kb) const {
    In a;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int o = lane.template at<FIXED>(kb, r);
      a.e[r] = S.p[o];
      a.fm[r] = S.p[lane.plane + o];
      a.v[r] = lane.valid(S, kb, r);
    }
    a.s1 = lane.irec(S, 0, kb);
    a.fk = lane.irec(S, 1, kb);
    a.fd = lane.irec(S, 2, kb);
    a.lsf = lane.frec(S, 3, kb);
    a.L = lane.frec(S, 4, kb);
    return a;
  }

  // Diagonals d0 + n - 1 down to d0 (a tile) from stage buffer S: the
  // lane's posterior rows to out.  A whole tile runs unrolled, each
  // diagonal's inputs read one diagonal ahead.
  __device__ __forceinline__ void tile(const RelIn& S, float* out, int d0,
                                       int n) {
    if (n == KT) {
      In cur = load<true>(S, KT - 1);
#pragma unroll
      for (int kb = KT - 1; kb >= 0; --kb) {
        const In next = load<true>(S, kb > 0 ? kb - 1 : 0);
        step(d0 + kb, kb, cur, out);
        cur = next;
      }
    } else {
      for (int kb = n - 1; kb >= 0; --kb)
        step(d0 + kb, kb, load<false>(S, kb), out);
    }
  }

  // Generation d (tile diagonal kb, d % 8 == kb % 8), in the plain
  // version's order: q0 = e_M b_M of d+2 at row k + 1 - s2 (divided by the
  // previous factor at d % 8 == 7), the gap states of d+1 at rows k - s1
  // (1, 3) and k + 1 - s1 (2, 4); the terminal row fink injects (the chain
  // form overwrites on any diagonal that names one, the generic form adds
  // 1 on the problem's terminal diagonal), bls restarts there before the
  // rescale at d % 8 == 0, and the posterior is fm * b_M * alpha.
  __device__ __forceinline__ void step(int d, int kb, const In& a,
                                       float* out) {
    float q0[RPT], q[4][RPT];
    lane.move(p2, q0, 1 - (sh1 + sh2));
#pragma unroll
    for (int u = 0; u < 4; ++u) lane.move(g[u], q[u], (u & 1) - sh1);
    const bool divide = (kb & 7) == 7, term = a.fd == d;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float x0 = divide ? q0[r] / cprev : q0[r];
      const bool inj = lane.row(r) == a.fk;
      if (chain) {
        float acc = K.t00 * x0;
#pragma unroll
        for (int s = 1; s < 5; ++s) acc = acc + K.m0[s - 1] * q[s - 1][r];
        nb[r][0] = (inj ? 1.f : acc) * a.v[r];
#pragma unroll
        for (int s = 1; s < 5; ++s)
          nb[r][s] =
              (inj ? K.r[s - 1] : x0 + K.cb[s - 1] * q[s - 1][r]) * a.v[r];
      } else {
        const float one = inj & term ? 1.f : 0.f;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          float acc = x0 * K.a[s * 5];
#pragma unroll
          for (int u = 1; u < 5; ++u) acc = acc + q[u - 1][r] * K.a[s * 5 + u];
          nb[r][s] = (acc + one) * a.v[r];
        }
      }
    }
    sh2 = sh1;
    sh1 = a.s1;
    bls = term ? 0.f : bls;
    if ((kb & 7) == 0) {
      const float c = rescale(lane.rows, lane.Wp, nb);
      bls += logf(c);
      cprev = c;
    }
    const float alpha = expf(a.lsf + bls - a.L);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (lane.row(r) < lane.Wp)
        out[kb * lane.Wp + lane.row(r)] = a.fm[r] * nb[r][0] * alpha;
      p2[r] = p1[r];
      p1[r] = a.e[r] * nb[r][0];
#pragma unroll
      for (int s = 1; s < 5; ++s) g[s - 1][r] = nb[r][s];
    }
  }
};

// fb_multi_forward: MF's lanes in K3's walk, from d = 0 up.
template <int RPT, int LPB, bool TMA, bool CHAIN>
__global__ void __launch_bounds__(32 * LPB)
    multi_forward_kernel(const float* __restrict__ em,
                         const uint8_t* __restrict__ valid,
                         const int32_t* __restrict__ s1,
                         const int8_t* __restrict__ start,
                         const int32_t* __restrict__ fink,
                         const __grid_constant__ RelMaps maps,
                         mk::FlatGapCoef K, int D1, int Wp, int B, int vec,
                         float* __restrict__ fm,
                         float* __restrict__ lsf, float* __restrict__ term) {
  constexpr int KT = rel_kt(RPT);
  extern __shared__ __align__(16) uint8_t rel_raw[];
  const RelBlock<REL_MF, LPB, KT, TMA> blk(rel_raw, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB;
  const bool live = b0 + w < B;  // warp-uniform
  const int tiles = (D1 + KT - 1) / KT;
  auto count = [&](int t) { return min(KT, D1 - t * KT); };
  const float* const bands[1] = {em};
  const void* const recs[2] = {s1, fink};
  auto stage = [&](int t) {
    if (t < tiles)
      rel_stage<1, 2, LPB, KT, TMA>(blk.in(t), bands, recs, maps, blk.bar(t),
                                    valid, start, t * KT, count(t), b0, Wp,
                                    B, vec);
    mk::cp_async_commit();
  };
  MultiForward<RPT, LPB, TMA, CHAIN> lane(K, Wp, w);
  for (int t = 0; t < REL_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    blk.wait(t);
    if (t > 0)
      rel_flush<LPB, KT>(blk.out(t - 1), (t - 1) * KT, count(t - 1), b0, Wp,
                         B, fm, lsf, term);
    stage(t + REL_STAGES - 1);
    if (live)
      lane.tile(blk.in(t), blk.rows(t, w), blk.rec(t, 0, w),
                blk.rec(t, 1, w), count(t));
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), (tiles - 1) * KT, count(tiles - 1),
                     b0, Wp, B, fm, lsf, term);
}

// fb_multi_backward: MB's lanes in K2's walk, from the top down.
template <int RPT, int LPB, bool TMA>
__global__ void __launch_bounds__(32 * LPB)
    multi_backward_kernel(const float* __restrict__ fm,
                          const float* __restrict__ lsf,
                          const float* __restrict__ L,
                          const float* __restrict__ em,
                          const uint8_t* __restrict__ valid,
                          const int32_t* __restrict__ s1,
                          const int32_t* __restrict__ fink,
                          const int32_t* __restrict__ find,
                          const __grid_constant__ RelMaps maps,
                          mk::FlatGapCoef K, int chain, int D1, int Wp, int B,
                          int vec, float* __restrict__ post) {
  constexpr int KT = rel_kt(RPT);
  extern __shared__ __align__(16) uint8_t rel_raw[];
  const RelBlock<REL_MB, LPB, KT, TMA> blk(rel_raw, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB;
  const bool live = b0 + w < B;  // warp-uniform
  const int tiles = (D1 + KT - 1) / KT;
  auto first = [&](int u) { return (tiles - 1 - u) * KT; };
  auto count = [&](int u) { return min(KT, D1 - first(u)); };
  const float* const bands[2] = {em, fm};
  const void* const recs[5] = {s1, fink, find, lsf, L};
  auto stage = [&](int u) {
    if (u < tiles)
      rel_stage<2, 5, LPB, KT, TMA>(blk.in(u), bands, recs, maps, blk.bar(u),
                                    valid, nullptr, first(u), count(u), b0,
                                    Wp, B, vec);
    mk::cp_async_commit();
  };
  MultiBackward<RPT, LPB, TMA> lane(K, chain, Wp, w);
  for (int u = 0; u < REL_STAGES - 1; ++u) stage(u);
  for (int u = 0; u < tiles; ++u) {
    blk.wait(u);
    if (u > 0)
      rel_flush<LPB, KT>(blk.out(u - 1), first(u - 1), count(u - 1), b0, Wp,
                         B, post, nullptr, nullptr);
    stage(u + REL_STAGES - 1);
    if (live) lane.tile(blk.in(u), blk.rows(u, w), first(u), count(u));
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), 0, count(tiles - 1), b0, Wp, B, post,
                     nullptr, nullptr);
}

// fb_multi_forward's kernel of the model form `chain`, or
// fb_multi_backward's (one for both forms).
template <int KIND, int LPB, bool TMA, int RPT>
const void* rel_kernel_of(bool chain) {
  if constexpr (KIND == REL_MF)
    return chain ? (const void*)multi_forward_kernel<RPT, LPB, TMA, true>
                 : (const void*)multi_forward_kernel<RPT, LPB, TMA, false>;
  else
    return (const void*)multi_backward_kernel<RPT, LPB, TMA>;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 58 floats of `mk::FlatGapCoef`; device pointers for everything else.
// Each returns a cudaError_t code.
extern "C" int fb_multi_forward_launch(const float* em, const uint8_t* valid,
                                       const int32_t* s1, const int8_t* start,
                                       const int32_t* fink, const float* coef,
                                       int chain, int D1, int Wp, int B,
                                       float* fm, float* lsf, float* term,
                                       void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  mk::FlatGapCoef K = mk::load_flat_coef(coef);
  RelMaps maps;
  const void* kernel;
  int lanes;
  size_t smem;
  const float* bands[1] = {em};
  cudaError_t err = rel_launch_setup<REL_MF>(chain, bands, D1, Wp, B,
                                             &maps, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  int vec = mk::words_aligned(B, {valid, start});
  void* args[] = {&em, &valid, &s1, &start, &fink, &maps, &K,
                  &D1, &Wp,    &B,  &vec,   &fm,   &lsf,  &term};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
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
  mk::FlatGapCoef K = mk::load_flat_coef(coef);
  RelMaps maps;
  const void* kernel;
  int lanes;
  size_t smem;
  const float* bands[2] = {em, fm};
  cudaError_t err = rel_launch_setup<REL_MB>(chain, bands, D1, Wp, B,
                                             &maps, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  int vec = mk::words_aligned(B, {valid});
  void* args[] = {&fm, &lsf, &Lp,  &em,    &valid, &s1, &fink, &find, &maps,
                  &K,  &chain, &D1, &Wp,   &B,     &vec, &post};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// What fb_multi_backward's (backward != 0) or fb_multi_forward's launch at
// band width Wp over B lanes with a gap-chain model gets on this device
// (as fb_rel_info).
extern "C" int fb_multi_info(int backward, int Wp, int B, int* out) {
  if (B < 1) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  const bool tma = rel_tma(Wp, B);
  cudaError_t err =
      backward ? rel_setup<REL_MB>(true, Wp, B, tma, &kernel, &lanes, &smem)
               : rel_setup<REL_MF>(true, Wp, B, tma, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}
