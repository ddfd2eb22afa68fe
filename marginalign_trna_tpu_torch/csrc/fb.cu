// Banded 5-state pair-HMM forward-backward posteriors for models whose gap
// states emit flat (sequence-independent) probabilities, backward first:
// the REL pair, over lanes of one problem, in fb_rel.cuh's warp-per-lane
// layout.
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
// valid) is precomputed outside.
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
#include "fb_rel.cuh"

namespace {

struct FbCoef {
  float a[25];  // a[s * 5 + u]
};

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
    a.s1 = lane.irec(S, 0, kb);
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
    a.s1 = lane.irec(S, 0, kb);
    a.bls = lane.frec(S, 1, kb);
    return a;
  }

  // The posterior's scale alpha = exp(ls + bls - logZ) of the rescale
  // period starting at tile diagonal kb0, thread j for its diagonal
  // kb0 + j % 8 (ls moves only at a period's last diagonal, which computes
  // its own), to be shuffled out.
  __device__ __forceinline__ float scales(const RelIn& S, int kb0) const {
    return expf(ls + lane.frec(S, 1, kb0 + (lane.rows.kk & 7)) - lz);
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
  const RelBlock<REL_K2, LPB, KT, TMA> blk(rel_raw, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  // Tile u from the top: its first diagonal and its count (the top tile is
  // partial when D1 is no multiple of KT).
  const int tiles = (D1 + KT - 1) / KT;
  auto first = [&](int u) { return (tiles - 1 - u) * KT; };
  auto count = [&](int u) { return min(KT, D1 - first(u)); };
  const float* const bands[1] = {em};
  const void* const recs[1] = {s1};
  auto stage = [&](int u) {
    if (u < tiles)
      rel_stage<1, 1, LPB, KT, TMA>(blk.in(u), bands, recs, maps, blk.bar(u),
                                    valid, nullptr, first(u), count(u), b0,
                                    Wp, B, vec);
    mk::cp_async_commit();
  };
  RelBackward<RPT, LPB, TMA> lane(A, Wp, w, live ? final_d[b] : -1,
                                  live ? final_k[b] : -1);
  for (int u = 0; u < REL_STAGES - 1; ++u) stage(u);
  for (int u = 0; u < tiles; ++u) {
    blk.wait(u);
    if (u > 0)
      rel_flush<LPB, KT>(blk.out(u - 1), first(u - 1), count(u - 1), b0, Wp,
                         B, bm, bls, nullptr);
    stage(u + REL_STAGES - 1);
    if (live)
      lane.tile(blk.in(u), blk.rows(u, w), blk.rec(u, 0, w), first(u),
                count(u));
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), 0, count(tiles - 1), b0, Wp, B, bm,
                     bls, nullptr);
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
  const RelBlock<REL_K3, LPB, KT, TMA> blk(rel_raw, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const int tiles = (D1 + KT - 1) / KT;
  auto count = [&](int t) { return min(KT, D1 - t * KT); };
  const float* const bands[2] = {em, bm};
  const void* const recs[2] = {s1, bls};
  auto stage = [&](int t) {
    if (t < tiles)
      rel_stage<2, 2, LPB, KT, TMA>(blk.in(t), bands, recs, maps, blk.bar(t),
                                    valid, nullptr, t * KT, count(t), b0, Wp,
                                    B, vec);
    mk::cp_async_commit();
  };
  RelForward<RPT, LPB, TMA> lane(A, Wp, w, live ? logZ[b] : 0.f);
  for (int t = 0; t < REL_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    blk.wait(t);
    if (t > 0)
      rel_flush<LPB, KT>(blk.out(t - 1), (t - 1) * KT, count(t - 1), b0, Wp,
                         B, post, nullptr, nullptr);
    stage(t + REL_STAGES - 1);
    if (live) lane.tile(blk.in(t), blk.rows(t, w), t * KT, count(t));
  }
  __syncthreads();
  rel_flush<LPB, KT>(blk.out(tiles - 1), (tiles - 1) * KT, count(tiles - 1),
                     b0, Wp, B, post, nullptr, nullptr);
}

// K2's or K3's kernel (chain: the multi pair's model form, unused here).
template <int KIND, int LPB, bool TMA, int RPT>
const void* rel_kernel_of(bool) {
  if constexpr (KIND == REL_K2)
    return (const void*)rel_backward_kernel<RPT, LPB, TMA>;
  else
    return (const void*)rel_forward_kernel<RPT, LPB, TMA>;
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
  cudaError_t err = rel_launch_setup<REL_K2>(false, bands, D1, Wp, B,
                                             &maps, &kernel, &lanes, &smem);
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
  cudaError_t err = rel_launch_setup<REL_K3>(false, bands, D1, Wp, B,
                                             &maps, &kernel, &lanes, &smem);
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
  const bool tma = rel_tma(Wp, B);
  cudaError_t err =
      backward ? rel_setup<REL_K2>(false, Wp, B, tma, &kernel, &lanes, &smem)
               : rel_setup<REL_K3>(false, Wp, B, tma, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

