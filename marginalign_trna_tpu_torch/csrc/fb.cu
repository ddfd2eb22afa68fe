// Banded 5-state pair-HMM forward-backward posteriors for models whose gap
// states emit flat (sequence-independent) probabilities, backward first.
//
// Replaces the TPU kernel pair of marginalign_trna_tpu/ops/fb_pallas.py
// `_posteriors_pre`:
//   fb_backward  <- `_make_bwd_kernel_pre_first`: scaled backward from the
//                   terminal cell; stores the match-state backward band bm,
//                   the cumulative log-scale bls per diagonal, and
//                   logZ = log(0.2 * sum_s b_s(0, 0)) + bls[0].
//   fb_forward   <- `_make_fwd_kernel_pre_post`: scaled forward consuming
//                   (bm, bls, logZ); writes the normalised posterior
//                   post = f_M * b_M * exp(ls + bls - logZ).
// The model comes in at run time as A[s][u] = T[s][u] * g_u (g_0 = 1, g_u =
// the flat emission of gap state u); the match emission band (premasked by
// valid) is precomputed outside.  Scaling follows the TPU kernels: rescale
// by the band max every 8 diagonals (backward at d % 8 == 0, forward at
// d % 8 == 7), a step with no mass uses factor 1, and the d-2 term is
// divided by the previous factor on the diagonal after a rescale.  Built
// without multiply-add contraction (-fmad=false) and with the plain
// version's order of operations, it rounds like the plain version: the
// posterior's exp(ls + bls - logZ) factor turns one ulp of a ~5000-sized
// log-scale (4.9e-4) into the same relative error, so differently rounded
// scalings would disagree by more than the 2e-4 posterior tolerance on
// kilobase segments.
//
// What bounds it on an H100: per cell the backward streams 5 B in and 4 B
// out, the forward 9 B in and 4 B out, against ~35 multiply-adds, so a
// full card would be memory bound; at the main path's batch sizes the chain
// of D1 dependent diagonals (a block barrier each, two on rescale steps)
// bounds it first.  The design keeps every state of the frontier in
// registers and shared memory, mixes states before the row shift so each
// diagonal crosses shared memory once, and writes only the bands the next
// stage reads (bm, post).
#include "common.cuh"

namespace {

struct FbCoef {
  float a[25];  // a[s * 5 + u]
};

template <int RPT>
__global__ void __launch_bounds__(1024)
    fb_backward_kernel(const uint8_t* __restrict__ valid,
                       const float* __restrict__ em,
                       const int32_t* __restrict__ s1,
                       const int32_t* __restrict__ final_d,
                       const int32_t* __restrict__ final_k, FbCoef A, int D1,
                       int Wp, int B, float* __restrict__ bm,
                       float* __restrict__ bls_out,
                       float* __restrict__ logZ) {
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

  const int fd = live ? final_d[b] : -1;
  const int fk = live ? final_k[b] : -1;
  float bls = 0.f, cprev = 1.f;
  int sh1 = 0, sh2 = 0;  // s1 at d+1 and d+2
  float nb[RPT][5];
  __syncthreads();

  for (int d = D1 - 1; d >= 0; --d) {
    const int s1n = sh1, s2n = sh1 + sh2;
    const int gin = ((d + 1) & 1) * 4 * plane, gout = (d & 1) * 4 * plane;
    const int pin = ((d + 2) % 3) * plane, pout = (d % 3) * plane;
    const bool divide = d % 8 == 7;
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
      const float inj = (d == fd && k == fk) ? 1.f : 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        float acc = A.a[s * 5] * q[0];
#pragma unroll
        for (int u = 1; u < 5; ++u) acc += A.a[s * 5 + u] * q[u];
        nb[r][s] = (acc + inj) * v;
      }
    }
    sh2 = sh1;
    sh1 = live ? s1[(size_t)d * B + b] : 0;
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
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
      float e = 0.f;
      if (live) {
        const size_t c = mk::cell(d, k, b, Wp, B);
        bm[c] = nb[r][0];
        e = em[c];
      }
      shP[pout + i] = e * nb[r][0];
#pragma unroll
      for (int g = 0; g < 4; ++g) shG[gout + g * plane + i] = nb[r][g + 1];
    }
    if (live && ty == 0) bls_out[(size_t)d * B + b] = bls;
    __syncthreads();
  }
  // Row 0 of d = 0 is r = 0 of the ty = 0 threads.
  if (live && ty == 0) {
    const float z =
        0.2f * ((((nb[0][0] + nb[0][1]) + nb[0][2]) + nb[0][3]) + nb[0][4]);
    logZ[b] = logf(fmaxf(z, 1e-30f)) + bls;
  }
}

template <int RPT>
__global__ void __launch_bounds__(1024)
    fb_forward_kernel(const float* __restrict__ em,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ s1,
                      const float* __restrict__ bm,
                      const float* __restrict__ bls,
                      const float* __restrict__ logZ, FbCoef A, int D1,
                      int Wp, int B, float* __restrict__ post) {
  extern __shared__ float smem[];
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  float* shG = smem;             // [2][4][Wp][L] gap-target mixes of d-1
  float* shM = shG + 8 * plane;  // [3][Wp][L] match mix of d-2 (d mod 3)
  float* shR = shM + 3 * plane;  // [Wp][L] row maxima for the rescale
  const float lz = live ? logZ[b] : 0.f;

  // Writes the mixes generation d contributes: gap targets at d+1 and the
  // match target at d+2.
  float f[RPT][5];
  auto publish = [&](int d) {
    const int gout = ((d + 1) & 1) * 4 * plane;
    const int mout = ((d + 2) % 3) * plane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        float acc = f[r][0] * A.a[t];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc += f[r][s] * A.a[s * 5 + t];
        if (t == 0)
          shM[mout + i] = acc;
        else
          shG[gout + (t - 1) * plane + i] = acc;
      }
    }
  };

  // d = 0: the uniform start distribution at row 0; generation -1 is empty.
  const float alpha0 = live ? expf(0.f + bls[b] - lz) : 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
#pragma unroll
    for (int s = 0; s < 5; ++s) f[r][s] = k == 0 ? 0.2f : 0.f;
    if (k >= Wp) continue;
    shM[plane + k * L + lane] = 0.f;
    if (live) {
      const size_t c = mk::cell(0, k, b, Wp, B);
      post[c] = f[r][0] * bm[c] * alpha0;
    }
  }
  publish(0);
  float ls = 0.f, cprev = 1.f;
  int sprev = live ? s1[b] : 0;
  __syncthreads();

  for (int d = 1; d < D1; ++d) {
    const int t1 = live ? s1[(size_t)d * B + b] : 0;
    const int t2 = t1 + sprev;
    sprev = t1;
    const int gin = (d & 1) * 4 * plane, min_ = (d % 3) * plane;
    const bool divide = d % 8 == 0;
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
      const int kx = mk::wrap(k + t1, Wp) * L + lane;
      const int ky = mk::wrap(k + t1 - 1, Wp) * L + lane;
      f[r][0] = e * mm;
      f[r][1] = shG[gin + kx] * v;
      f[r][2] = shG[gin + plane + ky] * v;
      f[r][3] = shG[gin + 2 * plane + kx] * v;
      f[r][4] = shG[gin + 3 * plane + ky] * v;
    }
    if (d % 8 == 7) {
      const float m = mk::band_max<RPT>(f, shR, Wp, L, lane, ty, TY);
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) f[r][s] *= inv;
      ls += logf(c);
      cprev = c;
    }
    if (live) {
      const float alpha = expf(ls + bls[(size_t)d * B + b] - lz);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int k = ty + r * TY;
        if (k >= Wp) continue;
        const size_t c = mk::cell(d, k, b, Wp, B);
        post[c] = f[r][0] * bm[c] * alpha;
      }
    }
    publish(d);
    __syncthreads();
  }
}

size_t fb_smem(int Wp) { return (size_t)12 * Wp * mk::LANES * sizeof(float); }

template <int RPT>
cudaError_t run_backward(const uint8_t* valid, const float* em,
                         const int32_t* s1, const int32_t* final_d,
                         const int32_t* final_k, const FbCoef& A, int D1,
                         int Wp, int B, float* bm, float* bls, float* logZ,
                         cudaStream_t stream) {
  cudaError_t err =
      mk::allow_smem((const void*)fb_backward_kernel<RPT>, fb_smem(Wp));
  if (err != cudaSuccess) return err;
  fb_backward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fb_smem(Wp), stream>>>(
          valid, em, s1, final_d, final_k, A, D1, Wp, B, bm, bls, logZ);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t run_forward(const float* em, const uint8_t* valid,
                        const int32_t* s1, const float* bm, const float* bls,
                        const float* logZ, const FbCoef& A, int D1, int Wp,
                        int B, float* post, cudaStream_t stream) {
  cudaError_t err =
      mk::allow_smem((const void*)fb_forward_kernel<RPT>, fb_smem(Wp));
  if (err != cudaSuccess) return err;
  fb_forward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fb_smem(Wp), stream>>>(
          em, valid, s1, bm, bls, logZ, A, D1, Wp, B, post);
  return cudaGetLastError();
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
// when they are traced.  Rescaling as in the pair above.  Same bound and
// design as the pair above: 9-13 B per cell against ~35 operations, the
// chain of D1 dependent diagonals first; the frontier in registers and
// shared memory, mixes before the row shift.

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
  const FbCoef A = load_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_backward<1>(valid, em, s1, final_d, final_k, A, D1, Wp, B, bm, bls, logZ, s);
    case 2: return run_backward<2>(valid, em, s1, final_d, final_k, A, D1, Wp, B, bm, bls, logZ, s);
    case 3: return run_backward<3>(valid, em, s1, final_d, final_k, A, D1, Wp, B, bm, bls, logZ, s);
    case 4: return run_backward<4>(valid, em, s1, final_d, final_k, A, D1, Wp, B, bm, bls, logZ, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int fb_forward_launch(const float* em, const uint8_t* valid,
                                 const int32_t* s1, const float* bm,
                                 const float* bls, const float* logZ,
                                 const float* coef, int D1, int Wp, int B,
                                 float* post, void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const FbCoef A = load_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_forward<1>(em, valid, s1, bm, bls, logZ, A, D1, Wp, B, post, s);
    case 2: return run_forward<2>(em, valid, s1, bm, bls, logZ, A, D1, Wp, B, post, s);
    case 3: return run_forward<3>(em, valid, s1, bm, bls, logZ, A, D1, Wp, B, post, s);
    case 4: return run_forward<4>(em, valid, s1, bm, bls, logZ, A, D1, Wp, B, post, s);
    default: return cudaErrorInvalidValue;
  }
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
