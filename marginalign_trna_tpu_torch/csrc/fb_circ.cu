// The fused forward-backward in the circular band layout: the scaled
// backward (sv_backward), the caller's forward that accumulates expected
// base counts per reference position without writing a posterior band
// (cx_forward) and the realigner's forward that writes the posterior band
// and the MEA's per-position row and column sums (mw_forward).
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
// cx_forward and mw_forward run one forward recursion (`circ_forward`) and
// differ only in what leaves the kernel (the `Sink`).
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
// after a rescale.  Built with -fmad=false and with the plain versions'
// order of operations, so they round as the plain versions do.
//
// What bounds them on an H100: per cell the backward reads 4 B and writes
// 4 B, the forward reads 13 B, against ~25 flops; a full card would be
// memory bound, but at the caller's shapes the chain of d1k dependent
// diagonals (a block barrier each, two on rescale steps) bounds them first.
// One block owns 32 lanes x all Wp rows, keeps both frontier generations and
// the accumulators in shared memory; rolling accumulators sit at physical
// row (k - d) mod Wp, so their roll moves no data.  cx never stores a
// posterior.  mw writes 4 B per cell more: it stages each diagonal's
// circular rows in shared memory (two planes by d parity) and stores the
// band-relative rows of the diagonal before once the barrier that ends a
// diagonal has passed, so its stores coalesce.
#include "common.cuh"

namespace {

struct CircCoef {
  float a[25];  // generic branch: a[s * 5 + u] = T[s][u] * g_u
  float t00;    // gap-chain branch: T[0][0]
  float m0[4];  // backward match-row coefficients of the gap states
  float cb[4];  // backward gap self coefficients
  float r[4];   // backward terminal injection of the gap states
  float tz[4];  // T[s][0], the gap states' share of the start mass
  float pi[4];  // forward start values of the scaled gap states
  float mc[4];  // forward match-mix coefficients of the gap states
  float c[4];   // forward gap self coefficients
};
static_assert(sizeof(CircCoef) == 54 * sizeof(float), "coefficient layout");

template <int RPT>
__global__ void __launch_bounds__(1024)
    sv_backward_kernel(const float* __restrict__ es,
                       const int32_t* __restrict__ fink,
                       const int32_t* __restrict__ find, CircCoef K,
                       int chain, int d1k, int Wp, int B,
                       float* __restrict__ bm, float* __restrict__ bls_out,
                       float* __restrict__ logZ) {
  extern __shared__ float smem[];
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  float* shG = smem;             // [2][4][Wp][L] gap states of d+1 (parity)
  float* shP = shG + 8 * plane;  // [3][Wp][L] e_M * b_M of d+2 (d mod 3)
  float* shR = shP + 3 * plane;  // [Wp][L] row maxima for the rescale
  for (int i = ty * L + lane; i < 12 * plane; i += TY * L) smem[i] = 0.f;

  const int fd = live ? find[b] : -1;
  const int fk = live ? fink[b] : -1;
  float bls = 0.f, cprev = 1.f;
  float nb[RPT][5];
  float e[RPT];
  __syncthreads();

  for (int d = d1k - 1; d >= 0; --d) {
    const int gin = ((d + 1) & 1) * 4 * plane, gout = (d & 1) * 4 * plane;
    const int pin = ((d + 2) % 3) * plane, pout = (d % 3) * plane;
    const bool divide = d % 8 == 7;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const float esv = live ? es[mk::cell(d, k, b, Wp, B)] : -1.f;
      const float v = esv >= 0.f ? 1.f : 0.f;
      e[r] = fmaxf(esv, 0.f);
      const int here = k * L + lane;
      const int up = mk::wrap(k + 1, Wp) * L + lane;
      float q[5];
      q[0] = shP[pin + up];
      if (divide) q[0] = q[0] / cprev;
      q[1] = shG[gin + here];
      q[2] = shG[gin + plane + up];
      q[3] = shG[gin + 2 * plane + here];
      q[4] = shG[gin + 3 * plane + up];
      const bool inj = d == fd && k == fk;
      if (chain) {
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
        const float injv = inj ? 1.f : 0.f;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          float acc = q[0] * K.a[s * 5];
#pragma unroll
          for (int u = 1; u < 5; ++u) acc = acc + q[u] * K.a[s * 5 + u];
          nb[r][s] = (acc + injv) * v;
        }
      }
    }
    if (d % 8 == 0) {
      const float m = mk::band_max<RPT>(nb, shR, Wp, L, lane, ty, TY);
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) nb[r][s] = nb[r][s] * inv;
      bls += logf(c);
      cprev = c;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const int i = k * L + lane;
      if (live) bm[mk::cell(d, k, b, Wp, B)] = nb[r][0];
      shP[pout + i] = e[r] * nb[r][0];
#pragma unroll
      for (int g = 0; g < 4; ++g) shG[gout + g * plane + i] = nb[r][g + 1];
    }
    if (live && ty == 0) bls_out[(size_t)d * B + b] = bls;
    __syncthreads();
  }
  // Row 0 of d = 0 is r = 0 of the ty = 0 threads.
  if (live && ty == 0) {
    float zr;
    if (chain) {
      zr = nb[0][0];
#pragma unroll
      for (int s = 1; s < 5; ++s) zr = zr + K.tz[s - 1] * nb[0][s];
    } else {
      zr = (((nb[0][0] + nb[0][1]) + nb[0][2]) + nb[0][3]) + nb[0][4];
    }
    logZ[b] = logf(fmaxf(0.2f * zr, 1e-30f)) + bls;
  }
}

// The scaled forward of the circular layout for rows k = ty + r * TY of 32
// lanes: generation d of the five states from the mixes generations d - 1
// and d - 2 published to shared memory, rescaled at d % 8 == 7, and
// post = f_M * b_M * exp(ls + bls - logZ) per row (the origin cell NOT
// excluded), handed to sink.step(d, post) for d = 0 .. d1k - 1, then
// sink.finish().  Shared memory: 12 planes of [Wp][L] here, Sink::PLANES
// after them for the sink, all zeroed on entry.
template <int RPT, class Sink>
__device__ __forceinline__ void circ_forward(
    const float* __restrict__ es, const float* __restrict__ bm,
    const float* __restrict__ bls, const float* __restrict__ logZ,
    const CircCoef& K, int chain, int d1k, int Wp, int B, float* smem,
    Sink& sink) {
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  float* shG = smem;             // [2][4][Wp][L] gap-target mixes of d-1
  float* shM = shG + 8 * plane;  // [3][Wp][L] match mix of d-2 (d mod 3)
  float* shR = shM + 3 * plane;  // [Wp][L] row maxima for the rescale
  for (int i = ty * L + lane; i < (12 + Sink::PLANES) * plane; i += TY * L)
    smem[i] = 0.f;
  const float lz = live ? logZ[b] : 0.f;

  float f[RPT][5];
  float post[RPT];

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
      for (int t = 1; t < 5; ++t) {
        float g;
        if (chain) {
          g = f[r][0] + K.c[t - 1] * f[r][t];
        } else {
          g = f[r][0] * K.a[t];
#pragma unroll
          for (int s = 1; s < 5; ++s) g = g + f[r][s] * K.a[s * 5 + t];
        }
        shG[gout + (t - 1) * plane + i] = g;
      }
    }
  };

  // d = 0: the start distribution at row 0.
  {
    const float alpha0 = live ? expf(0.f + bls[b] - lz) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      f[r][0] = k == 0 ? 0.2f : 0.f;
#pragma unroll
      for (int s = 1; s < 5; ++s)
        f[r][s] = k == 0 ? (chain ? K.pi[s - 1] : 0.2f) : 0.f;
      post[r] = 0.f;
      if (k >= Wp || !live) continue;
      post[r] = f[r][0] * bm[mk::cell(0, k, b, Wp, B)] * alpha0;
    }
  }
  __syncthreads();
  sink.step(0, post);
  publish(0);
  float ls = 0.f, cprev = 1.f;
  __syncthreads();

  for (int d = 1; d < d1k; ++d) {
    const int gin = (d & 1) * 4 * plane, min_ = (d % 3) * plane;
    const bool divide = d % 8 == 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const float esv = live ? es[mk::cell(d, k, b, Wp, B)] : -1.f;
      const float v = esv >= 0.f ? 1.f : 0.f;
      const float e = fmaxf(esv, 0.f);
      const int here = k * L + lane;
      const int down = mk::wrap(k - 1, Wp) * L + lane;
      float mm = shM[min_ + down];
      if (divide) mm = mm / cprev;
      f[r][0] = e * mm;
      f[r][1] = shG[gin + here] * v;
      f[r][2] = shG[gin + plane + down] * v;
      f[r][3] = shG[gin + 2 * plane + here] * v;
      f[r][4] = shG[gin + 3 * plane + down] * v;
    }
    if (d % 8 == 7) {
      const float m = mk::band_max<RPT>(f, shR, Wp, L, lane, ty, TY);
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) f[r][s] = f[r][s] * inv;
      ls += logf(c);
      cprev = c;
    }
    const float alpha = live ? expf(ls + bls[(size_t)d * B + b] - lz) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      post[r] = 0.f;
      if (k >= Wp || !live) continue;
      post[r] = f[r][0] * bm[mk::cell(d, k, b, Wp, B)] * alpha;
    }
    sink.step(d, post);
    publish(d);
    __syncthreads();
  }
  sink.finish();
}

// Thread coordinates every sink needs.
struct Lanes {
  int L, TY, lane, ty, b, plane, Wp, B, d1k;
  bool live;
  __device__ Lanes(int Wp_, int B_, int d1k_)
      : L(blockDim.x), TY(blockDim.y), lane(threadIdx.x), ty(threadIdx.y),
        b(blockIdx.x * blockDim.x + threadIdx.x), plane(Wp_ * blockDim.x),
        Wp(Wp_), B(B_), d1k(d1k_), live(b < B_) {}
  // Physical row of logical row k of a rolling accumulator at diagonal d.
  __device__ int rolled(int k, int d) const {
    const int rot = d % Wp;
    return (k - rot < 0 ? k - rot + Wp : k - rot) * L + lane;
  }
};

// cx: four rolling accumulators by read code; the completing row fr[d]
// leaves into fl[c][d] before this diagonal's posteriors add in.
template <int RPT>
struct CxSink {
  static constexpr int PLANES = 4;
  Lanes t;
  const int8_t* __restrict__ yb;
  const int32_t* __restrict__ fr;
  float* __restrict__ fl;
  float* __restrict__ tails;
  float* shA;  // [4][Wp][L] accumulators, row (k - d) mod Wp

  __device__ void step(int d, const float (&post)[RPT]) {
    const int frd = t.live ? fr[(size_t)d * t.B + t.b] : -1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = t.ty + r * t.TY;
      if (k >= t.Wp) continue;
      const int p = t.rolled(k, d);
      const int code =
          t.live ? (int)yb[mk::cell(d, k, t.b, t.Wp, t.B)] : -1;
      const bool flush = k == frd;
      // The origin cell holds the start distribution and emits nothing.
      const float pv = d == 0 && k == 0 ? 0.f : post[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float rolled = shA[c * t.plane + p];
        if (flush && t.live) fl[((size_t)c * t.d1k + d) * t.B + t.b] = rolled;
        shA[c * t.plane + p] = (flush ? 0.f : rolled) + (code == c ? pv : 0.f);
      }
    }
    if (t.live && t.ty == 0 && (frd < 0 || frd >= t.Wp)) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        fl[((size_t)c * t.d1k + d) * t.B + t.b] = 0.f;
    }
  }

  __device__ void finish() {
    if (!t.live) return;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = t.ty + r * t.TY;
      if (k >= t.Wp) continue;
      const int p = t.rolled(k, t.d1k - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tails[((size_t)c * t.Wp + k) * t.B + t.b] = shA[c * t.plane + p];
    }
  }
};

// mw: the posterior band, band-relative, plus the column sums (rolling,
// flushed at fr) and row sums (row-stable, flushed at frr) of post.
template <int RPT>
struct MwSink {
  static constexpr int PLANES = 4;
  Lanes t;
  const int32_t* __restrict__ fr;
  const int32_t* __restrict__ frr;
  const int32_t* __restrict__ lom;
  float* __restrict__ post_out;
  float* __restrict__ flc;
  float* __restrict__ flr;
  float* __restrict__ tc;
  float* __restrict__ tr;
  float* shC;  // [Wp][L] column accumulator, row (k - d) mod Wp
  float* shW;  // [Wp][L] row accumulator, row k
  float* shP;  // [2][Wp][L] circular posterior rows of d by d parity

  // Band-relative rows of diagonal dd from its staged circular rows (all
  // threads' rows are complete once the barrier ending dd has passed).
  __device__ void write_rel(int dd) const {
    if (!t.live) return;
    const int rot = lom[(size_t)dd * t.B + t.b];
    const float* src = shP + (dd & 1) * t.plane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = t.ty + r * t.TY;
      if (k >= t.Wp) continue;
      const int c = k + rot < t.Wp ? k + rot : k + rot - t.Wp;
      post_out[mk::cell(dd, k, t.b, t.Wp, t.B)] = src[c * t.L + t.lane];
    }
  }

  __device__ void step(int d, const float (&post)[RPT]) {
    if (d > 0) write_rel(d - 1);
    const int frd = t.live ? fr[(size_t)d * t.B + t.b] : -1;
    const int frrd = t.live ? frr[(size_t)d * t.B + t.b] : -1;
    float* stage = shP + (d & 1) * t.plane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = t.ty + r * t.TY;
      if (k >= t.Wp) continue;
      const int here = k * t.L + t.lane;
      stage[here] = post[r];
      // The origin cell holds the start distribution and emits nothing.
      const float pm = d == 0 && k == 0 ? 0.f : post[r];
      const int p = t.rolled(k, d);
      const float rolled = shC[p];
      const bool cflush = k == frd;
      if (cflush && t.live) flc[(size_t)d * t.B + t.b] = rolled;
      shC[p] = (cflush ? 0.f : rolled) + pm;
      const float row = shW[here];
      const bool rflush = k == frrd;
      if (rflush && t.live) flr[(size_t)d * t.B + t.b] = row;
      shW[here] = (rflush ? 0.f : row) + pm;
    }
    if (t.live && t.ty == 0) {
      if (frd < 0 || frd >= t.Wp) flc[(size_t)d * t.B + t.b] = 0.f;
      if (frrd < 0 || frrd >= t.Wp) flr[(size_t)d * t.B + t.b] = 0.f;
    }
  }

  __device__ void finish() {
    write_rel(t.d1k - 1);
    if (!t.live) return;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = t.ty + r * t.TY;
      if (k >= t.Wp) continue;
      tc[(size_t)k * t.B + t.b] = shC[t.rolled(k, t.d1k - 1)];
      tr[(size_t)k * t.B + t.b] = shW[k * t.L + t.lane];
    }
  }
};

template <int RPT>
__global__ void __launch_bounds__(1024)
    cx_forward_kernel(const float* __restrict__ es,
                      const int8_t* __restrict__ yb,
                      const int32_t* __restrict__ fr,
                      const float* __restrict__ bm,
                      const float* __restrict__ bls,
                      const float* __restrict__ logZ, CircCoef K, int chain,
                      int d1k, int Wp, int B, float* __restrict__ fl,
                      float* __restrict__ tails) {
  extern __shared__ float smem[];
  const Lanes t(Wp, B, d1k);
  CxSink<RPT> sink{t, yb, fr, fl, tails, smem + 12 * t.plane};
  circ_forward<RPT>(es, bm, bls, logZ, K, chain, d1k, Wp, B, smem, sink);
}

template <int RPT>
__global__ void __launch_bounds__(1024)
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
  extern __shared__ float smem[];
  const Lanes t(Wp, B, d1k);
  float* own = smem + 12 * t.plane;
  MwSink<RPT> sink{t, fr, frr, lom, post, flc, flr, tc, tr,
                   own, own + t.plane, own + 2 * t.plane};
  circ_forward<RPT>(es, bm, bls, logZ, K, chain, d1k, Wp, B, smem, sink);
}

size_t sv_smem(int Wp) { return (size_t)12 * Wp * mk::LANES * sizeof(float); }
// The forward's 12 planes and the sink's 4 (both sinks use 4).
size_t fwd_smem(int Wp) { return (size_t)16 * Wp * mk::LANES * sizeof(float); }

template <int RPT>
cudaError_t run_sv(const float* es, const int32_t* fink, const int32_t* find,
                   const CircCoef& K, int chain, int d1k, int Wp, int B,
                   float* bm, float* bls, float* logZ, cudaStream_t stream) {
  cudaError_t err =
      mk::allow_smem((const void*)sv_backward_kernel<RPT>, sv_smem(Wp));
  if (err != cudaSuccess) return err;
  sv_backward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), sv_smem(Wp), stream>>>(
          es, fink, find, K, chain, d1k, Wp, B, bm, bls, logZ);
  return cudaGetLastError();
}


template <int RPT>
cudaError_t run_cx(const float* es, const int8_t* yb, const int32_t* fr,
                   const float* bm, const float* bls, const float* logZ,
                   const CircCoef& K, int chain, int d1k, int Wp, int B,
                   float* fl, float* tails, cudaStream_t stream) {
  cudaError_t err =
      mk::allow_smem((const void*)cx_forward_kernel<RPT>, fwd_smem(Wp));
  if (err != cudaSuccess) return err;
  cx_forward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fwd_smem(Wp), stream>>>(
          es, yb, fr, bm, bls, logZ, K, chain, d1k, Wp, B, fl, tails);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t run_mw(const float* es, const int32_t* fr, const int32_t* frr,
                   const int32_t* lom, const float* bm, const float* bls,
                   const float* logZ, const CircCoef& K, int chain, int d1k,
                   int Wp, int B, float* post, float* flc, float* flr,
                   float* tc, float* tr, cudaStream_t stream) {
  cudaError_t err =
      mk::allow_smem((const void*)mw_forward_kernel<RPT>, fwd_smem(Wp));
  if (err != cudaSuccess) return err;
  mw_forward_kernel<RPT>
      <<<mk::grid_shape(B), mk::block_shape(Wp), fwd_smem(Wp), stream>>>(
          es, fr, frr, lom, bm, bls, logZ, K, chain, d1k, Wp, B, post, flc,
          flr, tc, tr);
  return cudaGetLastError();
}

CircCoef load_coef(const float* coef) {
  CircCoef K;
  float* dst = reinterpret_cast<float*>(&K);
  for (int i = 0; i < 54; ++i) dst[i] = coef[i];
  return K;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 54 floats of `CircCoef`; device pointers for everything else.  Each
// returns a cudaError_t code.
extern "C" int sv_backward_launch(const float* es, const int32_t* fink,
                                  const int32_t* find, const float* coef,
                                  int chain, int d1k, int Wp, int B,
                                  float* bm, float* bls, float* logZ,
                                  void* stream) {
  if (d1k < 1 || B < 1) return cudaErrorInvalidValue;
  const CircCoef K = load_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_sv<1>(es, fink, find, K, chain, d1k, Wp, B, bm, bls, logZ, s);
    case 2: return run_sv<2>(es, fink, find, K, chain, d1k, Wp, B, bm, bls, logZ, s);
    case 3: return run_sv<3>(es, fink, find, K, chain, d1k, Wp, B, bm, bls, logZ, s);
    case 4: return run_sv<4>(es, fink, find, K, chain, d1k, Wp, B, bm, bls, logZ, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int cx_forward_launch(const float* es, const int8_t* yb,
                                 const int32_t* fr, const float* bm,
                                 const float* bls, const float* logZ,
                                 const float* coef, int chain, int d1k,
                                 int Wp, int B, float* fl, float* tails,
                                 void* stream) {
  if (d1k < 1 || B < 1) return cudaErrorInvalidValue;
  const CircCoef K = load_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_cx<1>(es, yb, fr, bm, bls, logZ, K, chain, d1k, Wp, B, fl, tails, s);
    case 2: return run_cx<2>(es, yb, fr, bm, bls, logZ, K, chain, d1k, Wp, B, fl, tails, s);
    case 3: return run_cx<3>(es, yb, fr, bm, bls, logZ, K, chain, d1k, Wp, B, fl, tails, s);
    case 4: return run_cx<4>(es, yb, fr, bm, bls, logZ, K, chain, d1k, Wp, B, fl, tails, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int mw_forward_launch(const float* es, const int32_t* fr,
                                 const int32_t* frr, const int32_t* lom,
                                 const float* bm, const float* bls,
                                 const float* logZ, const float* coef,
                                 int chain, int d1k, int Wp, int B,
                                 float* post, float* flc, float* flr,
                                 float* tc, float* tr, void* stream) {
  if (d1k < 1 || B < 1) return cudaErrorInvalidValue;
  const CircCoef K = load_coef(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run_mw<1>(es, fr, frr, lom, bm, bls, logZ, K, chain, d1k, Wp, B, post, flc, flr, tc, tr, s);
    case 2: return run_mw<2>(es, fr, frr, lom, bm, bls, logZ, K, chain, d1k, Wp, B, post, flc, flr, tc, tr, s);
    case 3: return run_mw<3>(es, fr, frr, lom, bm, bls, logZ, K, chain, d1k, Wp, B, post, flc, flr, tc, tr, s);
    case 4: return run_mw<4>(es, fr, frr, lom, bm, bls, logZ, K, chain, d1k, Wp, B, post, flc, flr, tc, tr, s);
    default: return cudaErrorInvalidValue;
  }
}
