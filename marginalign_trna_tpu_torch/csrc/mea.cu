// Banded maximum-expected-accuracy (AMAP) decode: max-plus over the
// diagonal (posterior match weight), left (ref-skip) and up (read-skip)
// moves, with pointers 0 = diag, 1 = left, 2 = up.
//
// One wavefront, two weight sources and two lane layouts:
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
//                      sums' rows), and valid, s1, s2 from lo, m, n, width.
// The TPU kernel of D carries the band windows of gap weights in VMEM and
// shifts one entering value in per diagonal (a delay line seeded at d = 0),
// because per-lane gathers scalarise there.  On the card each weight is a
// direct load of accr / accc at the cell's own read / ref position; the
// window the delay line holds is exactly that closed form on every cell
// with i >= 0 and j >= 0 (rows i = 0 and j <= 0 hold 0), and the DP reads
// weights only where valid.
// Same arithmetic as the TPU kernels: no normalisation, circular row
// shifts, first-max-wins ties in the order diag, left, up, and the terminal
// score read at (final_d, final_k) as max(value, NEG).
//
// What bounds them on an H100: K4 streams 13 B per cell (three f32 weight
// bands and the valid byte in, one pointer byte out), D 5 B (the posterior
// and the pointer; the sums are [len, B], re-read from cache) against ~6
// adds and compares (D ~15 with its masks), so at full occupancy they would
// be bound by device memory; at the main path's batch sizes the chain of D1
// dependent diagonals, one block barrier each, bounds them first.  The
// design keeps the score frontier (three generations, d mod 3) in shared
// memory and fetches the next diagonal's weights while the current one
// computes.
#include "common.cuh"

namespace {

using mk::NEG;

// K4's weights: materialised bands.
struct BandWeights {
  const float* __restrict__ wdiag;
  const float* __restrict__ wup;
  const float* __restrict__ wleft;
  const uint8_t* __restrict__ valid;
  const int32_t* __restrict__ s1;
  const int32_t* __restrict__ s2;
  int Wp, B;

  __device__ void steps(int d, int b, int& t1, int& t2) const {
    t1 = s1[(size_t)d * B + b];
    t2 = s2[(size_t)d * B + b];
  }
  __device__ void cell(int d, int k, int b, float& wd, float& wu, float& wl,
                       uint8_t& v) const {
    const size_t c = mk::cell(d, k, b, Wp, B);
    wd = wdiag[c];
    wu = wup[c];
    wl = wleft[c];
    v = valid[c];
  }
};

// D's weights: the posterior band and the per-position sums.
struct PosteriorWeights {
  const float* __restrict__ post;
  const int32_t* __restrict__ lo;
  const int32_t* __restrict__ m;
  const int32_t* __restrict__ n;
  const float* __restrict__ accr;
  const float* __restrict__ accc;
  int Wp, B, width, rgm, rgn;
  float gap_gamma, match_gamma;

  __device__ float gap(float sum) const {
    return gap_gamma * fminf(fmaxf(1.f - sum, 0.f), 1.f);
  }
  // d >= 1 (the wavefront never fetches d = 0).
  __device__ void steps(int d, int b, int& t1, int& t2) const {
    const int l0 = lo[(size_t)d * B + b];
    t1 = l0 - lo[(size_t)(d - 1) * B + b];
    t2 = d >= 2 ? l0 - lo[(size_t)(d - 2) * B + b] : 0;
  }
  __device__ void cell(int d, int k, int b, float& wd, float& wu, float& wl,
                       uint8_t& v) const {
    const int i = lo[(size_t)d * B + b] + k;
    const int j = d - i;
    const int mb = m[b], nb = n[b];
    v = k < width && i >= 0 && i <= mb && i <= d && j >= 0 && j <= nb &&
        mb + nb > 0;
    const float p = post[mk::cell(d, k, b, Wp, B)];
    wd = p >= match_gamma && p > 0.f ? p : NEG;
    wu = i >= 1 ? gap(accr[(size_t)min(i - 1, rgm - 1) * B + b]) : 0.f;
    wl = j >= 1 ? gap(accc[(size_t)min(j - 1, rgn - 1) * B + b]) : 0.f;
  }
};

// The per-diagonal streams of multi-problem lanes (mea_multi): start
// [D1, B] int8, fink / find [D1, B] int32 (-1 off terminal diagonals), and
// the terminal scores term [D1, B] it writes.
struct MultiSteps {
  const int8_t* __restrict__ start;
  const int32_t* __restrict__ fink;
  const int32_t* __restrict__ find;
  float* __restrict__ term;
};

template <int RPT, class W, bool MULTI>
__global__ void __launch_bounds__(1024)
    mea_kernel(W w, const int32_t* __restrict__ final_d,
               const int32_t* __restrict__ final_k, MultiSteps ms, int D1,
               int Wp, int B, uint8_t* __restrict__ ptr,
               float* __restrict__ score) {
  extern __shared__ float shA[];  // [3][Wp][L] score generations by d mod 3
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  const int fd = live && !MULTI ? final_d[b] : -1;
  const int fk = live && !MULTI ? final_k[b] : -1;

  // Single problem: d = 0 is pure initialisation (0 at row 0), slot 2
  // holds d = -1.  Multi: every slot holds NEG and the loop starts at 0.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
    if (k >= Wp) continue;
    const int i = k * L + lane;
    if (MULTI) {
      for (int g = 0; g < 3; ++g) shA[g * plane + i] = NEG;
      continue;
    }
    const float a0 = k == 0 ? 0.f : NEG;
    shA[i] = a0;               // d = 0
    shA[2 * plane + i] = NEG;  // d = -1
    if (live) {
      ptr[mk::cell(0, k, b, Wp, B)] = 0;
      if (fd == 0 && k == fk) score[b] = fmaxf(a0, NEG);
    }
  }

  float fd_w[RPT], fu_w[RPT], fl_w[RPT];
  uint8_t fv[RPT];
  int f1 = 0, f2 = 0, fst = 0, ffk = -1, ffd = -1;
  auto fetch = [&](int d) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      fd_w[r] = 0.f; fu_w[r] = 0.f; fl_w[r] = 0.f; fv[r] = 0;
      if (live && k < Wp) w.cell(d, k, b, fd_w[r], fu_w[r], fl_w[r], fv[r]);
    }
    f1 = 0;
    f2 = 0;
    if (live) w.steps(d, b, f1, f2);
    if (MULTI && live) {
      fst = ms.start[(size_t)d * B + b];
      ffk = ms.fink[(size_t)d * B + b];
      ffd = ms.find[(size_t)d * B + b];
    }
  };
  const int dfirst = MULTI ? 0 : 1;
  if (D1 > dfirst) fetch(dfirst);
  __syncthreads();

  for (int d = dfirst; d < D1; ++d) {
    float cd[RPT], cu[RPT], cl[RPT];
    uint8_t cv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      cd[r] = fd_w[r]; cu[r] = fu_w[r]; cl[r] = fl_w[r]; cv[r] = fv[r];
    }
    const int t1 = f1, t2 = f2;
    const bool seeds = MULTI && fst != 0;
    const int tk = MULTI && ffd >= 0 ? ffk : -1;  // terminal row, or -1
    if (d + 1 < D1) fetch(d + 1);

    const int old = ((d + 1) % 3) * plane;  // d - 2
    const int prv = ((d + 2) % 3) * plane;  // d - 1
    const int now = (d % 3) * plane;
    float na[RPT];
    uint8_t np[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      const float diag = shA[old + mk::wrap(k + t2 - 1, Wp) * L + lane] + cd[r];
      const float left = shA[prv + mk::wrap(k + t1, Wp) * L + lane] + cl[r];
      const float up = shA[prv + mk::wrap(k + t1 - 1, Wp) * L + lane] + cu[r];
      int a;
      const float v = mk::max_argmax3(diag, left, up, a);
      na[r] = cv[r] ? v : NEG;
      np[r] = (uint8_t)a;
      if (seeds && k == 0) {
        na[r] = 0.f;
        np[r] = 0;
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      shA[now + k * L + lane] = na[r];
      if (live) {
        ptr[mk::cell(d, k, b, Wp, B)] = np[r];
        if (d == fd && k == fk) score[b] = fmaxf(na[r], NEG);
        if (MULTI && k == tk) ms.term[(size_t)d * B + b] = fmaxf(na[r], NEG);
      }
    }
    if (MULTI && live && ty == 0 && (tk < 0 || tk >= Wp))
      ms.term[(size_t)d * B + b] = NEG;
    __syncthreads();
  }
}

template <int RPT, bool MULTI, class W>
cudaError_t run(const W& w, const int32_t* final_d, const int32_t* final_k,
                const MultiSteps& ms, int D1, int Wp, int B, uint8_t* ptr,
                float* score, cudaStream_t stream) {
  const size_t smem = (size_t)3 * Wp * mk::LANES * sizeof(float);
  cudaError_t err =
      mk::allow_smem((const void*)mea_kernel<RPT, W, MULTI>, smem);
  if (err != cudaSuccess) return err;
  mea_kernel<RPT, W, MULTI><<<mk::grid_shape(B), mk::block_shape(Wp), smem,
                              stream>>>(w, final_d, final_k, ms, D1, Wp, B,
                                        ptr, score);
  return cudaGetLastError();
}

template <bool MULTI = false, class W>
int dispatch(const W& w, const int32_t* final_d, const int32_t* final_k,
             int D1, int Wp, int B, uint8_t* ptr, float* score, void* stream,
             const MultiSteps& ms = MultiSteps{nullptr, nullptr, nullptr,
                                               nullptr}) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run<1, MULTI>(w, final_d, final_k, ms, D1, Wp, B, ptr, score, s);
    case 2: return run<2, MULTI>(w, final_d, final_k, ms, D1, Wp, B, ptr, score, s);
    case 3: return run<3, MULTI>(w, final_d, final_k, ms, D1, Wp, B, ptr, score, s);
    case 4: return run<4, MULTI>(w, final_d, final_k, ms, D1, Wp, B, ptr, score, s);
    default: return cudaErrorInvalidValue;
  }
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
  const BandWeights w{wdiag, wup, wleft, valid, s1, s2, Wp, B};
  return dispatch(w, final_d, final_k, D1, Wp, B, ptr, score, stream);
}

extern "C" int mea_dl_launch(const float* post, const int32_t* lo,
                             const int32_t* m, const int32_t* n,
                             const float* accr, const float* accc,
                             const int32_t* final_d, const int32_t* final_k,
                             int D1, int Wp, int B, int width, int rgm,
                             int rgn, float gap_gamma, float match_gamma,
                             uint8_t* ptr, float* score, void* stream) {
  if (rgm < 1 || rgn < 1) return cudaErrorInvalidValue;
  const PosteriorWeights w{post, lo, m, n, accr, accc, Wp, B, width, rgm,
                           rgn, gap_gamma, match_gamma};
  return dispatch(w, final_d, final_k, D1, Wp, B, ptr, score, stream);
}

extern "C" int mea_multi_launch(const float* wdiag, const float* wup,
                                const float* wleft, const uint8_t* valid,
                                const int32_t* s1, const int32_t* s2,
                                const int8_t* start, const int32_t* fink,
                                const int32_t* find, int D1, int Wp, int B,
                                uint8_t* ptr, float* term, void* stream) {
  const BandWeights w{wdiag, wup, wleft, valid, s1, s2, Wp, B};
  const MultiSteps ms{start, fink, find, term};
  return dispatch<true>(w, nullptr, nullptr, D1, Wp, B, ptr, nullptr, stream,
                        ms);
}
