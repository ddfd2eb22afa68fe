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
// What bounds it on an H100: not bytes (3 B in, 1 B out per cell) nor
// arithmetic (~12 adds/compares per cell) but the chain of D1 dependent
// diagonals, each ending in a block barrier, and how many blocks are live:
// one block per 32 lanes.  The design keeps both frontier generations in
// shared memory (never in device memory), reads the d-2 generation as a
// precomputed (max, argmax) over its three states so the match move costs
// one shared load, and fetches the next diagonal's inputs while the current
// one computes.
#include "common.cuh"

namespace {

using mk::NEG;

struct NwScores {
  float match, mismatch, gap_open, gap_extend;
};

// The per-diagonal streams of multi-problem lanes (nw_multi): start [D1, B]
// int8, fink / find [D1, B] int32 (-1 off terminal diagonals), and the
// terminal scores term [3, D1, B] it writes.
struct MultiSteps {
  const int8_t* __restrict__ start;
  const int32_t* __restrict__ fink;
  const int32_t* __restrict__ find;
  float* __restrict__ term;
};

template <int RPT, bool MULTI>
__global__ void __launch_bounds__(1024)
    nw_kernel(const int8_t* __restrict__ xb, const int8_t* __restrict__ yb,
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ s1, const int32_t* __restrict__ s2,
              const int32_t* __restrict__ final_d,
              const int32_t* __restrict__ final_k, MultiSteps ms, int D1,
              int Wp, int B, NwScores p, uint8_t* __restrict__ ptr,
              float* __restrict__ score, int32_t* __restrict__ final_state) {
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

  const int fd = live && !MULTI ? final_d[b] : -1;
  const int fk = live && !MULTI ? final_k[b] : -1;

  auto terminal = [&](float m, float x, float y) {
    const float tm = fmaxf(m, NEG), tx = fmaxf(x, NEG), tyv = fmaxf(y, NEG);
    float best = tm;
    int st = 0;
    if (tx > best) { best = tx; st = 1; }
    if (tyv > best) { best = tyv; st = 2; }
    score[b] = best;
    final_state[b] = st;
  };

  // Single problem: d = 0 is pure initialisation, M = 0 at row 0, and
  // slot 2 holds d = -1.  Multi: every slot holds NEG (generations -1 and
  // -2) and the loop starts at d = 0.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
    if (k >= Wp) continue;
    const int i = k * L + lane;
    if (MULTI) {
      for (int g = 0; g < 2; ++g) {
        shM[g * plane + i] = NEG;
        shX[g * plane + i] = NEG;
        shY[g * plane + i] = NEG;
      }
      for (int g = 0; g < 3; ++g) {
        shBest[g * plane + i] = NEG;
        shArg[g * plane + i] = 0;
      }
      continue;
    }
    const float m0 = k == 0 ? 0.f : NEG;
    int a;
    const float best = mk::max_argmax3(m0, NEG, NEG, a);
    shM[i] = m0;
    shX[i] = NEG;
    shY[i] = NEG;
    shBest[i] = best;
    shArg[i] = (uint8_t)a;
    shBest[2 * plane + i] = NEG;
    shArg[2 * plane + i] = 0;
    if (live) {
      ptr[mk::cell(0, k, b, Wp, B)] = 0;
      if (fd == 0 && k == fk) terminal(m0, NEG, NEG);
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
    int8_t cx[RPT], cy[RPT];
    uint8_t cv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { cx[r] = fx[r]; cy[r] = fy[r]; cv[r] = fv[r]; }
    const int t1 = f1, t2 = f2;
    const bool seeds = MULTI && fst != 0;
    const int tk = MULTI && ffd >= 0 ? ffk : -1;  // terminal row, or -1
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
        if (d == fd && k == fk) terminal(nm[r], nx[r], ny[r]);
        if (MULTI && k == tk) {
          const size_t t = (size_t)d * B + b, n = (size_t)D1 * B;
          ms.term[t] = fmaxf(nm[r], NEG);
          ms.term[n + t] = fmaxf(nx[r], NEG);
          ms.term[2 * n + t] = fmaxf(ny[r], NEG);
        }
      }
    }
    if (MULTI && live && ty == 0 && (tk < 0 || tk >= Wp)) {
      const size_t t = (size_t)d * B + b, n = (size_t)D1 * B;
      ms.term[t] = NEG;
      ms.term[n + t] = NEG;
      ms.term[2 * n + t] = NEG;
    }
    __syncthreads();
  }
}

template <int RPT, bool MULTI>
cudaError_t run(const int8_t* xb, const int8_t* yb, const uint8_t* valid,
                const int32_t* s1, const int32_t* s2, const int32_t* final_d,
                const int32_t* final_k, const MultiSteps& ms, int D1, int Wp,
                int B, NwScores p, uint8_t* ptr, float* score,
                int32_t* final_state, cudaStream_t stream) {
  const size_t smem = (size_t)Wp * mk::LANES * (9 * sizeof(float) + 3);
  cudaError_t err =
      mk::allow_smem((const void*)nw_kernel<RPT, MULTI>, smem);
  if (err != cudaSuccess) return err;
  nw_kernel<RPT, MULTI>
      <<<mk::grid_shape(B), mk::block_shape(Wp), smem, stream>>>(
          xb, yb, valid, s1, s2, final_d, final_k, ms, D1, Wp, B, p, ptr,
          score, final_state);
  return cudaGetLastError();
}

template <bool MULTI>
int dispatch(const int8_t* xb, const int8_t* yb, const uint8_t* valid,
             const int32_t* s1, const int32_t* s2, const int32_t* final_d,
             const int32_t* final_k, const MultiSteps& ms, int D1, int Wp,
             int B, const NwScores& p, uint8_t* ptr, float* score,
             int32_t* final_state, void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run<1, MULTI>(xb, yb, valid, s1, s2, final_d, final_k, ms, D1, Wp, B, p, ptr, score, final_state, s);
    case 2: return run<2, MULTI>(xb, yb, valid, s1, s2, final_d, final_k, ms, D1, Wp, B, p, ptr, score, final_state, s);
    case 3: return run<3, MULTI>(xb, yb, valid, s1, s2, final_d, final_k, ms, D1, Wp, B, p, ptr, score, final_state, s);
    case 4: return run<4, MULTI>(xb, yb, valid, s1, s2, final_d, final_k, ms, D1, Wp, B, p, ptr, score, final_state, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code.
extern "C" int banded_nw_launch(const int8_t* xb, const int8_t* yb,
                                const uint8_t* valid, const int32_t* s1,
                                const int32_t* s2, const int32_t* final_d,
                                const int32_t* final_k, int D1, int Wp, int B,
                                float match, float mismatch, float gap_open,
                                float gap_extend, uint8_t* ptr, float* score,
                                int32_t* final_state, void* stream) {
  const NwScores p{match, mismatch, gap_open, gap_extend};
  const MultiSteps none{nullptr, nullptr, nullptr, nullptr};
  return dispatch<false>(xb, yb, valid, s1, s2, final_d, final_k, none, D1,
                         Wp, B, p, ptr, score, final_state, stream);
}

extern "C" int nw_multi_launch(const int8_t* xb, const int8_t* yb,
                               const uint8_t* valid, const int32_t* s1,
                               const int32_t* s2, const int8_t* start,
                               const int32_t* fink, const int32_t* find,
                               int D1, int Wp, int B, float match,
                               float mismatch, float gap_open,
                               float gap_extend, uint8_t* ptr, float* term,
                               void* stream) {
  const NwScores p{match, mismatch, gap_open, gap_extend};
  const MultiSteps ms{start, fink, find, term};
  return dispatch<true>(xb, yb, valid, s1, s2, nullptr, nullptr, ms, D1, Wp,
                        B, p, ptr, nullptr, nullptr, stream);
}

extern "C" const char* marginalign_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
