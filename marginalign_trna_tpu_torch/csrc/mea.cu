// Banded maximum-expected-accuracy (AMAP) decode: max-plus over the
// diagonal (posterior match weight), left (ref-skip) and up (read-skip)
// moves, with pointers 0 = diag, 1 = left, 2 = up.
//
// Replaces the TPU kernel marginalign_trna_tpu/ops/wavefront_pallas.py
// `_mea_kernel` (launched by `banded_mea_pallas`).  Same arithmetic: no
// normalisation, circular row shifts, first-max-wins ties in the order
// diag, left, up, and the terminal score read at (final_d, final_k) as
// max(value, NEG).
//
// What bounds it on an H100: it streams 13 B per cell (three f32 weight
// bands and the valid byte in, one pointer byte out) against ~6 adds and
// compares, so at full occupancy it would be bound by device memory; at
// the main path's batch sizes the chain of D1 dependent diagonals, one
// block barrier each, bounds it first.  The design keeps the score
// frontier (three generations, d mod 3) in shared memory and fetches the
// next diagonal's weights while the current one computes.
#include "common.cuh"

namespace {

using mk::NEG;

template <int RPT>
__global__ void __launch_bounds__(1024)
    mea_kernel(const float* __restrict__ wdiag, const float* __restrict__ wup,
               const float* __restrict__ wleft,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ s1, const int32_t* __restrict__ s2,
               const int32_t* __restrict__ final_d,
               const int32_t* __restrict__ final_k, int D1, int Wp, int B,
               uint8_t* __restrict__ ptr, float* __restrict__ score) {
  extern __shared__ float shA[];  // [3][Wp][L] score generations by d mod 3
  const int L = blockDim.x, TY = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * L + lane;
  const bool live = b < B;
  const int plane = Wp * L;
  const int fd = live ? final_d[b] : -1;
  const int fk = live ? final_k[b] : -1;

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
    if (k >= Wp) continue;
    const int i = k * L + lane;
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
  int f1 = 0, f2 = 0;
  auto fetch = [&](int d) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      fd_w[r] = 0.f; fu_w[r] = 0.f; fl_w[r] = 0.f; fv[r] = 0;
      if (live && k < Wp) {
        const size_t c = mk::cell(d, k, b, Wp, B);
        fd_w[r] = wdiag[c]; fu_w[r] = wup[c]; fl_w[r] = wleft[c];
        fv[r] = valid[c];
      }
    }
    f1 = live ? s1[(size_t)d * B + b] : 0;
    f2 = live ? s2[(size_t)d * B + b] : 0;
  };
  if (D1 > 1) fetch(1);
  __syncthreads();

  for (int d = 1; d < D1; ++d) {
    float cd[RPT], cu[RPT], cl[RPT];
    uint8_t cv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      cd[r] = fd_w[r]; cu[r] = fu_w[r]; cl[r] = fl_w[r]; cv[r] = fv[r];
    }
    const int t1 = f1, t2 = f2;
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
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = ty + r * TY;
      if (k >= Wp) continue;
      shA[now + k * L + lane] = na[r];
      if (live) {
        ptr[mk::cell(d, k, b, Wp, B)] = np[r];
        if (d == fd && k == fk) score[b] = fmaxf(na[r], NEG);
      }
    }
    __syncthreads();
  }
}

template <int RPT>
cudaError_t run(const float* wdiag, const float* wup, const float* wleft,
                const uint8_t* valid, const int32_t* s1, const int32_t* s2,
                const int32_t* final_d, const int32_t* final_k, int D1,
                int Wp, int B, uint8_t* ptr, float* score,
                cudaStream_t stream) {
  const size_t smem = (size_t)3 * Wp * mk::LANES * sizeof(float);
  cudaError_t err = mk::allow_smem((const void*)mea_kernel<RPT>, smem);
  if (err != cudaSuccess) return err;
  mea_kernel<RPT><<<mk::grid_shape(B), mk::block_shape(Wp), smem, stream>>>(
      wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B, ptr,
      score);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code.
extern "C" int banded_mea_launch(const float* wdiag, const float* wup,
                                 const float* wleft, const uint8_t* valid,
                                 const int32_t* s1, const int32_t* s2,
                                 const int32_t* final_d,
                                 const int32_t* final_k, int D1, int Wp,
                                 int B, uint8_t* ptr, float* score,
                                 void* stream) {
  if (D1 < 1 || B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mk::rows_per_thread(Wp)) {
    case 1: return run<1>(wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B, ptr, score, s);
    case 2: return run<2>(wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B, ptr, score, s);
    case 3: return run<3>(wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B, ptr, score, s);
    case 4: return run<4>(wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B, ptr, score, s);
    default: return cudaErrorInvalidValue;
  }
}
