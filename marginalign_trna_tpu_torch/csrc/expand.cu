// Expansion of band streams from packed sequences and band offsets: the
// circular-layout streams of the pair-HMM passes (expand_streams, E) and
// the band-relative code bands of the guide Viterbi (expand_rel, R).
//
// E:
// Replaces the TPU kernel marginalign_trna_tpu/ops/fb_pallas.py
// `_expand_streams` (`_make_expand_kernel`) together with the
// marginalign_trna_tpu/ops/bucket_scatter.py `monotone_gather` calls that
// feed it.  On the TPU per-lane gathers scalarise, so the Pallas kernel
// keeps sliding code windows in a delay line fed by monotone gathers.  Here
// every cell is independent: one thread per (d, row, lane) computes
//   krel = (row - lo(d) mod Wp) mod Wp,  i = lo(d) + krel,  j = d - i,
//   valid = krel < width && i <= m && i <= d && 0 <= j <= n && m + n > 0,
//   es = valid ? Ematch[refs[j - 1], reads[i - 1]] : -1,  yb = reads[i - 1]
// (sequence indices clipped into [0, len - 1], as the host band packer
// clips; yb only when the caller passes a buffer: realignment reads es
// alone), and the row-0 threads write the flush row of each diagonal,
//   fr = (d > 0 && lo(d) == lo(d - 1)) ? (lo(d) + width) mod Wp : -1.
// lo is edge-replicated past its D1 packed diagonals.
//
// What bounds it on an H100: bytes.  Per cell it writes 5 B (es, yb) and
// reads two codes that neighbouring lanes hold in neighbouring bytes of the
// [len, B] packed arrays (at lane-dependent rows, so the loads coalesce only
// partly); the arithmetic is a few integer operations.  The design is one
// pass, lanes fastest, so the stores coalesce.
//
// R replaces fb_pallas.py `expand_rel_codes` (`_make_expand_rel_kernel`),
// whose delay line shifts a read window up when lo steps and a ref window
// down when it does not, fed by `monotone_gather`.  Here, again, one thread
// per (d, row k, lane) in closed form: i = lo(d) + k, j = d - i,
//   xb = refs[clip(j - 1)],  yb = reads[clip(i - 1)],
// which equals the host packer's xb / yb at every in-band cell (the guide
// Viterbi reads codes only there).  Bound by bytes like E: 2 B written per
// cell, two partly coalesced code loads.
#include "common.cuh"

namespace {

struct Ematch {
  float e[25];  // e[ref * 5 + read]
};

__global__ void expand_kernel(const int8_t* __restrict__ reads,
                              const int8_t* __restrict__ refs,
                              const int32_t* __restrict__ lo,
                              const int32_t* __restrict__ m_arr,
                              const int32_t* __restrict__ n_arr, Ematch E,
                              int D1, int d1k, int Wp, int B, int width,
                              float* __restrict__ es, int8_t* __restrict__ yb,
                              int32_t* __restrict__ fr) {
  const size_t total = (size_t)d1k * Wp * B;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(idx % B);
    const int r = (int)((idx / B) % Wp);
    const int d = (int)(idx / ((size_t)B * Wp));
    const int lo_d = lo[(size_t)min(d, D1 - 1) * B + b];
    const int m = m_arr[b], n = n_arr[b];
    const int krel = ((r - lo_d % Wp) % Wp + Wp) % Wp;
    const int i = lo_d + krel;
    const int j = d - i;
    const bool valid = krel < width && i <= m && i <= d && j >= 0 && j <= n &&
                       m + n > 0;
    const int yi = min(max(i - 1, 0), max(m - 1, 0));
    const int xj = min(max(j - 1, 0), max(n - 1, 0));
    const int8_t y = reads[(size_t)yi * B + b];
    const int8_t x = refs[(size_t)xj * B + b];
    es[idx] = valid ? E.e[x * 5 + y] : -1.f;
    if (yb) yb[idx] = y;
    if (r == 0) {
      const bool stepped =
          d > 0 && lo_d == lo[(size_t)min(d - 1, D1 - 1) * B + b];
      fr[(size_t)d * B + b] = stepped ? (lo_d + width) % Wp : -1;
    }
  }
}

__global__ void expand_rel_kernel(const int8_t* __restrict__ reads,
                                  const int8_t* __restrict__ refs,
                                  const int32_t* __restrict__ lo,
                                  const int32_t* __restrict__ m_arr,
                                  const int32_t* __restrict__ n_arr, int D1,
                                  int d1k, int Wp, int B,
                                  int8_t* __restrict__ xb,
                                  int8_t* __restrict__ yb) {
  const size_t total = (size_t)d1k * Wp * B;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(idx % B);
    const int k = (int)((idx / B) % Wp);
    const int d = (int)(idx / ((size_t)B * Wp));
    const int i = lo[(size_t)min(d, D1 - 1) * B + b] + k;
    const int j = d - i;
    const int m = m_arr[b], n = n_arr[b];
    const int yi = min(max(i - 1, 0), max(m - 1, 0));
    const int xj = min(max(j - 1, 0), max(n - 1, 0));
    yb[idx] = reads[(size_t)yi * B + b];
    xb[idx] = refs[(size_t)xj * B + b];
  }
}

// Blocks of 256 threads over `total` cells, at most 65535 * 16 blocks (the
// kernels stride over the rest).
inline int grid_for(size_t total) {
  const size_t want = (total + 255) / 256;
  return (int)(want < 65535 * 16 ? want : 65535 * 16);
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns a cudaError_t
// code.  `ematch` is a HOST pointer to the 25 floats Ematch[ref][read];
// device pointers for everything else (`yb` of expand_streams may be null).
extern "C" int expand_streams_launch(const int8_t* reads, const int8_t* refs,
                                     const int32_t* lo, const int32_t* m,
                                     const int32_t* n, const float* ematch,
                                     int Mp, int Np, int D1, int d1k, int Wp,
                                     int B, int width, float* es, int8_t* yb,
                                     int32_t* fr, void* stream) {
  if (Mp < 1 || Np < 1 || D1 < 1 || d1k < 1 || Wp < 1 || B < 1)
    return cudaErrorInvalidValue;
  Ematch E;
  for (int k = 0; k < 25; ++k) E.e[k] = ematch[k];
  expand_kernel<<<grid_for((size_t)d1k * Wp * B), 256, 0,
                  (cudaStream_t)stream>>>(reads, refs, lo, m, n, E, D1, d1k,
                                          Wp, B, width, es, yb, fr);
  return cudaGetLastError();
}

extern "C" int expand_rel_launch(const int8_t* reads, const int8_t* refs,
                                 const int32_t* lo, const int32_t* m,
                                 const int32_t* n, int Mp, int Np, int D1,
                                 int d1k, int Wp, int B, int8_t* xb,
                                 int8_t* yb, void* stream) {
  if (Mp < 1 || Np < 1 || D1 < 1 || d1k < 1 || Wp < 1 || B < 1)
    return cudaErrorInvalidValue;
  expand_rel_kernel<<<grid_for((size_t)d1k * Wp * B), 256, 0,
                      (cudaStream_t)stream>>>(reads, refs, lo, m, n, D1, d1k,
                                              Wp, B, xb, yb);
  return cudaGetLastError();
}
