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
// every cell has a closed form: cell (d, row, lane) has
//   krel = (row - lo(d) mod Wp) mod Wp,  i = lo(d) + krel,  j = d - i,
//   valid = krel < width && i <= m && i <= d && 0 <= j <= n && m + n > 0,
//   es = valid ? Ematch[refs[j - 1], reads[i - 1]] : -1,  yb = reads[i - 1]
// (sequence indices clipped into [0, len - 1], as the host band packer
// clips; yb only when the caller passes a buffer: realignment reads es
// alone), and row 0 of each diagonal also gives the flush row,
//   fr = (d > 0 && lo(d) == lo(d - 1)) ? (lo(d) + width) mod Wp : -1.
// lo is edge-replicated past its D1 packed diagonals.
//
// What bounds it on an H100: per-cell instructions, not bytes.  The first
// design, one thread per cell in a 64-bit grid-stride loop, took 7.07 ms
// at [3072, 24, 4096] (17.9x its 0.394 ms byte bound): three 64-bit
// divisions per cell, lo / m / n reloaded per cell, the 25-float table
// indexed by data in local memory, and two gathers per cell whose 32 lanes
// hit 32 rows of the [len, B] code arrays.  This design: a thread owns one
// lane (threadIdx.x, so each row's es / yb stores are coalesced) and
// E_TILE diagonals (blockIdx.y) and walks their Wp rows with incremental
// indexes (krel steps by one and wraps by a compare; no division in the
// loop).  lo, m and n load once a diagonal / once, the table sits in
// shared memory, and the read and reference codes the tile's band touches
// (at most E_TILE + Wp - 1 positions each, lo stepping by 0 or 1) are
// gathered once into per-lane windows in shared memory, packed four codes
// a word so the per-cell lookups hit one bank per lane.  On the card it
// takes 0.80 ms there (2.0x the byte bound) and 0.55 ms at [128, 24,
// 65536] with yb (1.6x); the windows beat gathers from device memory by
// 1.16-1.27x (kernel_ab.py's probe group).  What is left is ~40 instructions a cell: the lookups'
// addressing, the validity tests, the table lookup and the stores.
//
// R replaces fb_pallas.py `expand_rel_codes` (`_make_expand_rel_kernel`),
// whose delay line shifts a read window up when lo steps and a ref window
// down when it does not, fed by `monotone_gather`.  Here one thread per
// (d, row k, lane) in closed form: i = lo(d) + k, j = d - i,
//   xb = refs[clip(j - 1)],  yb = reads[clip(i - 1)],
// which equals the host packer's xb / yb at every in-band cell (the guide
// Viterbi reads codes only there).  2 B written per cell; it keeps E's
// first design (per-cell divisions and lane-scattered gathers), which
// bounds it as it bounded E.
#include <climits>

#include "common.cuh"

namespace {

struct Ematch {
  float e[25];  // e[ref * 5 + read]
};

constexpr int E_LANES = 128;  // lanes (threads) per block
constexpr int E_TILE = 32;    // diagonals per block

// Shared memory of a block: the table (32 floats), then the read and
// reference windows, wmax / 4 words [word][lane] each.
inline size_t e_smem(int wmax) {
  return (32 + 2 * (size_t)(wmax / 4) * E_LANES) * sizeof(uint32_t);
}

// The window E stages at band width Wp: the E_TILE - 1 + Wp code positions
// a tile's band touches, rounded up to whole words, or 0 (every code from
// device memory) where its shared memory would pass 96 KB (Wp > 350).
inline int e_streams_window(int Wp) {
  const int w = (E_TILE + Wp + 2) & ~3;
  return e_smem(w) <= 96 * 1024 ? w : 0;
}

// Gathers codes src[clip(base + o, 0, cap)][b] for o < n into the lane's
// window (four codes a word, code o in byte o % 4 of word o / 4).
__device__ __forceinline__ void stage_codes(uint32_t* win,
                                            const int8_t* __restrict__ src,
                                            int base, int n, int cap, int b,
                                            int B) {
  for (int o4 = 0; o4 < n; o4 += 4) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = min(max(base + o4 + q, 0), cap);
      word |= (uint32_t)(uint8_t)src[(size_t)p * B + b] << (8 * q);
    }
    win[(o4 >> 2) * E_LANES + threadIdx.x] = word;
  }
}

__device__ __forceinline__ int code_at(const uint32_t* win, int o) {
  return (int)(int8_t)(win[(o >> 2) * E_LANES + threadIdx.x] >> (8 * (o & 3)));
}

// wmax: the window a lane may stage (positions); 0 reads every code from
// device memory, as does a lane whose tile spans more than wmax positions.
__global__ void __launch_bounds__(E_LANES)
    expand_kernel(const int8_t* __restrict__ reads,
                  const int8_t* __restrict__ refs,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ m_arr,
                  const int32_t* __restrict__ n_arr, Ematch E, int D1,
                  int d1k, int Wp, int B, int width, int wmax,
                  float* __restrict__ es, int8_t* __restrict__ yb,
                  int32_t* __restrict__ fr) {
  extern __shared__ uint32_t e_raw[];
  float* tab = reinterpret_cast<float*>(e_raw);
  uint32_t* wy = e_raw + 32;
  uint32_t* wx = wy + (wmax / 4) * E_LANES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 25; ++q) tab[q] = E.e[q];
  }
  __syncthreads();
  const int b = blockIdx.x * E_LANES + threadIdx.x;
  if (b >= B) return;
  const int d0 = blockIdx.y * E_TILE, d1 = min(d0 + E_TILE, d1k);
  const int m = m_arr[b], n = n_arr[b];
  const bool some = m + n > 0;
  const int ycap = max(m - 1, 0), xcap = max(n - 1, 0);
  // The tile's read positions i - 1 lie in [lmin - 1, lmax + Wp - 2], its
  // reference positions j - 1 = d - i - 1 in [gmin - Wp, gmax - 1] for
  // g = d - lo(d).
  int lmin = INT_MAX, lmax = INT_MIN, gmin = INT_MAX, gmax = INT_MIN;
  for (int d = d0; d < d1; ++d) {
    const int l = lo[(size_t)min(d, D1 - 1) * B + b];
    lmin = min(lmin, l);
    lmax = max(lmax, l);
    gmin = min(gmin, d - l);
    gmax = max(gmax, d - l);
  }
  const int ybase = lmin - 1, xbase = gmin - Wp;
  const int ny = lmax - lmin + Wp, nx = gmax - gmin + Wp;
  const bool win = ny <= wmax && nx <= wmax;
  if (win) {
    stage_codes(wy, reads, ybase, ny, ycap, b, B);
    stage_codes(wx, refs, xbase, nx, xcap, b, B);
  }
  int lprev = d0 > 0 ? lo[(size_t)min(d0 - 1, D1 - 1) * B + b] : 0;
  for (int d = d0; d < d1; ++d) {
    const int l = lo[(size_t)min(d, D1 - 1) * B + b];
    fr[(size_t)d * B + b] = d > 0 && l == lprev ? (l + width) % Wp : -1;
    lprev = l;
    int krel = ((-(l % Wp)) % Wp + Wp) % Wp;  // the band-relative row of row 0
    float* esp = es + (size_t)d * Wp * B + b;
    int8_t* ybp = yb ? yb + (size_t)d * Wp * B + b : nullptr;
    for (int r = 0; r < Wp; ++r) {
      const int i = l + krel, j = d - i;
      const bool valid =
          krel < width && i <= m && i <= d && j >= 0 && j <= n && some;
      int y, x;
      if (win) {
        y = code_at(wy, i - 1 - ybase);
        x = code_at(wx, j - 1 - xbase);
      } else {
        y = reads[(size_t)min(max(i - 1, 0), ycap) * B + b];
        x = refs[(size_t)min(max(j - 1, 0), xcap) * B + b];
      }
      *esp = valid ? tab[x * 5 + y] : -1.f;
      esp += B;
      if (ybp) {
        *ybp = (int8_t)y;
        ybp += B;
      }
      if (++krel == Wp) krel = 0;
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
                                     int B, int width, float* es,
                                     int8_t* yb, int32_t* fr, void* stream) {
  if (Mp < 1 || Np < 1 || D1 < 1 || d1k < 1 || Wp < 1 || B < 1)
    return cudaErrorInvalidValue;
  Ematch E;
  for (int k = 0; k < 25; ++k) E.e[k] = ematch[k];
  const int wmax = e_streams_window(Wp);
  const size_t smem = e_smem(wmax);
  cudaError_t err = mk::allow_smem((const void*)expand_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + E_LANES - 1) / E_LANES, (d1k + E_TILE - 1) / E_TILE);
  expand_kernel<<<grid, E_LANES, smem, (cudaStream_t)stream>>>(
      reads, refs, lo, m, n, E, D1, d1k, Wp, B, width, wmax, es, yb, fr);
  return cudaGetLastError();
}

// What E's launches at band width Wp get on this device (mk::kernel_info's
// out[5]).
extern "C" int expand_streams_info(int Wp, int* out) {
  if (Wp < 1) return cudaErrorInvalidValue;
  return mk::kernel_info((const void*)expand_kernel,
                         e_smem(e_streams_window(Wp)), E_LANES, out);
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
