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
// down when it does not, fed by `monotone_gather`.  Its closed form: row k
// of diagonal d holds i = lo(d) + k, j = d - i,
//   xb = refs[clip(j - 1)],  yb = reads[clip(i - 1)],
// which equals the host packer's xb / yb at every in-band cell (the guide
// Viterbi reads codes only there) and the plain version on every cell.
//
// What bounds R on an H100: the 2 B a cell it writes.  The first design
// (one thread per cell, three 64-bit divisions a cell, lane-scattered
// gathers) took 2.04 ms at [7168, 48, 1024], 9.2x its 0.221 ms byte
// bound.  This design (section "R" below) takes 0.39 ms there (1.8x):
// without its stores it takes 0.15 ms (kernel_ab.py's probe group), so
// its 704 MB leave at ~1.8 TB/s.  Its code windows beat direct loads
// 1.6x, and one 32-bit store of four lanes a row beats four byte stores
// 1.3-1.5x; tiles of 16 or 64 diagonals and blocks of 32 or 128 threads
// move it by under 7%.
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

// ------------------------------------------------------------------ R
//
// A thread owns R_GROUP = 4 consecutive lanes and a block's R_TILE
// diagonals.  Row k of diagonal d reads the read code at position
// lo(d) + k - 1 and the reference code at d - lo(d) - k - 1, so a lane's
// rows are a run of consecutive positions of each sequence, ascending
// for the reads and descending for the reference.  The codes the tile
// touches (at most R_TILE - 1 + Wp positions a sequence while lo steps by
// 0 or 1) are staged once per lane into windows in shared memory, packed
// four codes a word, the reference window in descending order: then the
// codes of rows k .. k + 3 of a lane are one funnel shift of two window
// words, and a byte transpose of the thread's four lanes gives each of the
// four rows as one 32-bit store of four lanes' bytes (R_PACK; byte stores
// where B % 4 != 0).  A thread's lanes whose windows would pass the cap
// (lo jumping) read every code from device memory instead.  The windows
// are [stream][lane of the thread][word][thread], so a warp's window
// reads hit 32 banks whatever the lanes' offsets.
constexpr int R_GROUP = 4;     // lanes a thread
constexpr int R_THREADS = 64;  // threads a block
constexpr int R_TILE = 32;     // diagonals a block
constexpr bool R_PACK = true;  // rows of four lanes as one 32-bit store

// Window words a lane needs for a tile whose rows start within `spread`
// codes of the window's first: rows are read four at a time, each group
// from two words (Wp rounded up to 4 rows).
__host__ __device__ inline int rel_words(int spread, int Wp) {
  return (spread >> 2) + ((Wp + 3) >> 2) + 1;
}
inline size_t rel_smem(int nw) {
  return (size_t)2 * R_GROUP * nw * R_THREADS * sizeof(uint32_t);
}
// The window words R stages at band width Wp (a tile whose lo steps by 0
// or 1), or 0 (every code from device memory) where its shared memory
// would pass 96 KB (Wp > 160).
inline int rel_window_words(int Wp) {
  const int nw = rel_words(R_TILE - 1, Wp);
  return rel_smem(nw) <= 96 * 1024 ? nw : 0;
}

// Gathers src[clip(base + dir * o, 0, cap)][b] for o < 4 n into the
// window words win[w * R_THREADS] (code o in byte o % 4 of word o / 4).
__device__ __forceinline__ void rel_stage(uint32_t* win,
                                          const int8_t* __restrict__ src,
                                          int base, int dir, int n, int cap,
                                          int b, int B) {
#pragma unroll 4
  for (int w = 0; w < n; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = min(max(base + dir * (4 * w + i), 0), cap);
      word |= (uint32_t)(uint8_t)src[(size_t)p * B + b] << (8 * i);
    }
    win[w * R_THREADS] = word;
  }
}

// z[r] byte q = a[q] byte r: four rows of four lanes into four lanes of
// four rows.
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4],
                                           uint32_t (&z)[4]) {
  const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
  z[0] = __byte_perm(lo01, lo23, 0x5410);
  z[1] = __byte_perm(lo01, lo23, 0x7632);
  z[2] = __byte_perm(hi01, hi23, 0x5410);
  z[3] = __byte_perm(hi01, hi23, 0x7632);
}

// nw: the window words a lane may stage (0: every code from device
// memory); vec: B % 4 == 0 and lo, xb, yb aligned for 16- and 4-byte
// accesses.
__global__ void __launch_bounds__(R_THREADS)
    expand_rel_kernel(const int8_t* __restrict__ reads,
                      const int8_t* __restrict__ refs,
                      const int32_t* __restrict__ lo,
                      const int32_t* __restrict__ m_arr,
                      const int32_t* __restrict__ n_arr, int D1, int d1k,
                      int Wp, int B, int nw, int vec,
                      int8_t* __restrict__ xb, int8_t* __restrict__ yb) {
  extern __shared__ uint32_t r_raw[];
  const int g0 = (blockIdx.x * R_THREADS + threadIdx.x) * R_GROUP;
  if (g0 >= B) return;
  const int d0 = blockIdx.y * R_TILE, d1 = min(d0 + R_TILE, d1k);
  // Lanes past B read lane B - 1 and store nothing.
  int bq[R_GROUP], ycap[R_GROUP], xcap[R_GROUP];
#pragma unroll
  for (int q = 0; q < R_GROUP; ++q) {
    bq[q] = min(g0 + q, B - 1);
    ycap[q] = max(m_arr[bq[q]] - 1, 0);
    xcap[q] = max(n_arr[bq[q]] - 1, 0);
  }
  auto lo_at = [&](int d, int (&l)[R_GROUP]) {
    const int32_t* row = lo + (size_t)min(d, D1 - 1) * B;
    if (vec) {
      const int4 v = *reinterpret_cast<const int4*>(row + g0);
      l[0] = v.x;
      l[1] = v.y;
      l[2] = v.z;
      l[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < R_GROUP; ++q) l[q] = row[bq[q]];
    }
  };
  // The tile's read positions lie in [lmin - 1, lmax + Wp - 2], its
  // reference positions in [gmin - Wp, gmax - 1] for g = d - lo(d).
  int l[R_GROUP], lmin[R_GROUP], gmax[R_GROUP], ny[R_GROUP], nx[R_GROUP];
  lo_at(d0, l);
#pragma unroll
  for (int q = 0; q < R_GROUP; ++q) {
    lmin[q] = ny[q] = l[q];
    gmax[q] = nx[q] = d0 - l[q];
  }
  for (int d = d0 + 1; d < d1; ++d) {
    lo_at(d, l);
#pragma unroll
    for (int q = 0; q < R_GROUP; ++q) {
      lmin[q] = min(lmin[q], l[q]);
      ny[q] = max(ny[q], l[q]);
      gmax[q] = max(gmax[q], d - l[q]);
      nx[q] = min(nx[q], d - l[q]);
    }
  }
  bool win = nw > 0;
#pragma unroll
  for (int q = 0; q < R_GROUP; ++q) {
    ny[q] = rel_words(ny[q] - lmin[q], Wp);
    nx[q] = rel_words(gmax[q] - nx[q], Wp);
    win = win & (ny[q] <= nw) & (nx[q] <= nw);
  }
  // Window word w of lane q: wy[(q * nw + w) * R_THREADS], wx likewise.
  const uint32_t* wy = r_raw + threadIdx.x;
  const uint32_t* wx = wy + R_GROUP * nw * R_THREADS;
  if (win) {
#pragma unroll
    for (int q = 0; q < R_GROUP; ++q) {
      rel_stage(r_raw + q * nw * R_THREADS + threadIdx.x, reads, lmin[q] - 1,
                1, ny[q], ycap[q], bq[q], B);
      rel_stage(r_raw + (R_GROUP + q) * nw * R_THREADS + threadIdx.x, refs,
                gmax[q] - 1, -1, nx[q], xcap[q], bq[q], B);
    }
  }
  // Rows k .. k + 3 of the thread's lanes (Y, X: a lane's four codes a
  // word) leave as four rows of four lanes.
  auto emit = [&](int8_t* yrow, int8_t* xrow, int k, const uint32_t (&Y)[4],
                  const uint32_t (&X)[4]) {
    if (R_PACK && vec) {
      uint32_t zy[4], zx[4];
      transpose4(Y, zy);
      transpose4(X, zx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k + r < Wp) {
          *reinterpret_cast<uint32_t*>(yrow + (size_t)(k + r) * B) = zy[r];
          *reinterpret_cast<uint32_t*>(xrow + (size_t)(k + r) * B) = zx[r];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k + r >= Wp) continue;
#pragma unroll
        for (int q = 0; q < R_GROUP; ++q) {
          if (g0 + q >= B) continue;
          yrow[(size_t)(k + r) * B + q] = (int8_t)(Y[q] >> (8 * r));
          xrow[(size_t)(k + r) * B + q] = (int8_t)(X[q] >> (8 * r));
        }
      }
    }
  };
  for (int d = d0; d < d1; ++d) {
    lo_at(d, l);
    int8_t* yrow = yb + (size_t)d * Wp * B + g0;
    int8_t* xrow = xb + (size_t)d * Wp * B + g0;
    uint32_t Y[4], X[4];
    if (win) {
      // Lane q's rows start at window code oy = lo - lmin (reads) and
      // ox = gmax - (d - lo) (reference): word o / 4, shift 8 (o % 4).
      int iy[R_GROUP], sy[R_GROUP], ix[R_GROUP], sx[R_GROUP];
      uint32_t cy[R_GROUP], cx[R_GROUP];
#pragma unroll
      for (int q = 0; q < R_GROUP; ++q) {
        const int oy = l[q] - lmin[q], ox = gmax[q] - (d - l[q]);
        iy[q] = (q * nw + (oy >> 2)) * R_THREADS;
        sy[q] = 8 * (oy & 3);
        ix[q] = (q * nw + (ox >> 2)) * R_THREADS;
        sx[q] = 8 * (ox & 3);
        cy[q] = wy[iy[q]];
        cx[q] = wx[ix[q]];
      }
      for (int k = 0; k < Wp; k += 4) {
#pragma unroll
        for (int q = 0; q < R_GROUP; ++q) {
          iy[q] += R_THREADS;
          ix[q] += R_THREADS;
          const uint32_t ny_ = wy[iy[q]], nx_ = wx[ix[q]];
          Y[q] = __funnelshift_r(cy[q], ny_, sy[q]);
          X[q] = __funnelshift_r(cx[q], nx_, sx[q]);
          cy[q] = ny_;
          cx[q] = nx_;
        }
        emit(yrow, xrow, k, Y, X);
      }
    } else {
      for (int k = 0; k < Wp; k += 4) {
#pragma unroll
        for (int q = 0; q < R_GROUP; ++q) {
          Y[q] = X[q] = 0;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = l[q] + k + r;
            const int yi = min(max(i - 1, 0), ycap[q]);
            const int xj = min(max(d - i - 1, 0), xcap[q]);
            Y[q] |= (uint32_t)(uint8_t)reads[(size_t)yi * B + bq[q]]
                    << (8 * r);
            X[q] |= (uint32_t)(uint8_t)refs[(size_t)xj * B + bq[q]]
                    << (8 * r);
          }
        }
        emit(yrow, xrow, k, Y, X);
      }
    }
  }
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
  const int nw = rel_window_words(Wp);
  const size_t smem = rel_smem(nw);
  cudaError_t err = mk::allow_smem((const void*)expand_rel_kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = mk::words_aligned(B, {xb, yb}) &&
                  reinterpret_cast<uintptr_t>(lo) % 16 == 0;
  const dim3 grid((B + R_GROUP * R_THREADS - 1) / (R_GROUP * R_THREADS),
                  (d1k + R_TILE - 1) / R_TILE);
  expand_rel_kernel<<<grid, R_THREADS, smem, (cudaStream_t)stream>>>(
      reads, refs, lo, m, n, D1, d1k, Wp, B, nw, vec, xb, yb);
  return cudaGetLastError();
}

// What R's launches at band width Wp get on this device (mk::kernel_info's
// out[5]).
extern "C" int expand_rel_info(int Wp, int* out) {
  if (Wp < 1) return cudaErrorInvalidValue;
  return mk::kernel_info((const void*)expand_rel_kernel,
                         rel_smem(rel_window_words(Wp)), R_THREADS, out);
}
