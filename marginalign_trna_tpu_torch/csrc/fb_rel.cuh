// The warp-per-lane machinery of the flat-gap forward-backward kernels:
// the REL pair K2 / K3 (csrc/fb.cu) and the multi-lane pair
// (csrc/fb_multi.cu), each file taking its own copy.
//
// What bounds them on an H100: per cell the backwards stream 5 B (K2) or
// 9 B (multi) in and 4 B out, the forwards 9 B (K3) or 5 B (multi) in and
// 4 B out, plus 8-20 B a lane and diagonal of records, against ~30-56
// operations, so a full card would be memory bound; each lane's chain of
// D1 dependent diagonals bounds them first.  All four run one warp per
// lane (common.cuh's warp-per-lane layout, as S, M, K1 and K4):
// ceil(Wp / 32) consecutive band rows a thread (mk::WarpRows), the
// frontier and what the next diagonals read of it in registers (the
// backwards: the gap states of d+1 and e_M * b_M of d+1 and d+2; the
// forwards: the gap mixes of d-1 and the match mixes of d-1 and d-2).  A
// band shift by s1 or s2 is the same for every row of a lane (the band
// wrapping at Wp, as the plain versions' `shift` wraps), so at one row a
// thread each of the five reads of the previous generations is one
// shuffle from the lane holding the row it reads (`RelLane::move`), at
// more rows one shuffle of the edge row (mk::WarpRows).  The rescale's
// band max is a warp reduction.  No block barrier on a diagonal: a block
// of 8 or 16 lanes (`rel_lanes`: 16 where B >= 16 x SMs) stages a tile of
// diagonals (16 at one row a thread, else 8: whole rescale periods, the
// backwards walking them downwards and rescaling at each period's low
// end, the forwards upwards and at its high end, so a whole tile runs
// unrolled with its rescale and division steps known) while it computes
// the previous one, and the band it writes leaves through a shared-memory
// tile as lane-contiguous rows, its per-diagonal scalars (K2: bls; multi
// forward: lsf, term) as per-lane records after them: one barrier a
// tile.  The float bands (em; K3 also bm, the multi backward also fm) come
// by the tensor memory accelerator where B % 4 == 0 and Wp <= 64
// (`rel_tma`: K4 found that cp.async's 4-byte copies bound it, and TMA
// slower above Wp 64), else by cp.async; valid (and the multi forward's
// start flags) as byte tiles and the per-lane streams (s1; K3 bls; the
// multi pair fink, and the backward find, lsf and L) as records [LPB][kt]
// by cp.async.  Problem starts and terminals are flags read inside the
// unrolled tile, so the tile's diagonal index stays a constant.
//
// Scaling follows the TPU kernels: rescale by the band max every 8
// diagonals of the lane (backward at d % 8 == 0, forward at d % 8 == 7), a
// step with no mass uses factor 1, and the d-2 term is divided by the
// previous factor on the diagonal after a rescale.  Built without
// multiply-add contraction (-fmad=false) and with the plain versions'
// order of operations, the kernels round like the plain versions, bit for
// bit: the posterior's exp(ls + bls - logZ) factor turns one ulp of a
// ~5000-sized log-scale (4.9e-4) into the same relative error, so
// differently rounded scalings would disagree by more than the 2e-4
// posterior tolerance on kilobase segments.
#pragma once

#include <string.h>

#include "common.cuh"

namespace {

// Diagonals a tile at rpt band rows a thread: 16 at one row (every path's
// Wp 24: fewer block barriers; kernel_ab.py's probe_rel), 8 for wider
// bands; whole rescale periods either way.
__host__ __device__ constexpr int rel_kt(int rpt) { return rpt == 1 ? 16 : 8; }
static_assert(rel_kt(1) % 8 == 0 && rel_kt(2) % 8 == 0,
              "tiles hold whole rescale periods");
constexpr int REL_STAGES = 2;  // input tiles: the one computed, 1 in flight

// The kernels (fb.cu: K2, K3; fb_multi.cu: MF, MB), and what a stage
// buffer and an output tile of each hold: rel_np float bands and rel_nr
// 4-byte per-lane records [LPB][kt] in (the start flags too as a byte tile
// where rel_st), the band rows and rel_no 4-byte records [LPB][kt] out.
enum RelKind : int {
  REL_K2,  // em; s1 | bm; bls
  REL_K3,  // em, bm; s1, bls | post
  REL_MF,  // em; s1, fink; start | fm; lsf, term
  REL_MB,  // em, fm; s1, fink, find, lsf, L | post
};
__host__ __device__ constexpr int rel_np(int kind) {
  return kind == REL_K3 || kind == REL_MB ? 2 : 1;
}
__host__ __device__ constexpr int rel_nr(int kind) {
  return kind == REL_K2 ? 1 : (kind == REL_MB ? 5 : 2);
}
__host__ __device__ constexpr bool rel_st(int kind) { return kind == REL_MF; }
__host__ __device__ constexpr int rel_no(int kind) {
  return kind == REL_K2 ? 1 : (kind == REL_MF ? 2 : 0);
}

// A stage buffer holds a tile's inputs for the block's LPB lanes: the
// float planes, the per-lane records [rel_nr][LPB][kt], valid as a byte
// tile (mk::byte_stride's layout), then the start flags as one [kt] (MF).
// A plane is, with TMA, the box [kt][Wp][LPB] as the map copies it
// (mk::swizzled; its floats rounded up to 256, so that planes stay
// 1024-byte aligned), else lane w's row k of tile diagonal kb at
// w * rel_stride + kb * Wp + k (an odd stride, so that the copies, which
// move LPB lanes of one row, hit LPB banks).  An output tile holds lane
// w's rows at the cp.async offsets, then its records [rel_no][LPB][kt].
struct RelIn {
  float* p;
  int32_t* r;
  uint8_t* v;
  uint8_t* st;
};

__host__ __device__ inline int rel_stride(int Wp, int kt) {
  return kt * Wp + 1;
}
__host__ __device__ inline size_t rel_plane(int Wp, int kt, int lpb,
                                            bool tma) {
  return tma ? ((size_t)kt * Wp * lpb + 255) / 256 * 256
             : (size_t)lpb * rel_stride(Wp, kt);
}
// Bytes of a stage buffer of kernel `kind`, rounded up to 1024 with TMA,
// else to 16.
__host__ __device__ inline size_t rel_in_bytes(int kind, int Wp, int kt,
                                               int lpb, bool tma) {
  const size_t a = tma ? 1024 : 16;
  const size_t b = (rel_np(kind) * rel_plane(Wp, kt, lpb, tma) +
                    (size_t)rel_nr(kind) * lpb * kt) * 4 +
                   (size_t)(kt * Wp + (rel_st(kind) ? kt : 0)) *
                       mk::byte_stride(lpb);
  return (b + a - 1) / a * a;
}
__host__ __device__ inline size_t rel_out_bytes(int kind, int Wp, int kt,
                                                int lpb) {
  return ((size_t)lpb * (rel_stride(Wp, kt) + rel_no(kind) * kt) * 4 + 15) /
         16 * 16;
}
// REL_STAGES stage buffers and two output tiles; with TMA 1024 bytes to
// align the stages and the stages' barriers.
inline size_t rel_smem(int kind, int Wp, int lpb, bool tma) {
  const int kt = rel_kt(mk::rows_per_thread(Wp));
  return (tma ? 1024 + 8 * REL_STAGES : 0) +
         REL_STAGES * rel_in_bytes(kind, Wp, kt, lpb, tma) +
         2 * rel_out_bytes(kind, Wp, kt, lpb);
}

__device__ inline RelIn rel_in(uint8_t* p, int kind, int Wp, int kt,
                               int lpb, bool tma) {
  float* planes = reinterpret_cast<float*>(p);
  int32_t* r = reinterpret_cast<int32_t*>(
      planes + rel_np(kind) * rel_plane(Wp, kt, lpb, tma));
  uint8_t* v = reinterpret_cast<uint8_t*>(r + rel_nr(kind) * lpb * kt);
  return RelIn{planes, r, v, v + kt * Wp * mk::byte_stride(lpb)};
}

// The float bands' tensor maps (K2: em; K3: em, bm; MF: em; MB: em, fm;
// unused by cp.async).
struct RelMaps {
  CUtensorMap m[2];
};

// Starts the copy of diagonals d0 .. d0 + n - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into stage buffer S (the caller commits the cp.async
// group): the NP float bands (TMA: thread 0 asks for their boxes, to land
// on barrier bar; cp.async: thread tid copies lane tid % LPB of rows
// tid / LPB + 32 i, so a warp moves 32 / LPB rows of LPB lanes a step),
// the NR per-lane record streams [D1, B], the valid bytes and, unless it
// is null, the start flags.
template <int NP, int NR, int LPB, int KT, bool TMA>
__device__ __forceinline__ void rel_stage(
    const RelIn& S, const float* const (&band)[NP],
    const void* const (&rec)[NR], const RelMaps& maps, uint64_t* bar,
    const uint8_t* __restrict__ valid, const int8_t* __restrict__ start,
    int d0, int n, int b0, int Wp, int B, bool vec) {
  const int l = threadIdx.x % LPB, b = b0 + l;
  const size_t plane = rel_plane(Wp, KT, LPB, TMA);
  if (TMA) {
    if (threadIdx.x == 0) {
      mk::tma_expect(bar, NP * KT * Wp * LPB * 4u);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::tma_load(S.p + q * plane, &maps.m[q], b0, 0, d0, bar);
    }
  } else if (b < B) {
    const size_t g = (size_t)d0 * Wp * B + b;
    float* s = S.p + l * rel_stride(Wp, KT);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::cp_async4(s + q * plane + r, band[q] + g + (size_t)r * B);
  }
  const int kb = threadIdx.x / LPB;  // the tile diagonal of its records
  if (kb < n && b < B) {
    const size_t o = (size_t)(d0 + kb) * B + b;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      mk::cp_async4(S.r + (i * LPB + l) * KT + kb,
                    static_cast<const int32_t*>(rec[i]) + o);
  }
  mk::stage_bytes<LPB>(S.v, valid, (size_t)d0 * Wp, n * Wp, b0, B, vec);
  if (start != nullptr) mk::stage_bytes<LPB>(S.st, start, d0, n, b0, B, vec);
}

// Writes the rows of output tile O (diagonals d0 .. d0 + n - 1 of the
// block's lanes) to dst in rel_stage's order, and its records 0 and 1 to
// r0 and r1 unless they are null.
template <int LPB, int KT>
__device__ __forceinline__ void rel_flush(const float* O, int d0, int n,
                                          int b0, int Wp, int B,
                                          float* __restrict__ dst,
                                          float* __restrict__ r0,
                                          float* __restrict__ r1) {
  const int l = threadIdx.x % LPB, b = b0 + l;
  if (b >= B) return;
  const size_t g = (size_t)d0 * Wp * B + b;
  const float* s = O + l * rel_stride(Wp, KT);
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
    dst[g + (size_t)r * B] = s[r];
  const int kb = threadIdx.x / LPB;
  const float* rec = O + LPB * rel_stride(Wp, KT) + l * KT + kb;
  if (r0 != nullptr && kb < n) r0[(size_t)(d0 + kb) * B + b] = rec[0];
  if (r1 != nullptr && kb < n) r1[(size_t)(d0 + kb) * B + b] = rec[LPB * KT];
}

// Lane w's band rows (mk::WarpRows: row k = RPT kk + r on thread kk), where
// its cells lie in a stage buffer, and the band's row moves.
template <int RPT, int LPB, bool TMA>
struct RelLane {
  static constexpr int KT = rel_kt(RPT), SB = mk::byte_stride(LPB);
  mk::WarpRows<RPT> rows;
  int Wp, w;
  size_t plane;
  // A row's plane offset at each tile diagonal (TMA: swizzled) or at
  // diagonal 0 (cp.async: a diagonal adds Wp), its valid byte's at
  // diagonal 0 (a diagonal adds Wp SB); rows past the band read row
  // Wp - 1 (their results are never used).  The TMA offsets stay in
  // registers only while every read names its diagonal by a constant (the
  // unrolled tiles: `at<true>`); a partial tile computes them.
  int off[TMA ? KT : 1][RPT], voff[RPT];

  __device__ RelLane(int Wp_, int w_)
      : rows(Wp_), Wp(Wp_), w(w_), plane(rel_plane(Wp_, KT, LPB, TMA)) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = min(row(r), Wp - 1);
      voff[r] = k * SB + w;
      if (TMA) {
#pragma unroll
        for (int kb = 0; kb < (TMA ? KT : 1); ++kb)
          off[kb][r] = mk::swizzled<LPB>(kb * Wp + k, w);
      } else {
        off[0][r] = w * rel_stride(Wp, KT) + k;
      }
    }
  }

  __device__ int row(int r) const { return rows.row(r); }
  template <bool FIXED>
  __device__ int at(int kb, int r) const {
    if constexpr (!TMA) return off[0][r] + kb * Wp;
    else if constexpr (FIXED) return off[kb][r];
    else return mk::swizzled<LPB>(kb * Wp + min(row(r), Wp - 1), w);
  }
  __device__ float valid(const RelIn& S, int kb, int r) const {
    return S.v[voff[r] + kb * Wp * SB] != 0 ? 1.f : 0.f;
  }
  // Record i at tile diagonal kb, as an int or as a float.
  __device__ int irec(const RelIn& S, int i, int kb) const {
    return S.r[(i * LPB + w) * KT + kb];
  }
  __device__ float frec(const RelIn& S, int i, int kb) const {
    return __int_as_float(irec(S, i, kb));
  }
  // Whether a problem starts at tile diagonal kb (the start byte tile).
  __device__ bool starts(const RelIn& S, int kb) const {
    return S.st[kb * SB + w] != 0;
  }

  // The lane holding row k + t at one row a thread (row k for t other
  // than +-1) by two PTX selects, as `move<true>` takes it.
  __device__ __forceinline__ int src(int t) const {
    int s;
    asm("{\n .reg .pred up, dn;\n .reg .s32 x;\n"
        " setp.eq.s32 up, %1, 1;\n setp.eq.s32 dn, %1, -1;\n"
        " selp.s32 x, %2, %3, up;\n selp.s32 %0, %4, x, dn;\n}"
        : "=r"(s)
        : "r"(t), "r"(rows.up_src), "r"(rows.kk), "r"(rows.dn_src));
    return s;
  }

  // out = v at row k + t, the plain versions' `shift`: t = +-1 moves the
  // band one row (wrapping at Wp), any other t leaves it in place.  The
  // move is the same for the warp's rows; at one row a thread it is one
  // shuffle from the lane holding row k + t, chosen by ?: or (SELP) by
  // `src`: nvcc compiled the ?: in the multi forward into a branch around
  // each shuffle (a BSSY / BSYNC pair and ~8 more instructions a move,
  // 0.89 against 0.64 ms at the multi batch), and `src` in K2 cost 2.6%.
  template <bool SELP = false, class T>
  __device__ __forceinline__ void move(const T (&v)[RPT], T (&out)[RPT],
                                       int t) const {
    if constexpr (RPT == 1 && SELP) {
      out[0] = __shfl_sync(mk::FULL, v[0], src(t));
    } else if constexpr (RPT == 1) {
      out[0] = __shfl_sync(mk::FULL, v[0],
                           t == 1 ? rows.up_src
                                  : (t == -1 ? rows.dn_src : rows.kk));
    } else {
      rows.roll(v, out, (t == 1) - (t == -1));
    }
  }
};

// Rescales frontier v by its band max over the rows in the band and the
// five states (a warp reduction; the max is exact, so its order does not
// matter), factor 1 where there is no mass; returns the factor.
template <int RPT>
__device__ __forceinline__ float rescale(const mk::WarpRows<RPT>& rows,
                                         int Wp, float (&v)[RPT][5]) {
  float m = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    if (rows.row(r) < Wp)
      m = fmaxf(m, fmaxf(fmaxf(fmaxf(v[r][0], v[r][1]),
                               fmaxf(v[r][2], v[r][3])), v[r][4]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(mk::FULL, m, o));
  const float c = m > 0.f ? m : 1.f;
  const float inv = 1.f / c;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int s = 0; s < 5; ++s) v[r][s] = v[r][s] * inv;
  return c;
}

// The block of LPB lanes of a kernel of kind KIND (lane b0 + w on warp w):
// tile u of the walk (K2 and MB from the top, K3 and MF from d = 0) comes
// into stage buffer u % REL_STAGES, REL_STAGES - 1 tiles ahead, one
// cp.async group a tile (empty past the last, so that waits count tiles),
// and leaves from output tile u & 1 once the next tile's barrier has
// passed.
template <int KIND, int LPB, int KT, bool TMA>
struct RelBlock {
  uint8_t* raw;
  int Wp;
  size_t nin, nout;
  uint64_t* bars;

  __device__ RelBlock(uint8_t* smem, int Wp_)
      : raw(TMA ? smem + ((1024 - mk::smem_addr(smem) % 1024) % 1024)
                : smem),
        Wp(Wp_), nin(rel_in_bytes(KIND, Wp_, KT, LPB, TMA)),
        nout(rel_out_bytes(KIND, Wp_, KT, LPB)),
        bars(reinterpret_cast<uint64_t*>(raw + REL_STAGES * nin +
                                         2 * nout)) {
    if (TMA && threadIdx.x == 0) {
      for (int s = 0; s < REL_STAGES; ++s) mk::mbar_init(bars + s);
      mk::mbar_init_fence();
    }
    if (TMA) __syncthreads();
  }

  __device__ RelIn in(int u) const {
    return rel_in(raw + (u % REL_STAGES) * nin, KIND, Wp, KT, LPB, TMA);
  }
  __device__ uint64_t* bar(int u) const { return bars + u % REL_STAGES; }
  __device__ float* out(int u) const {
    return reinterpret_cast<float*>(raw + REL_STAGES * nin + (u & 1) * nout);
  }
  // Lane w's rows of output tile u, and its record i after them.
  __device__ float* rows(int u, int w) const {
    return out(u) + w * rel_stride(Wp, KT);
  }
  __device__ float* rec(int u, int i, int w) const {
    return out(u) + LPB * rel_stride(Wp, KT) + (i * LPB + w) * KT;
  }
  // Tile u has landed (this thread's copies, with TMA the barrier's phase
  // u / REL_STAGES, then everyone's): every warp is past tile u - 1.
  __device__ void wait(int u) const {
    mk::cp_async_wait_but<REL_STAGES - 2>();
    if (TMA) mk::mbar_wait(bar(u), (u / REL_STAGES) & 1);
    __syncthreads();
  }
};

// Whether a launch at (Wp, B) takes TMA, as K4's does (csrc/mea.cu
// `mea_tma`): B a multiple of 4, at most two rows a thread, an encoder.
inline bool rel_tma(int Wp, int B) {
  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&
         mk::tensor_map_encoder() != nullptr;
}

// The kernel of kind KIND at LPB lanes a block, TMA or not and RPT rows a
// thread (chain: the multi forward's model form); each file defines it for
// its kinds.
template <int KIND, int LPB, bool TMA, int RPT>
const void* rel_kernel_of(bool chain);

// (TMA only at one and two rows a thread: `rel_tma`; 16 lanes a block
// only there too, and for MB only at one: `rel_lanes`.)
template <int KIND, int LPB, bool TMA>
const void* rel_kernel_rpt(int Wp, bool chain) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return rel_kernel_of<KIND, LPB, TMA, 1>(chain);
    case 2:
      if constexpr (KIND == REL_MB && LPB > 8) return nullptr;
      else return rel_kernel_of<KIND, LPB, TMA, 2>(chain);
    case 3:
      return TMA || LPB > 8 ? nullptr
                            : rel_kernel_of<KIND, 8, false, 3>(chain);
    case 4:
      return TMA || LPB > 8 ? nullptr
                            : rel_kernel_of<KIND, 8, false, 4>(chain);
  }
  return nullptr;
}

template <int KIND>
const void* rel_kernel_lanes(int Wp, int lanes, bool tma, bool chain) {
  switch (lanes) {
    case 8: return tma ? rel_kernel_rpt<KIND, 8, true>(Wp, chain)
                       : rel_kernel_rpt<KIND, 8, false>(Wp, chain);
    case 16: return tma ? rel_kernel_rpt<KIND, 16, true>(Wp, chain)
                        : rel_kernel_rpt<KIND, 16, false>(Wp, chain);
  }
  return nullptr;
}

// The lanes a block of a launch of `kind` at (Wp, B): mk::warp_lanes' (16
// where that block fits and B >= 16 x SMs, else 8), but 8 above two rows a
// thread (MB: above one), where 16 lanes' 512 threads get at most 128
// registers and spill.
inline cudaError_t rel_lanes(int kind, int Wp, int B, bool tma,
                             int* lanes) {
  const bool narrow = mk::rows_per_thread(Wp) > (kind == REL_MB ? 1 : 2);
  return mk::warp_lanes(
      B,
      [=](int l) {
        return narrow && l > 8 ? SIZE_MAX : rel_smem(kind, Wp, l, tma);
      },
      lanes);
}

// The kernel, lanes a block (rel_lanes) and shared memory of a launch of
// KIND (the multi forward: of the model form `chain`) at (Wp, B), with or
// without TMA, its shared memory opted in.
template <int KIND>
cudaError_t rel_setup(bool chain, int Wp, int B, bool tma,
                      const void** kernel, int* lanes, size_t* smem) {
  if (Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT)
    return cudaErrorInvalidValue;
  cudaError_t err = rel_lanes(KIND, Wp, B, tma, lanes);
  if (err != cudaSuccess) return err;
  *kernel = rel_kernel_lanes<KIND>(Wp, *lanes, tma, chain);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = rel_smem(KIND, Wp, *lanes, tma);
  return mk::allow_smem(*kernel, *smem);
}

// Sets up a launch of KIND at (D1, Wp, B) on its float bands (K2, MF: em;
// K3: em, bm; MB: em, fm): TMA where rel_tma allows it and every band
// maps, else cp.async.
template <int KIND>
cudaError_t rel_launch_setup(bool chain, const float* const* bands, int D1,
                             int Wp, int B, RelMaps* maps,
                             const void** kernel, int* lanes, size_t* smem) {
  memset(maps, 0, sizeof(*maps));
  bool tma = rel_tma(Wp, B);
  cudaError_t err = rel_setup<KIND>(chain, Wp, B, tma, kernel, lanes, smem);
  if (err != cudaSuccess || !tma) return err;
  for (int q = 0; q < rel_np(KIND); ++q)
    if (!mk::band_map(&maps->m[q], bands[q], D1, Wp, B, *lanes,
                      rel_kt(mk::rows_per_thread(Wp))))
      return rel_setup<KIND>(chain, Wp, B, false, kernel, lanes, smem);
  return cudaSuccess;
}

}  // namespace
