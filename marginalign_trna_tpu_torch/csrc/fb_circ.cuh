// Code shared by csrc/fb_circ.cu (S, M and C), csrc/fb_serve.cu (the
// serving kernels) and csrc/fb_ckpt.cu (the checkpoint pair): the model's
// coefficients and the emission table, the emission sources, the forward
// recursion in the warp-per-lane layout (`WarpForward`: M, C, the serving
// forwards and the checkpoint posterior pass), S's walk over an emission
// source (`SvWarp`, `sv_walk`: S and the serving backwards; `SvWarp` also
// the checkpoint pair's backward and replay), and the host helpers of the
// files' entry points.  The layout and the scaling: csrc/fb_circ.cu's
// header.
#pragma once

#include "common.cuh"

namespace {

// The model's coefficients (common.cuh).
using CircCoef = mk::FlatGapCoef;

// The 25 match emissions Ematch[ref code][read code], by value.
struct EmitTable {
  float e[25];
};

// -------------------------------------------------------- emission sources
//
// Where the match emission e and the validity v of a cell come from: the
// signed stream es (v = es >= 0, e = max(es, 0)), a premasked emission
// stream em with the int8 valid stream, or the int8 code streams xb, yb
// and valid (e = Ematch[x][y] * v, 0 for a code outside 0..4); with
// CODES_ES the backward also writes the signed stream es = e - (1 - v)
// for the forward.  S and the serving kernels take one as a template
// argument; they stage the byte streams of a source in tiles
// (`src_bytes` of them: valid, or xb, yb and valid).
enum : int { SRC_ES = 0, SRC_EMV = 1, SRC_CODES = 2, SRC_CODES_ES = 3 };

__host__ __device__ constexpr int src_bytes(int src) {
  return src == SRC_ES ? 0 : (src == SRC_EMV ? 1 : 3);
}

// e and v of a cell from its codes x, y and valid byte vb, the 25 match
// emissions at table.
__device__ __forceinline__ void codes_cell(const float* table, int x, int y,
                                           int vb, float& e, float& v) {
  v = vb ? 1.f : 0.f;
  const float em = (unsigned)x < 5u && (unsigned)y < 5u ? table[x * 5 + y]
                                                       : 0.f;
  e = em * v;
}

// Copies the emission table into shared memory (thread 0; the caller's
// next barrier publishes it).
__device__ __forceinline__ void load_table(const EmitTable& tab, float* shE) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int i = 0; i < 25; ++i) shE[i] = tab.e[i];
  }
}

// ------------------------ the forward of one warp per lane: M, C, serving

// out[r] = v at row k - 1 (row Wp - 1 for row 0) of the thread's rows
// k = kk + 32 r: the band's roll down by one row.
template <int RPT>
__device__ __forceinline__ void roll_down(const float (&v)[RPT],
                                          float (&out)[RPT], int kk,
                                          int Wp) {
  if constexpr (RPT == 1) {
    out[0] = __shfl_sync(mk::FULL, v[0], kk == 0 ? Wp - 1 : kk - 1);
  } else {
    float up[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      up[r] = __shfl_sync(mk::FULL, v[r], (kk + 31) & 31);
    const float wrap = __shfl_sync(mk::FULL, v[RPT - 1], (Wp - 1) & 31);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      out[r] = kk > 0 ? up[r] : (r > 0 ? up[r - 1] : wrap);
  }
}

// The scaled forward of one lane in the warp-per-lane layout, its rows
// k = kk + 32 r (M and C): the frontier and the mixes it published (the
// match mix of d-1 and d-2, the gap mixes of d-1, those read one row down
// already rolled) in registers.  Arithmetic in the order of the plain
// `_CircForward` (ops/fb_circ_cuda.py).
template <int RPT>
struct WarpForward {
  const CircCoef& K;
  int chain, Wp, kk;
  float lz, ls = 0.f, cprev = 1.f;
  float f[RPT][5];
  float mm1[RPT], mm2[RPT];  // match mixes of d-1, d-2, rolled down
  float g1[RPT], g2[RPT], g3[RPT], g4[RPT];  // gap mixes of d-1 (2, 4 rolled)

  __device__ WarpForward(const CircCoef& K_, int chain_, int Wp_, float lz_)
      : K(K_), chain(chain_), Wp(Wp_), kk(threadIdx.x & 31), lz(lz_) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      mm1[r] = mm2[r] = g1[r] = g2[r] = g3[r] = g4[r] = 0.f;
  }

  __device__ int row(int r) const { return kk + 32 * r; }

  // Generation d at row kb of its rescale period (kb % 8 == d % 8): the
  // start distribution at d = 0, else the cells from es at the thread's
  // first row, the d-2 mix divided by cprev where kb % 8 == 0 and the
  // rescale where kb % 8 == 7.  Returns whether it rescaled (ls moved).
  __device__ bool cells(int d, int kb, const float* es) {
    return cells_of(d, kb, [&](int r, float& e, float& v) {
      const float x = row(r) < Wp ? es[32 * r] : -1.f;
      v = x >= 0.f ? 1.f : 0.f;
      e = fmaxf(x, 0.f);
    });
  }

  // The same with the cells' match emission e and validity v of row r from
  // cell(r, e, v) (an emission source).
  template <class Cell>
  __device__ __forceinline__ bool cells_of(int d, int kb, const Cell& cell) {
    if (d == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const bool origin = row(r) == 0;
        f[r][0] = origin ? 0.2f : 0.f;
#pragma unroll
        for (int s = 1; s < 5; ++s)
          f[r][s] = origin ? (chain ? K.pi[s - 1] : 0.2f) : 0.f;
      }
      return false;
    }
    const bool divide = (kb & 7) == 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float e, v;
      cell(r, e, v);
      float mm = mm2[r];
      if (divide) mm = mm / cprev;
      f[r][0] = e * mm;
      f[r][1] = g1[r] * v;
      f[r][2] = g2[r] * v;
      f[r][3] = g3[r] * v;
      f[r][4] = g4[r] * v;
    }
    if ((kb & 7) != 7) return false;
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (row(r) < Wp)
        m = fmaxf(m, fmaxf(fmaxf(fmaxf(f[r][0], f[r][1]),
                                 fmaxf(f[r][2], f[r][3])), f[r][4]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(mk::FULL, m, o));
    const float c = m > 0.f ? m : 1.f;
    const float inv = 1.f / c;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int s = 0; s < 5; ++s) f[r][s] = f[r][s] * inv;
    ls += logf(c);
    cprev = c;
    return true;
  }

  // The mixes generation d contributes: the match target at d+2 and the
  // gap targets at d+1, those read one row down rolled now.
  __device__ void publish() {
    float mm[RPT], ga[RPT], gb[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float g[4];
      if (chain) {
        mm[r] = K.t00 * f[r][0];
#pragma unroll
        for (int s = 1; s < 5; ++s) mm[r] = mm[r] + K.mc[s - 1] * f[r][s];
#pragma unroll
        for (int u = 1; u < 5; ++u) g[u - 1] = f[r][0] + K.c[u - 1] * f[r][u];
      } else {
        mm[r] = f[r][0] * K.a[0];
#pragma unroll
        for (int s = 1; s < 5; ++s) mm[r] = mm[r] + f[r][s] * K.a[s * 5];
#pragma unroll
        for (int u = 1; u < 5; ++u) {
          g[u - 1] = f[r][0] * K.a[u];
#pragma unroll
          for (int s = 1; s < 5; ++s)
            g[u - 1] = g[u - 1] + f[r][s] * K.a[s * 5 + u];
        }
      }
      g1[r] = g[0];
      ga[r] = g[1];
      g3[r] = g[2];
      gb[r] = g[3];
      mm2[r] = mm1[r];
    }
    roll_down<RPT>(mm, mm1, kk, Wp);
    roll_down<RPT>(ga, g2, kk, Wp);
    roll_down<RPT>(gb, g4, kk, Wp);
  }
};

// ------------------------------------- S's walk: S and the serving backwards
//
// S runs the backward of the plain `_CircBackward` (ops/fb_circ_cuda.py)
// from the signed stream, as M runs the forward: one warp per lane, RPT
// consecutive band rows a thread (mk::WarpRows, row k = RPT kk + r), LPB
// lanes a block (mk::warp_lanes).  The match term reads row k + 1 of
// generation d + 2 and gap states 2 and 4 row k + 1 of d + 1, so
// generation d's e_M * b_M and its gap states 2 and 4 roll up one row when
// they are published (one shuffle each) and a diagonal needs no block
// barrier; the rescale's band max at d % 8 == 0 is a warp reduction.  The block stages tiles of KT
// descending diagonals of es with cp.async, one tile ahead, into a ring of
// SV_RING buffers; a thread overwrites each es value it has read with its
// b_M, so the tile leaves from the same buffer, as lane-contiguous
// segments, once the next tile's barrier has passed: one barrier per KT
// diagonals.  Tiles start at multiples of KT, so d % 8 is fixed by the
// tile row (a whole tile runs unrolled, its rescale and division steps
// known at compile time), and the top tile is partial when d1k is no
// multiple of KT.  Arithmetic in `_CircBackward`'s order (-fmad=false), so
// it equals the plain version bit for bit.
//
// The serving backwards (circ_backward_emv / _codes / _codes_es:
// `serve_backward_kernel`, csrc/fb_serve.cu) are S's walk over their own
// emission sources, 8 lanes a block in a ring of two buffers: emv stages
// em as S stages es,
// its valid bytes beside it as a byte tile (mk::stage_bytes), and writes
// each b_M over the em value it replaces; the codes sources stage xb, yb
// and valid as byte tiles, look the emission up in the 25-entry table in
// shared memory and send bm through a float plane of the buffer; codes_es
// decodes the tile's cells again as it flushes them, writing
// es = e - (1 - v) beside bm (the recursion does not need es).  On an H100
// at the serve phase's realign shape [3072, 24, 1024] (kernel_ab.py's
// probe_serve group) a ring of two took emv from 0.94 to 0.78 ms and codes
// from 1.06 to 0.97, and 8 lanes a block the codes backward at the caller
// shape [128, 24, 32768] from 0.74 to 0.70; decoding the cells one
// diagonal ahead moved nothing.
//
// What bounds it on an H100 (kernel_ab.py's probe group, [3072, 24, 4096]:
// 1.51 ms against a 0.74 ms byte bound): instruction issue along each
// warp's chain of dependent diagonals.  A gap-chain step is ~56
// instructions (3 of them shuffles), with 8 of the warp's 32 threads past
// the band at Wp 24; without device memory after the first tiles it takes
// 1.24 ms, without the row shuffles 1.47, without the block barrier 1.45.
// Copying the tiles without cp.async costs 11%, 8 lanes a block instead of
// 16 7%, and 8-diagonal tiles 7% at Wp 24.
constexpr int SV_RING = 3;  // tile buffers: computed, leaving, arriving

// KT, the diagonals a tile at rpt band rows a thread: 16 at one row (every
// path's Wp 24), 8 for wider bands, where a ring of 16-diagonal tiles
// leaves room for one block an SM (kernel_ab.py's probe group).
__host__ __device__ constexpr int sv_kt(int rpt) { return rpt == 1 ? 16 : 8; }
static_assert(sv_kt(1) % 8 == 0 && sv_kt(2) % 8 == 0,
              "tiles hold whole rescale periods");

// The byte streams of a source, in its tile order: valid (emv); xb, yb,
// valid (codes).
struct SrcBytes {
  const int8_t* p[3];
};

// A buffer holds a tile's float rows [LPB][sv_stride] (es or em in, bm
// out; lane w's row k of tile row kb at w * stride + kb * Wp + k; the last
// float of a lane's rows is read by the threads past the band), then bls
// [LPB][KT], then the source's byte tiles [src_bytes][KT Wp][byte_stride(
// LPB)] (sv_bytes_at floats from the buffer's start).
__host__ __device__ inline int sv_stride(int Wp, int kt) {
  return kt * Wp + 1;
}
__host__ __device__ inline int sv_bytes_at(int Wp, int lpb, int kt) {
  return lpb * (sv_stride(Wp, kt) + kt);
}
__host__ __device__ inline int sv_buf_floats(int Wp, int lpb, int kt,
                                             int src = SRC_ES) {
  return sv_bytes_at(Wp, lpb, kt) +
         (src_bytes(src) * kt * Wp * mk::byte_stride(lpb) + 3) / 4;
}
// The buffers of the ring: SV_RING for S, two for the serving sources
// (the tile leaving has left before the next one arrives in its buffer: a
// second barrier a tile).
__host__ __device__ constexpr int sv_ring(int src) {
  return src == SRC_ES ? SV_RING : 2;
}
// The ring: 12 lpb (KT (Wp + 1) + 1) bytes for es.
inline size_t sv_smem(int Wp, int lpb, int src = SRC_ES) {
  const int kt = sv_kt(mk::rows_per_thread(Wp));
  return (size_t)sv_ring(src) * sv_buf_floats(Wp, lpb, kt, src) *
         sizeof(float);
}

// Starts the copy of diagonals d0 .. d0 + n - 1 of the block's lanes into
// buffer S (one group): the float stream (es or em) as mw_stage copies it,
// the source's byte streams as byte tiles (words where `vec`).
template <int LPB, int KT, int SRC>
__device__ __forceinline__ void sv_stage(float* S, int d0, int n, int b0,
                                         int Wp, int B,
                                         const float* __restrict__ es,
                                         const SrcBytes& by, bool vec) {
  const int w = threadIdx.x % LPB;
  if (SRC <= SRC_EMV && b0 + w < B) {
    const size_t g = (size_t)d0 * Wp * B + b0 + w;
    float* s = S + w * sv_stride(Wp, KT);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
      mk::cp_async4(s + r, es + g + (size_t)r * B);
  }
  uint8_t* t = reinterpret_cast<uint8_t*>(S + sv_bytes_at(Wp, LPB, KT));
#pragma unroll
  for (int i = 0; i < src_bytes(SRC); ++i)
    mk::stage_bytes<LPB>(t + i * KT * Wp * mk::byte_stride(LPB), by.p[i],
                         (size_t)d0 * Wp, n * Wp, b0, B, vec);
  mk::cp_async_commit();
}

// Writes the bm rows and bls of buffer O (diagonals d0 .. d0 + n - 1) in
// sv_stage's order; codes_es also the signed stream es = e - (1 - v) of
// the buffer's codes (the table at `table`).
template <int LPB, int KT, int SRC>
__device__ __forceinline__ void sv_flush(const float* O, int d0, int n,
                                         int b0, int Wp, int B,
                                         const float* table,
                                         float* __restrict__ bm,
                                         float* __restrict__ bls,
                                         float* __restrict__ es) {
  constexpr int SB = mk::byte_stride(LPB);
  const int w = threadIdx.x % LPB;
  if (b0 + w >= B) return;
  const size_t g = (size_t)d0 * Wp * B + b0 + w;
  const float* s = O + w * sv_stride(Wp, KT);
  const uint8_t* c =
      reinterpret_cast<const uint8_t*>(O + sv_bytes_at(Wp, LPB, KT)) + w;
  const int tb = KT * Wp * SB;  // bytes a byte tile
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32) {
    bm[g + (size_t)r * B] = s[r];
    if (SRC == SRC_CODES_ES) {
      float e, v;
      codes_cell(table, (int8_t)c[r * SB], (int8_t)c[tb + r * SB],
                 c[2 * tb + r * SB], e, v);
      es[g + (size_t)r * B] = e - (1.f - v);
    }
  }
  const int kb = threadIdx.x / LPB;
  if (kb < n)
    bls[(size_t)(d0 + kb) * B + b0 + w] =
        O[sv_bytes_at(Wp, LPB, KT) - LPB * KT + w * KT + kb];
}

// The backward of one lane, its rows as mk::WarpRows, its cells from
// source SRC.  In checkpoint mode (CKPT: csrc/fb_ckpt.cu's
// circ_ckpt_backward) nothing leaves a step: no b_M, no bls.
template <int RPT, int LPB, int SRC, bool CKPT = false>
struct SvWarp {
  static constexpr int KT = sv_kt(RPT), SB = mk::byte_stride(LPB);
  const CircCoef& K;
  const float* table;  // the match emissions (codes sources)
  mk::WarpRows<RPT> rows;
  int chain, Wp, fd;
  bool at_fk[RPT];  // row k is the terminal row
  int boff[RPT];    // the row's byte in a byte tile at tile row 0
  float bls = 0.f, cprev = 1.f;
  float nb[RPT][5];
  float p1[RPT], p2[RPT];  // e_M * b_M of d+1, d+2, rolled up
  float g1[RPT], g2[RPT], g3[RPT], g4[RPT];  // gap states of d+1 (2, 4
                                             // rolled up)

  __device__ SvWarp(const CircCoef& K_, int chain_, int Wp_, int fd_,
                    int fk, const float* table_)
      : K(K_), table(table_), rows(Wp_), chain(chain_), Wp(Wp_), fd(fd_) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      at_fk[r] = row(r) == fk;
      boff[r] = min(row(r), Wp - 1) * SB;
      p1[r] = p2[r] = g1[r] = g2[r] = g3[r] = g4[r] = 0.f;
    }
  }

  __device__ int row(int r) const { return rows.row(r); }

  // Diagonals d0 + n - 1 down to d0 (a tile) of one lane: its float rows
  // at lane (es or em in, bm out), bls to bls_out, its column of the byte
  // tiles at bytes.
  __device__ void tile(float* lane, float* bls_out, const uint8_t* bytes,
                       int d0, int n) {
    if (n == KT) {
#pragma unroll
      for (int kb = KT - 1; kb >= 0; --kb)
        step(d0 + kb, kb, lane, bls_out, bytes);
    } else {
      for (int kb = n - 1; kb >= 0; --kb)
        step(d0 + kb, kb, lane, bls_out, bytes);
    }
  }

  // e and v of row r at tile row kb (`in`: the row is in the band; x its
  // float).
  __device__ __forceinline__ void cell(int kb, int r, bool in, const float* x,
                                       const uint8_t* bytes, float& e,
                                       float& v) const {
    if constexpr (SRC == SRC_ES) {
      const float es = in ? *x : -1.f;
      v = es >= 0.f ? 1.f : 0.f;
      e = fmaxf(es, 0.f);
    } else {
      const int tb = KT * Wp * SB;  // bytes a byte tile
      const uint8_t* c = bytes + kb * Wp * SB + boff[r];
      if constexpr (SRC == SRC_EMV) {
        e = *x;
        v = c[0] ? 1.f : 0.f;
      } else {
        codes_cell(table, (int8_t)c[0], (int8_t)c[tb], c[2 * tb], e, v);
      }
    }
  }

  // Generation d (tile row kb, d % 8 == kb % 8), as the plain
  // `_CircBackward.step` (ops/fb_circ_cuda.py).
  __device__ void step(int d, int kb, float* lane, float* bls_out,
                       const uint8_t* bytes) {
    const bool divide = (kb & 7) == 7;
    const bool at_fd = d == fd;
    float e[RPT], v[RPT];
    int off[RPT];  // the row's float: es or em in, then its b_M
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = row(r);
      const bool in = k < Wp;
      off[r] = in ? kb * Wp + k : KT * Wp;
      cell(kb, r, in, lane + off[r], bytes, e[r], v[r]);
      float q[5];
      q[0] = p2[r];
      if (divide) q[0] = q[0] / cprev;
      q[1] = g1[r];
      q[2] = g2[r];
      q[3] = g3[r];
      q[4] = g4[r];
      const bool inj = at_fd & at_fk[r];
      if (chain) {
        float acc0 = K.t00 * q[0];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc0 = acc0 + K.m0[s - 1] * q[s];
        nb[r][0] = (inj ? 1.f : acc0) * v[r];
#pragma unroll
        for (int s = 1; s < 5; ++s) {
          const float accs = q[0] + K.cb[s - 1] * q[s];
          nb[r][s] = (inj ? K.r[s - 1] : accs) * v[r];
        }
      } else {
        const float injv = inj ? 1.f : 0.f;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          float acc = q[0] * K.a[s * 5];
#pragma unroll
          for (int u = 1; u < 5; ++u) acc = acc + q[u] * K.a[s * 5 + u];
          nb[r][s] = (acc + injv) * v[r];
        }
      }
    }
    if ((kb & 7) == 0) {
      float m = 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (row(r) < Wp)
          m = fmaxf(m, fmaxf(fmaxf(fmaxf(nb[r][0], nb[r][1]),
                                   fmaxf(nb[r][2], nb[r][3])), nb[r][4]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(mk::FULL, m, o));
      const float c = m > 0.f ? m : 1.f;
      const float inv = 1.f / c;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int s = 0; s < 5; ++s) nb[r][s] = nb[r][s] * inv;
      bls += logf(c);
      cprev = c;
    }
    if constexpr (!CKPT) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (row(r) < Wp) lane[off[r]] = nb[r][0];
      if (rows.kk == 0) bls_out[kb] = bls;
    }
    publish(e);
  }

  // Generation d becomes d + 1 for the next step: e_M * b_M and gap
  // states 2 and 4 rolled up one row.
  __device__ void publish(const float (&e)[RPT]) {
    float p[RPT], ga[RPT], gb[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      p[r] = e[r] * nb[r][0];
      g1[r] = nb[r][1];
      ga[r] = nb[r][2];
      g3[r] = nb[r][3];
      gb[r] = nb[r][4];
      p2[r] = p1[r];
    }
    rows.roll(p, p1, 1);
    rows.roll(ga, g2, 1);
    rows.roll(gb, g4, 1);
  }

  // logZ from generation 0 (row 0 is r = 0 of thread 0).
  __device__ void write_logz(float* __restrict__ logZ) const {
    if (rows.kk != 0) return;
    float zr;
    if (chain) {
      zr = nb[0][0];
#pragma unroll
      for (int s = 1; s < 5; ++s) zr = zr + K.tz[s - 1] * nb[0][s];
    } else {
      zr = (((nb[0][0] + nb[0][1]) + nb[0][2]) + nb[0][3]) + nb[0][4];
    }
    *logZ = logf(fmaxf(0.2f * zr, 1e-30f)) + bls;
  }
};

// The walk of S and the serving backwards over a block's lanes, tiles from
// the top, with the ring in shared memory at raw.
template <int RPT, int LPB, int SRC>
__device__ __forceinline__ void sv_walk(
    float* raw, const float* __restrict__ es, const SrcBytes& by,
    const float* table, const int32_t* __restrict__ fink,
    const int32_t* __restrict__ find, const CircCoef& K, int chain, int d1k,
    int Wp, int B, bool vec, float* __restrict__ bm,
    float* __restrict__ bls, float* __restrict__ logZ,
    float* __restrict__ es_out) {
  constexpr int KT = sv_kt(RPT), RING = sv_ring(SRC);
  const int nbuf = sv_buf_floats(Wp, LPB, KT, SRC);
  const int at = sv_bytes_at(Wp, LPB, KT);
  // The buffer of the u-th tile from the top, its first diagonal and its
  // count.
  auto buf = [&](int u) { return raw + (u % RING) * nbuf; };
  const int tiles = (d1k + KT - 1) / KT;
  auto first = [&](int u) { return (tiles - 1 - u) * KT; };
  auto count = [&](int u) { return min(KT, d1k - first(u)); };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  auto stage = [&](int u) {
    sv_stage<LPB, KT, SRC>(buf(u), first(u), count(u), b0, Wp, B, es, by,
                           vec);
  };
  SvWarp<RPT, LPB, SRC> lane(K, chain, Wp, live ? find[b] : -1,
                             live ? fink[b] : -1, table);
  stage(0);
  for (int u = 0; u < tiles; ++u) {
    // Every warp is past tile u - 1, which leaves now; tile u + 1 arrives
    // in the buffer tile u - 2 left from (in a ring of two, in tile
    // u - 1's, once it has left).
    mk::cp_async_wait();  // this thread's copies of tile u,
    __syncthreads();      // then everyone's: tile u has landed
    if (u > 0)
      sv_flush<LPB, KT, SRC>(buf(u - 1), first(u - 1), count(u - 1), b0, Wp,
                             B, table, bm, bls, es_out);
    if (RING == 2) __syncthreads();
    if (u + 1 < tiles) stage(u + 1);
    if (live)
      lane.tile(buf(u) + w * sv_stride(Wp, KT),
                buf(u) + at - LPB * KT + w * KT,
                reinterpret_cast<const uint8_t*>(buf(u) + at) + w, first(u),
                count(u));
  }
  __syncthreads();
  sv_flush<LPB, KT, SRC>(buf(tiles - 1), 0, count(tiles - 1), b0, Wp, B,
                         table, bm, bls, es_out);
  if (live) lane.write_logz(logZ + b);
}

inline CircCoef load_coef(const float* coef) { return mk::load_flat_coef(coef); }

inline EmitTable load_table_host(const float* table) {
  EmitTable T{};
  if (table)
    for (int i = 0; i < 25; ++i) T.e[i] = table[i];
  return T;
}

inline bool bad_shape(int d1k, int Wp, int B) {
  return d1k < 1 || B < 1 || Wp < 1 || mk::rows_per_thread(Wp) > mk::MAX_RPT;
}

}  // namespace
