// The checkpoint pair of the unfused circular serving route (ops/fb_circ.py
// `posteriors_circ`, serve="ckpt"), one warp per lane (csrc/fb_circ.cu's
// header: the layout, the scaling, the recursions).
//
// Replaces the TPU kernels of marginalign_trna_tpu/ops/fb_pallas.py
// (`_posteriors_circ_ckpt`):
//   circ_ckpt_backward <- `_make_bwd_kernel_circ_ckpt`: the scaled backward
//                   from the int8 code streams xb, yb and valid (the match
//                   emission looked up in the 5x5 table Ematch[x][y]) that
//                   stores no band: once per block of KB diagonals it writes
//                   the state entering the block's top diagonal (the
//                   e_M * b_M rows of the two diagonals above it, the gap
//                   states of the one above, bls and the last rescale
//                   factor: ck [G, 6, Wp, B], cs [G, 2, B]), and logZ.
//   circ_ckpt_post <- `_make_fwd_kernel_circ_ckpt`: per block, ascending,
//                   the block's backward replayed from its checkpoint (bm
//                   and bls of KB diagonals), then the forward over the
//                   block; post = f_M * b_M * exp(ls + bls - logZ) leaves as
//                   the circular band (the origin cell kept).  The replay
//                   runs the backward's arithmetic on the backward's state,
//                   so it equals a stored band bit for bit.
// Built with -fmad=false and with the plain versions' order of operations
// (ops/fb_circ_cuda.py `_CircBackward`, `_CircForward`), so both equal the
// plain versions bit for bit.
//
// The backward (`ckpt_backward_kernel`) is S's walk over the codes source
// (csrc/fb_circ.cuh `SvWarp` in its checkpoint mode): 8 lanes a block,
// one warp a lane, xb, yb and valid staged as byte tiles of KT diagonals
// in a ring of two buffers (nothing leaves a tile, so one barrier a tile).
// KB is a multiple of KT and tiles count from d = 0, so a block of KB
// diagonals starts and ends on tile boundaries: before the top tile of
// each block each thread puts its rows of the checkpoint, from its
// registers, into a buffer in shared memory (p1, p2, g2 and g4 are held
// rolled up one row, so row k goes to row k + 1 mod Wp), and after the
// next barrier the block writes them out as lane-contiguous rows.
//
// The posterior pass (`ckpt_post_kernel`) stages each block of KB
// diagonals once (its checkpoint rows and its byte tiles, which the
// replay reads descending and the forward ascending) by cp.async, one
// block ahead, and holds per lane a tile of bm [KB][Wp] and bls [KB].  A
// replay restores the block's checkpoint into SvWarp's registers and runs
// the block's KB backward steps into the tile; the forward (`WarpForward`,
// the serving forwards' recursion over the codes) runs over the tile,
// writing each posterior over the b_M it used, and the tile leaves as
// lane-contiguous rows after the next barrier.  Each block's replay
// depends only on its checkpoint, so where the card has room for more
// lanes than the launch gives it (B < 16 x SMs) a lane takes two warps: in
// phase p (one block barrier) its replay warp fills block p's tile while
// its forward warp runs block p - 1's, and the block flushes block p - 2
// and stages block p + 1: three stage and three tile buffers, G + 1
// phases for G blocks.  Where the lanes outnumber what the card holds,
// one warp a lane replays each block, then runs its forward (two buffers
// each), 16 lanes a block, so that twice as many warps run the forward
// (`ck_plan`).  The tiles live in shared memory where they fit (Wp <= 72
// at KB 32), else in a device-memory scratch of three tiles a block;
// pipelined blocks take 8 lanes, 4 where 8 do not fit.
//
// What bounds them on an H100 80GB HBM3: per cell the backward reads 3 B
// and the posterior pass 3 B and writes 4 B (the checkpoints add 24 / KB B
// a cell each way), against ~25 flops a recursion; at the serve phase's
// shapes each warp's chain of dependent diagonals bounds them, as it
// bounds S and the serving kernels (PERF.md row 20).
#include "fb_circ.cuh"

namespace {

// Lanes a block of the backward (the serving backwards' block).
constexpr int CKB_LANES = 8;

// ---------------------------------------------------------------- backward

// Floats of a lane's checkpoint in shared memory: its six rows, bls,
// cprev.
__host__ __device__ inline int ck_rows(int Wp) { return 6 * Wp + 2; }

// A buffer of the backward's ring: the byte tiles xb, yb, valid of kt
// diagonals [3][kt Wp][byte_stride(LPB)], rounded up to 16 bytes.
__host__ __device__ inline size_t ckb_buf_bytes(int Wp, int kt, int lpb) {
  return ((size_t)3 * kt * Wp * mk::byte_stride(lpb) + 15) / 16 * 16;
}
// The ring, then two checkpoint buffers [LPB][ck_rows] (by block parity).
inline size_t ckb_smem(int Wp) {
  return 2 * ckb_buf_bytes(Wp, sv_kt(mk::rows_per_thread(Wp)), CKB_LANES) +
         2 * (size_t)CKB_LANES * ck_rows(Wp) * sizeof(float);
}

// A lane's checkpoint c (ck_rows floats) from the registers of a backward
// that is about to step its block's top diagonal, in the layout of the
// plain `checkpoint()` (ops/fb_circ_cuda.py `_CircBackward`): p1, p2,
// g1..g4 [6][Wp] (p1, p2, g2 and g4 held one row up), bls, cprev.
template <int RPT, int LPB, int SRC, bool CKPT>
__device__ __forceinline__ void save_ckpt(
    const SvWarp<RPT, LPB, SRC, CKPT>& s, float* c) {
  const int Wp = s.Wp;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = s.row(r);
    if (k >= Wp) continue;
    const int ku = k + 1 == Wp ? 0 : k + 1;
    c[ku] = s.p1[r];
    c[Wp + ku] = s.p2[r];
    c[2 * Wp + k] = s.g1[r];
    c[3 * Wp + ku] = s.g2[r];
    c[4 * Wp + k] = s.g3[r];
    c[5 * Wp + ku] = s.g4[r];
  }
  if (s.rows.kk == 0) {
    c[6 * Wp] = s.bls;
    c[6 * Wp + 1] = s.cprev;
  }
}

// The backward of the checkpoint pair: S's walk over the codes, tiles from
// the top; before the top tile of block g each warp puts its lane's
// checkpoint in shared memory, and after the next barrier the block writes
// ck[g], cs[g] as lane-contiguous rows.
template <int RPT>
__global__ void __launch_bounds__(32 * CKB_LANES, RPT > 1 ? 1 : 3)
    ckpt_backward_kernel(SrcBytes by, EmitTable tab,
                         const int32_t* __restrict__ fink,
                         const int32_t* __restrict__ find, CircCoef K,
                         int chain, int d1k, int Wp, int B, int KB, int vec,
                         float* __restrict__ ck, float* __restrict__ cs,
                         float* __restrict__ logZ) {
  constexpr int LPB = CKB_LANES, KT = sv_kt(RPT), SB = mk::byte_stride(LPB);
  extern __shared__ __align__(16) uint8_t ckb_raw[];
  __shared__ float shE[25];
  load_table(tab, shE);  // published by the first barrier
  const size_t nbuf = ckb_buf_bytes(Wp, KT, LPB);
  const int crows = ck_rows(Wp);
  auto buf = [&](int u) { return ckb_raw + (u & 1) * nbuf; };
  auto ckbuf = [&](int g) {
    return reinterpret_cast<float*>(ckb_raw + 2 * nbuf) +
           (g & 1) * LPB * crows;
  };
  const int tiles = (d1k + KT - 1) / KT;
  auto first = [&](int u) { return (tiles - 1 - u) * KT; };
  auto count = [&](int u) { return min(KT, d1k - first(u)); };
  // Whether tile u is its block's top tile (KB is a multiple of KT).
  auto saves = [&](int u) {
    const int end = first(u) + count(u);
    return end % KB == 0 || end == d1k;
  };
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  auto stage = [&](int u) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      mk::stage_bytes<LPB>(buf(u) + i * KT * Wp * SB, by.p[i],
                           (size_t)first(u) * Wp, count(u) * Wp, b0, B, vec);
    mk::cp_async_commit();
  };
  // Checkpoint g of the block's lanes from its buffer.
  auto flush = [&](int g) {
    const int tl = threadIdx.x % LPB;
    if (b0 + tl >= B) return;
    const float* c = ckbuf(g) + tl * crows;
    const size_t o = (size_t)g * 6 * Wp * B + b0 + tl;
    for (int r = threadIdx.x / LPB; r < 6 * Wp; r += 32)
      ck[o + (size_t)r * B] = c[r];
    const int r = threadIdx.x / LPB;
    if (r < 2) cs[(size_t)(2 * g + r) * B + b0 + tl] = c[6 * Wp + r];
  };
  SvWarp<RPT, LPB, SRC_CODES, true> lane(K, chain, Wp, live ? find[b] : -1,
                                         live ? fink[b] : -1, shE);
  stage(0);
  for (int u = 0; u < tiles; ++u) {
    // Tile u has landed (this thread's copies, then everyone's) and every
    // warp is past tile u - 1, whose buffer takes tile u + 1 and whose
    // checkpoint, if it saved one, leaves now (its buffer is taken again
    // two checkpoints on).
    mk::cp_async_wait();
    __syncthreads();
    if (u > 0 && saves(u - 1)) flush(first(u - 1) / KB);
    if (u + 1 < tiles) stage(u + 1);
    if (!live) continue;
    const int d0 = first(u);
    if (saves(u)) save_ckpt(lane, ckbuf(d0 / KB) + w * crows);
    lane.tile(nullptr, nullptr, buf(u) + w, d0, count(u));
  }
  __syncthreads();
  if (saves(tiles - 1)) flush(0);
  if (live) lane.write_logz(logZ + b);
}

// ------------------------------------------------------- posterior pass

// A stage buffer (block g's inputs): the checkpoints [LPB][ck_rows], then
// the byte tiles of its sub-tiles of KT diagonals [KB / KT][3][KT Wp]
// [byte_stride(LPB)]; rounded up to 16 bytes.
__host__ __device__ inline size_t ck_stage_bytes(int Wp, int KB, int lpb) {
  return ((size_t)lpb * ck_rows(Wp) * 4 +
          (size_t)3 * KB * Wp * mk::byte_stride(lpb) + 15) /
         16 * 16;
}

// A tile buffer (block g's bm, then its posterior): the rows [LPB]
// [KB Wp + 1] (lane w's row k of block diagonal kb at
// w (KB Wp + 1) + kb Wp + k; an odd stride), then bls [LPB][KB]; floats,
// rounded up to 4.
__host__ __device__ inline int ck_tstride(int Wp, int KB) {
  return KB * Wp + 1;
}
__host__ __device__ inline size_t ck_tile_floats(int Wp, int KB, int lpb) {
  return ((size_t)lpb * (ck_tstride(Wp, KB) + KB) + 3) / 4 * 4;
}

__host__ __device__ constexpr int ck_bufs(bool pipe) { return pipe ? 3 : 2; }

// Shared memory of the posterior pass: its stage buffers and, unless the
// tiles live in device memory (gbm), its tile buffers.
inline size_t ck_post_smem(int Wp, int KB, int lpb, bool pipe, bool gbm) {
  return ck_bufs(pipe) * (ck_stage_bytes(Wp, KB, lpb) +
                          (gbm ? 0 : ck_tile_floats(Wp, KB, lpb) * 4));
}

// Restores checkpoint c (a lane's ck_rows floats) into a backward's
// registers: row k's own values, p1, p2, g2 and g4 from row k + 1 mod Wp
// (as publish leaves them); zeros on rows past the band, whose values
// never reach a row in it (mk::WarpRows).
template <int RPT, int LPB, int SRC, bool CKPT>
__device__ __forceinline__ void restore_ckpt(SvWarp<RPT, LPB, SRC, CKPT>& s,
                                             const float* c) {
  const int Wp = s.Wp;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = s.row(r);
    const bool in = k < Wp;
    const int kh = in ? k : 0, ku = in && k + 1 < Wp ? k + 1 : 0;
    s.p1[r] = in ? c[ku] : 0.f;
    s.p2[r] = in ? c[Wp + ku] : 0.f;
    s.g1[r] = in ? c[2 * Wp + kh] : 0.f;
    s.g2[r] = in ? c[3 * Wp + ku] : 0.f;
    s.g3[r] = in ? c[4 * Wp + kh] : 0.f;
    s.g4[r] = in ? c[5 * Wp + ku] : 0.f;
  }
  s.bls = c[6 * Wp];
  s.cprev = c[6 * Wp + 1];
}

// The forward warp of a lane: the serving forwards' recursion over the
// codes of a stage buffer's byte tiles, b_M and bls from a tile buffer.
template <int RPT, int LPB>
struct CkForward {
  static constexpr int KT = sv_kt(RPT), SB = mk::byte_stride(LPB);
  WarpForward<RPT> fw;
  const float* table;
  int Wp;
  int voff[RPT];  // the row's byte at tile diagonal 0 (past the band:
                  // row Wp - 1's, whose results are never used)

  __device__ CkForward(const CircCoef& K, int chain, int Wp_, float lz,
                       const float* table_)
      : fw(K, chain, Wp_, lz), table(table_), Wp(Wp_) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) voff[r] = min(fw.row(r), Wp - 1) * SB;
  }

  // Diagonals d0 .. d0 + n - 1 (a sub-tile): the lane's column of its
  // byte tiles at bytes, its bm rows at rows (each posterior written over
  // the b_M it used), its bls at bls.  The posterior's scale of a rescale
  // period's diagonals is computed when the period starts, thread j for
  // its diagonal j, and again after the period's rescale.
  __device__ __forceinline__ void tile(const uint8_t* bytes, float* rows,
                                       const float* bls, int d0, int n) {
    float a = expf(fw.ls + bls[fw.kk & 7] - fw.lz);
    if (n == KT) {
#pragma unroll
      for (int kb = 0; kb < KT; ++kb) {
        if (kb > 0 && (kb & 7) == 0)
          a = expf(fw.ls + bls[kb + (fw.kk & 7)] - fw.lz);
        step(bytes, rows, bls, d0 + kb, kb,
             __shfl_sync(mk::FULL, a, kb & 7));
      }
    } else {
      for (int kb = 0; kb < n; ++kb) {
        if (kb > 0 && (kb & 7) == 0)
          a = expf(fw.ls + bls[kb + (fw.kk & 7)] - fw.lz);
        step(bytes, rows, bls, d0 + kb, kb,
             __shfl_sync(mk::FULL, a, kb & 7));
      }
    }
  }

  // Generation d (sub-tile diagonal kb, d % 8 == kb % 8) and its
  // posterior.
  __device__ __forceinline__ void step(const uint8_t* bytes, float* rows,
                                       const float* bls, int d, int kb,
                                       float alpha) {
    const int tb = KT * Wp * SB;  // bytes a byte tile
    const bool rescaled = fw.cells_of(d, kb, [&](int r, float& e, float& v) {
      const uint8_t* c = bytes + kb * Wp * SB + voff[r];
      codes_cell(table, (int8_t)c[0], (int8_t)c[tb], c[2 * tb], e, v);
    });
    if (rescaled) alpha = expf(fw.ls + bls[kb] - fw.lz);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = fw.row(r);
      if (k < Wp) {
        float* x = rows + kb * Wp + k;
        *x = fw.f[r][0] * *x * alpha;
      }
    }
    fw.publish();
  }
};

// The posterior pass over blocks of KB diagonals (csrc header above): LPB
// lanes a block, two warps a lane where PIPE (warps 0 .. LPB - 1 replay,
// LPB .. 2 LPB - 1 run the forward), else one; tiles in shared memory or,
// where GBM, in `scratch` (ck_bufs tiles a block).
template <int RPT, int LPB, bool PIPE, bool GBM>
__global__ void __launch_bounds__(32 * LPB * (PIPE ? 2 : 1), 1)
    ckpt_post_kernel(SrcBytes by, EmitTable tab,
                     const int32_t* __restrict__ fink,
                     const int32_t* __restrict__ find,
                     const float* __restrict__ ck,
                     const float* __restrict__ cs,
                     const float* __restrict__ logZ, CircCoef K, int chain,
                     int d1k, int Wp, int B, int KB, int vec, float* scratch,
                     float* __restrict__ post) {
  constexpr int KT = sv_kt(RPT), SB = mk::byte_stride(LPB);
  constexpr int NB = ck_bufs(PIPE), NT = 32 * LPB * (PIPE ? 2 : 1);
  constexpr int LAG = PIPE ? 1 : 0;  // phases from a replay to its forward
  extern __shared__ __align__(16) uint8_t ckp_raw[];
  __shared__ float shE[25];
  load_table(tab, shE);  // published by the first barrier
  const size_t nstage = ck_stage_bytes(Wp, KB, LPB);
  const size_t ntile = ck_tile_floats(Wp, KB, LPB);
  const int tstride = ck_tstride(Wp, KB), crows = ck_rows(Wp);
  float* tiles = GBM ? scratch + (size_t)blockIdx.x * NB * ntile
                     : reinterpret_cast<float*>(ckp_raw + NB * nstage);
  auto stage_at = [&](int g) { return ckp_raw + (g % NB) * nstage; };
  auto tile_at = [&](int g) { return tiles + (g % NB) * ntile; };
  const int G = (d1k + KB - 1) / KB;
  auto count = [&](int g) { return min(KB, d1k - g * KB); };
  const int w = threadIdx.x >> 5, l = w % LPB;
  const bool replays = !PIPE || w < LPB, forwards = !PIPE || w >= LPB;
  const int b0 = blockIdx.x * LPB, b = b0 + l;
  const bool live = b < B;  // warp-uniform
  const int tl = threadIdx.x % LPB;  // the lane a thread copies

  // Block g's checkpoint rows and byte tiles into its stage buffer (one
  // cp.async group).
  auto stage = [&](int g) {
    uint8_t* S = stage_at(g);
    const int lo = g * KB, n = count(g);
    if (b0 + tl < B) {
      float* c = reinterpret_cast<float*>(S) + tl * crows;
      const size_t o = (size_t)g * 6 * Wp * B + b0 + tl;
      for (int r = threadIdx.x / LPB; r < 6 * Wp; r += NT / LPB)
        mk::cp_async4(c + r, ck + o + (size_t)r * B);
      const int r = threadIdx.x / LPB;
      if (r < 2)
        mk::cp_async4(c + 6 * Wp + r, cs + (size_t)(2 * g + r) * B + b0 + tl);
    }
    uint8_t* t = S + (size_t)LPB * crows * 4;
    for (int j = 0; j * KT < n; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        mk::stage_bytes<LPB, NT>(t + (j * 3 + i) * KT * Wp * SB, by.p[i],
                                 (size_t)(lo + j * KT) * Wp,
                                 min(KT, n - j * KT) * Wp, b0, B, vec);
    mk::cp_async_commit();
  };
  // Block g's posterior rows from its tile buffer, lane-contiguous.
  auto flush = [&](int g) {
    if (b0 + tl >= B) return;
    const float* s = tile_at(g) + tl * tstride;
    const size_t o = (size_t)g * KB * Wp * B + b0 + tl;
    for (int r = threadIdx.x / LPB; r < count(g) * Wp; r += NT / LPB)
      post[o + (size_t)r * B] = s[r];
  };

  CkForward<RPT, LPB> fwd(K, chain, Wp, live ? logZ[b] : 0.f, shE);
  const int fd = live ? find[b] : -1, fk = live ? fink[b] : -1;
  stage(0);
  for (int p = 0; p < G + LAG; ++p) {
    // Block p has landed (this thread's copies, then everyone's) and every
    // warp is past phase p - 1.
    mk::cp_async_wait();
    __syncthreads();
    if (p - LAG - 1 >= 0) flush(p - LAG - 1);
    if (p + 1 < G) stage(p + 1);
    if (!live) continue;
    if (replays && p < G) {
      // Block p's backward from its checkpoint into its tile, sub-tiles
      // from the top.
      SvWarp<RPT, LPB, SRC_CODES> sv(K, chain, Wp, fd, fk, shE);
      restore_ckpt(sv, reinterpret_cast<const float*>(stage_at(p)) +
                           l * crows);
      float* rows = tile_at(p) + l * tstride;
      float* bls = tile_at(p) + LPB * tstride + l * KB;
      const uint8_t* bytes = stage_at(p) + (size_t)LPB * crows * 4 + l;
      const int lo = p * KB, n = count(p);
      for (int j = (n - 1) / KT; j >= 0; --j)
        sv.tile(rows + j * KT * Wp, bls + j * KT,
                bytes + j * 3 * KT * Wp * SB, lo + j * KT,
                min(KT, n - j * KT));
    }
    if (!PIPE) __syncwarp();  // the replay's rows, written across the warp
    if (forwards && p >= LAG) {
      const int g = p - LAG, lo = g * KB, n = count(g);
      float* rows = tile_at(g) + l * tstride;
      const float* bls = tile_at(g) + LPB * tstride + l * KB;
      const uint8_t* bytes = stage_at(g) + (size_t)LPB * crows * 4 + l;
      for (int j = 0; j * KT < n; ++j)
        fwd.tile(bytes + j * 3 * KT * Wp * SB, rows + j * KT * Wp,
                 bls + j * KT, lo + j * KT, min(KT, n - j * KT));
    }
  }
  __syncthreads();
  flush(G - 1);
}

// ---------------------------------------------------------------- launches

// The kernel and shared memory of the backward at Wp (KB a multiple of
// its tile), its shared memory opted in.
cudaError_t ckb_setup(int Wp, int KB, const void** kernel, size_t* smem) {
  const int rpt = mk::rows_per_thread(Wp);
  if (KB < 1 || KB % sv_kt(rpt)) return cudaErrorInvalidValue;
  switch (rpt) {
    case 1: *kernel = (const void*)ckpt_backward_kernel<1>; break;
    case 2: *kernel = (const void*)ckpt_backward_kernel<2>; break;
    case 3: *kernel = (const void*)ckpt_backward_kernel<3>; break;
    case 4: *kernel = (const void*)ckpt_backward_kernel<4>; break;
    default: return cudaErrorInvalidValue;
  }
  *smem = ckb_smem(Wp);
  return mk::allow_smem(*kernel, *smem);
}

// A launch of the posterior pass: kernel, lanes and threads a block, shared
// memory, scratch floats a block (tiles in device memory; else 0).
struct CkPlan {
  const void* kernel;
  int lanes, threads;
  size_t smem, scratch;
};

// The posterior pass's instances by rows a thread, those that some
// Wp <= 128 at its KB from ops/fb_circ_cuda.py `ckpt_block` takes:
// sequential at 16 lanes and pipelined at 8 with the tiles in shared
// memory up to Wp 56; pipelined at 4 lanes so at Wp 57-72, and with the
// tiles in device memory above.
template <int RPT>
const void* ck_post_kernel(int lanes, bool pipe, bool gbm) {
  if constexpr (RPT <= 2) {
    if (lanes == 16 && !pipe && !gbm)
      return (const void*)ckpt_post_kernel<RPT, 16, false, false>;
    if (lanes == 8 && pipe && !gbm)
      return (const void*)ckpt_post_kernel<RPT, 8, true, false>;
  }
  if constexpr (RPT == 2 || RPT == 3)
    if (lanes == 4 && pipe && !gbm)
      return (const void*)ckpt_post_kernel<RPT, 4, true, false>;
  if constexpr (RPT >= 3)
    if (lanes == 4 && pipe && gbm)
      return (const void*)ckpt_post_kernel<RPT, 4, true, true>;
  return nullptr;
}

// The posterior pass's launch at (Wp, B, KB): the first of these that has
// an instance and fits the block's shared memory, its shared memory opted
// in.  Where every SM gets a block of 16 lanes (B >= 16 x SMs) the lanes
// outnumber what the card holds, and the sequential version at 16 lanes a
// block (16 warps, each running both chains) keeps more forward warps
// busy than the pipelined one, whose 8 forward warps an SM bound it
// (kernel_ab.py's probe_ckpt group); below that the pipelined version at
// 8 lanes (then 4, then with its tiles in device memory) runs both chains
// of a lane at once.
cudaError_t ck_plan(int Wp, int B, int KB, CkPlan* plan) {
  const int rpt = mk::rows_per_thread(Wp);
  if (KB < 1 || KB % sv_kt(rpt)) return cudaErrorInvalidValue;
  int dev = 0, cap = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  struct Cand {
    int lanes;
    bool pipe, gbm;
  };
  const Cand cands[4] = {
      {16, false, false}, {8, true, false}, {4, true, false}, {4, true, true}};
  for (const Cand& c : cands) {
    if (!c.pipe && B < 16 * sms) continue;
    const void* k = nullptr;
    switch (rpt) {
      case 1: k = ck_post_kernel<1>(c.lanes, c.pipe, c.gbm); break;
      case 2: k = ck_post_kernel<2>(c.lanes, c.pipe, c.gbm); break;
      case 3: k = ck_post_kernel<3>(c.lanes, c.pipe, c.gbm); break;
      case 4: k = ck_post_kernel<4>(c.lanes, c.pipe, c.gbm); break;
    }
    // 128 bytes of static shared memory: the emission table.
    const size_t smem = ck_post_smem(Wp, KB, c.lanes, c.pipe, c.gbm);
    if (k == nullptr || smem + 128 > (size_t)cap) continue;
    plan->kernel = k;
    plan->lanes = c.lanes;
    plan->threads = 32 * c.lanes * (c.pipe ? 2 : 1);
    plan->smem = smem;
    plan->scratch = c.gbm ? ck_bufs(c.pipe) * ck_tile_floats(Wp, KB, c.lanes)
                          : 0;
    return mk::allow_smem(k, smem);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 58 floats of `CircCoef`, `table` a HOST pointer to the 25 match
// emissions Ematch[ref][read]; device pointers for everything else.  Each
// returns a cudaError_t code.
extern "C" int circ_ckpt_backward_launch(
    const int8_t* xb, const int8_t* yb, const int8_t* valid,
    const float* table, const int32_t* fink, const int32_t* find,
    const float* coef, int chain, int d1k, int Wp, int B, int KB, float* ck,
    float* cs, float* logZ, void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  cudaError_t err = ckb_setup(Wp, KB, &kernel, &smem);
  if (err != cudaSuccess) return err;
  SrcBytes by{{xb, yb, valid}};
  EmitTable T = load_table_host(table);
  CircCoef K = load_coef(coef);
  int vec = mk::words_aligned(B, {xb, yb, valid});
  void* args[] = {&by, &T,  &fink, &find, &K,  &chain, &d1k,
                  &Wp, &B,  &KB,   &vec,  &ck, &cs,    &logZ};
  return cudaLaunchKernel(kernel, dim3((B + CKB_LANES - 1) / CKB_LANES),
                          dim3(32 * CKB_LANES), args, smem,
                          (cudaStream_t)stream);
}

// scratch: null where the plan keeps the tiles in shared memory, else
// circ_ckpt_post_scratch's floats of device memory.
extern "C" int circ_ckpt_post_launch(
    const int8_t* xb, const int8_t* yb, const int8_t* valid,
    const float* table, const int32_t* fink, const int32_t* find,
    const float* ck, const float* cs, const float* logZ, const float* coef,
    int chain, int d1k, int Wp, int B, int KB, float* scratch, float* post,
    void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  CkPlan plan;
  cudaError_t err = ck_plan(Wp, B, KB, &plan);
  if (err != cudaSuccess) return err;
  if ((plan.scratch != 0) != (scratch != nullptr)) return cudaErrorInvalidValue;
  SrcBytes by{{xb, yb, valid}};
  EmitTable T = load_table_host(table);
  CircCoef K = load_coef(coef);
  int vec = mk::words_aligned(B, {xb, yb, valid});
  void* args[] = {&by, &T, &fink, &find, &ck, &cs,  &logZ,    &K,   &chain,
                  &d1k, &Wp, &B,   &KB,   &vec, &scratch, &post};
  return cudaLaunchKernel(plan.kernel,
                          dim3((B + plan.lanes - 1) / plan.lanes),
                          dim3(plan.threads), args, plan.smem,
                          (cudaStream_t)stream);
}

// The device memory circ_ckpt_post_launch needs at (Wp, B, KB): out[0]
// floats a block (0: none), out[1] blocks.
extern "C" int circ_ckpt_post_scratch(int Wp, int B, int KB, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  CkPlan plan;
  cudaError_t err = ck_plan(Wp, B, KB, &plan);
  if (err != cudaSuccess) return err;
  out[0] = (int)plan.scratch;
  out[1] = (B + plan.lanes - 1) / plan.lanes;
  return cudaSuccess;
}

// What the checkpoint pair's launch (backward 1: circ_ckpt_backward; 0:
// circ_ckpt_post) at (Wp, B, KB) gets on this device: mk::kernel_info's
// out[5], then out[5] lanes a block, out[6] warps a lane, out[7] scratch
// floats a block.
extern "C" int circ_ckpt_info(int backward, int Wp, int B, int KB, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  if (backward) {
    const void* kernel;
    size_t smem;
    cudaError_t err = ckb_setup(Wp, KB, &kernel, &smem);
    if (err != cudaSuccess) return err;
    out[5] = CKB_LANES;
    out[6] = 1;
    out[7] = 0;
    return mk::kernel_info(kernel, smem, 32 * CKB_LANES, out);
  }
  CkPlan plan;
  cudaError_t err = ck_plan(Wp, B, KB, &plan);
  if (err != cudaSuccess) return err;
  out[5] = plan.lanes;
  out[6] = plan.threads / (32 * plan.lanes);
  out[7] = (int)plan.scratch;
  return mk::kernel_info(plan.kernel, plan.smem, plan.threads, out);
}
