// The serving kernels of the unfused circular route (ops/fb_circ.py
// `posteriors_circ`, serve=<mode>), one warp per lane (csrc/fb_circ.cu's
// header: the layout, the scaling, the recursions).
//
// Replaces the TPU kernels of marginalign_trna_tpu/ops/fb_pallas.py:
//   circ_backward_emv      <- `_make_bwd_kernel_circ_first` ("em" mode):
//                   the scaled backward (bm, bls, logZ, as sv_backward's)
//                   from a premasked f32 emission stream em and the int8
//                   valid stream.
//   circ_backward_codes    <- `_make_bwd_kernel_circ_lean` ("lean"): from
//                   the int8 code streams xb, yb and valid, the match
//                   emission looked up in the 5x5 table Ematch[x][y]
//                   in-kernel.
//   circ_backward_codes_es <- `_make_bwd_kernel_circ_emw` ("emw"): as
//                   codes, and it also writes the signed stream
//                   es = e * valid - (1 - valid) for the forward.
//   circ_post_es / _emv / _codes <- `_make_fwd_kernel_circ_post_sv`
//                   ("sv", "emw"), `_make_fwd_kernel_circ_post` ("em"),
//                   `_make_fwd_kernel_circ_post_lean` ("lean"): the scaled
//                   forward; post = f_M * b_M * exp(ls + bls - logZ) leaves
//                   as the circular band (the origin cell kept, as the TPU
//                   kernels keep it).
// The backwards are S's walk (csrc/fb_circ.cuh `sv_walk`) over their
// emission sources (`serve_backward_kernel`), the forwards M's recursion
// (`WarpForward`) with a sink that writes the circular band
// (`serve_post_kernel`).  Built with -fmad=false and with the plain
// versions' order of operations, so they equal the plain versions bit for
// bit.
//
// What bounds them on an H100 80GB HBM3 (kernel_ab.py's serve group): per
// cell a backward reads 1-5 B and writes 4-8 B, a forward reads 6-9 B and
// writes 4 B, against ~25 flops; at the serve phase's realign shape [3072,
// 24, 1024] (128 blocks of 8 lanes, one an SM) each warp's chain of
// dependent diagonals bounds them, as it bounds S and K3: the forwards take
// 0.66-0.94 ms, the backwards 0.81-1.12, against byte bounds of 0.16-0.30
// (S takes 0.64 there).
#include <string.h>

#include "fb_circ.cuh"

namespace {

// ------------------------------ the serving backwards: S's walk, a source

// The lanes a block of the serving backwards: at the caller's 32768 lanes
// 16 were no faster for emv and 6% slower for codes (kernel_ab.py's
// probe_serve group).
constexpr int SB_LANES = 8;

// The blocks an SM a serving backward's registers must allow: at one row
// a thread four (64 registers, as S) for emv and three (85) for the codes
// sources, whose byte decode spills under 64; above one row a thread one
// (S spills at four rows a thread under its cap).
__host__ __device__ constexpr int sb_min_blocks(int rpt, int src) {
  return rpt > 1 ? 1 : (src == SRC_EMV ? 4 : 3);
}

// The serving backwards: bm, bls, logZ (and for codes_es es) from em and
// valid (SRC_EMV) or the code streams (SRC_CODES, SRC_CODES_ES; `em` is
// null).
template <int RPT, int SRC>
__global__ void __launch_bounds__(32 * SB_LANES, sb_min_blocks(RPT, SRC))
    serve_backward_kernel(const float* __restrict__ em, SrcBytes by,
                          EmitTable tab, const int32_t* __restrict__ fink,
                          const int32_t* __restrict__ find, CircCoef K,
                          int chain, int d1k, int Wp, int B, int vec,
                          float* __restrict__ bm, float* __restrict__ bls,
                          float* __restrict__ logZ,
                          float* __restrict__ es) {
  extern __shared__ __align__(16) float sv_raw[];
  __shared__ float shE[25];
  if (SRC != SRC_EMV) load_table(tab, shE);  // published by the first barrier
  sv_walk<RPT, SB_LANES, SRC>(sv_raw, em, by, shE, fink, find, K, chain, d1k,
                              Wp, B, vec, bm, bls, logZ, es);
}

// ---------------------------- P: circ_post_es / _emv / _codes (serving)
//
// The serving posterior forwards (`serve_post_kernel`) run M's forward
// (WarpForward) in M's layout over an emission source (es, emv or codes):
// one warp per lane, band row k = kk + 32 r on thread kk (RPT rows a
// thread, Wp <= 128), a sink that keeps nothing: post = f_M * b_M *
// exp(ls + bls - logZ) of each row in the band (the origin cell kept, as
// the TPU kernels keep it) goes into an output tile and leaves as
// lane-contiguous rows once the next tile's barrier has passed.  A block
// of LPB lanes (`sp_setup`: 8, 16 where the blocks still fill the card)
// stages tiles of KT diagonals (`sp_kt`: 16 at one row a thread and 8
// lanes a block, else 8: whole rescale periods, a whole tile unrolled) one
// tile ahead into SP_STAGES buffers: the float bands (es or em, and bm) as
// K3 stages em and bm (TMA boxes [KT][Wp][LPB] where B % 4 == 0, Wp <= 64
// and the bands map: `sp_tma`; else cp.async into per-lane rows), bls per
// lane by cp.async, the source's byte streams (valid; xb, yb and valid) as
// byte tiles (mk::stage_bytes), the 25 match emissions in shared memory.
// The posterior's scale exp(ls + bls - logZ) of a rescale period's
// diagonals is computed when the period starts, thread j for its diagonal
// j, and again after the period's rescale.  Arithmetic in the order of the
// plain `_CircForward` (ops/fb_circ_cuda.py; -fmad=false), so it equals the
// plain versions bit for bit.
//
// On an H100 (kernel_ab.py's probe_serve group): at the serve phase's
// realign shape [3072, 24, 1024] (8 lanes) es / emv / codes take 0.66 /
// 0.71 / 0.93 ms; by cp.async in place of TMA 0.94 / 0.90 / 0.93, with
// 8-diagonal tiles 0.72 / 0.87 / 0.98.  At the caller shape [128, 24,
// 32768] (16 lanes) 8-diagonal tiles took es / emv from 0.56 / 0.60 to
// 0.48 / 0.56 ms (codes 0.77 to 0.79).
constexpr int SP_STAGES = 2;  // input tiles: the one computed, 1 in flight

__host__ __device__ constexpr int sp_kt(int rpt, int lpb) {
  return rpt == 1 && lpb == 8 ? 16 : 8;
}
static_assert(sp_kt(1, 8) % 8 == 0 && sp_kt(2, 8) % 8 == 0,
              "tiles hold whole rescale periods");

// Float bands a stage holds: the source's (es or em; none for codes), then
// bm.
__host__ __device__ constexpr int sp_planes(int src) {
  return src == SRC_CODES ? 1 : 2;
}

// A stage buffer: the float planes (with TMA the box as the map copies it,
// mk::swizzled, its floats rounded up to 256 so that planes stay
// 1024-byte aligned; else lane w's row k of tile diagonal kb at
// w * sp_stride + kb * Wp + k), bls [LPB][KT], the byte tiles
// [src_bytes][KT Wp][byte_stride(LPB)]; rounded up to 1024 bytes with
// TMA, else to 16.  An output tile holds lane w's rows at the cp.async
// offsets.
__host__ __device__ inline int sp_stride(int Wp, int kt) { return kt * Wp + 1; }
__host__ __device__ inline size_t sp_plane(int Wp, int kt, int lpb,
                                           bool tma) {
  return tma ? ((size_t)kt * Wp * lpb + 255) / 256 * 256
             : (size_t)lpb * sp_stride(Wp, kt);
}
__host__ __device__ inline size_t sp_in_bytes(int src, int Wp, int kt,
                                              int lpb, bool tma) {
  const size_t a = tma ? 1024 : 16;
  const size_t b =
      (sp_planes(src) * sp_plane(Wp, kt, lpb, tma) + (size_t)lpb * kt) * 4 +
      (size_t)src_bytes(src) * kt * Wp * mk::byte_stride(lpb);
  return (b + a - 1) / a * a;
}
__host__ __device__ inline size_t sp_out_bytes(int Wp, int kt, int lpb) {
  return ((size_t)lpb * sp_stride(Wp, kt) * 4 + 15) / 16 * 16;
}
// SP_STAGES stage buffers and two output tiles; with TMA 1024 bytes to
// align the stages, and the stages' barriers.
inline size_t sp_smem(int src, int Wp, int lpb, bool tma) {
  const int kt = sp_kt(mk::rows_per_thread(Wp), lpb);
  return (tma ? 1024 + 8 * SP_STAGES : 0) +
         SP_STAGES * sp_in_bytes(src, Wp, kt, lpb, tma) +
         2 * sp_out_bytes(Wp, kt, lpb);
}

struct SpIn {
  float* p;          // the float planes
  float* bls;        // [LPB][KT]
  uint8_t* v;        // the byte tiles
};

template <int SRC, int LPB, int KT, bool TMA>
__device__ inline SpIn sp_in(uint8_t* raw, int Wp) {
  float* planes = reinterpret_cast<float*>(raw);
  float* bls = planes + sp_planes(SRC) * sp_plane(Wp, KT, LPB, TMA);
  return SpIn{planes, bls, reinterpret_cast<uint8_t*>(bls + LPB * KT)};
}

// The float bands' tensor maps (plane order; unused by cp.async).
struct SpMaps {
  CUtensorMap m[2];
};

// Starts the copy of diagonals d0 .. d0 + n - 1 of the block's lanes
// b0 .. b0 + LPB - 1 into stage buffer S (the caller commits the cp.async
// group): the float bands (TMA: thread 0 asks for their boxes, to land on
// barrier bar; cp.async: thread tid copies lane tid % LPB of rows
// tid / LPB + 32 i), bls, and the byte tiles.
template <int SRC, int LPB, int KT, bool TMA>
__device__ __forceinline__ void sp_stage(
    const SpIn& S, const float* const (&band)[2], const SpMaps& maps,
    uint64_t* bar, const SrcBytes& by, const float* __restrict__ bls,
    int d0, int n, int b0, int Wp, int B, bool vec) {
  constexpr int NP = sp_planes(SRC);
  const int l = threadIdx.x % LPB, b = b0 + l;
  const size_t plane = sp_plane(Wp, KT, LPB, TMA);
  if (TMA) {
    if (threadIdx.x == 0) {
      mk::tma_expect(bar, NP * KT * Wp * LPB * 4u);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::tma_load(S.p + q * plane, &maps.m[q], b0, 0, d0, bar);
    }
  } else if (b < B) {
    const size_t g = (size_t)d0 * Wp * B + b;
    float* s = S.p + l * sp_stride(Wp, KT);
    for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
#pragma unroll
      for (int q = 0; q < NP; ++q)
        mk::cp_async4(s + q * plane + r, band[q] + g + (size_t)r * B);
  }
  const int kb = threadIdx.x / LPB;  // the tile diagonal of its record
  if (kb < n && b < B)
    mk::cp_async4(S.bls + l * KT + kb, bls + (size_t)(d0 + kb) * B + b);
#pragma unroll
  for (int i = 0; i < src_bytes(SRC); ++i)
    mk::stage_bytes<LPB>(S.v + i * KT * Wp * mk::byte_stride(LPB), by.p[i],
                         (size_t)d0 * Wp, n * Wp, b0, B, vec);
}

// Writes the rows of output tile O (diagonals d0 .. d0 + n - 1 of the
// block's lanes) to post in sp_stage's cp.async order.
template <int LPB, int KT>
__device__ __forceinline__ void sp_flush(const float* O, int d0, int n,
                                         int b0, int Wp, int B,
                                         float* __restrict__ post) {
  const int l = threadIdx.x % LPB, b = b0 + l;
  if (b >= B) return;
  const size_t g = (size_t)d0 * Wp * B + b;
  const float* s = O + l * sp_stride(Wp, KT);
  for (int r = threadIdx.x / LPB; r < n * Wp; r += 32)
    post[g + (size_t)r * B] = s[r];
}

// The lane of a serving forward: M's forward, where its cells lie in a
// stage buffer, the posterior into an output tile.
template <int RPT, int LPB, int SRC, bool TMA>
struct SpWarp {
  static constexpr int KT = sp_kt(RPT, LPB), SB = mk::byte_stride(LPB);
  static constexpr int NP = sp_planes(SRC);
  WarpForward<RPT> fw;
  const float* table;  // the match emissions (codes)
  int Wp, w, plane;
  // A row's plane offset at each tile diagonal (TMA: swizzled) or at
  // diagonal 0 (cp.async: a diagonal adds Wp), its byte's at diagonal 0
  // (a diagonal adds Wp SB); rows past the band read row Wp - 1 (their
  // results are never used).  The TMA offsets stay in registers (KEEP)
  // while every read names its diagonal by a constant (whole tiles); a
  // partial tile computes them, and so does the codes source always (its
  // byte decode leaves no registers for them: it spilled).
  static constexpr bool KEEP = TMA && SRC != SRC_CODES;
  int off[KEEP ? KT : 1][RPT], voff[RPT];

  __device__ SpWarp(const CircCoef& K, int chain, int Wp_, int w_, float lz,
                    const float* table_)
      : fw(K, chain, Wp_, lz), table(table_), Wp(Wp_), w(w_),
        plane((int)sp_plane(Wp_, KT, LPB, TMA)) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = min(fw.row(r), Wp - 1);
      voff[r] = k * SB + w;
      if (KEEP) {
#pragma unroll
        for (int kb = 0; kb < (KEEP ? KT : 1); ++kb)
          off[kb][r] = mk::swizzled<LPB>(kb * Wp + k, w);
      } else {
        off[0][r] = TMA ? k : w * sp_stride(Wp, KT) + k;
      }
    }
  }

  template <bool FIXED>
  __device__ int at(int kb, int r) const {
    if constexpr (!TMA) return off[0][r] + kb * Wp;
    else if constexpr (FIXED && KEEP) return off[kb][r];
    else if constexpr (KEEP)
      return mk::swizzled<LPB>(kb * Wp + min(fw.row(r), Wp - 1), w);
    else return mk::swizzled<LPB>(kb * Wp + off[0][r], w);
  }

  // e and v of row r at tile diagonal kb (o: its plane offset).
  __device__ __forceinline__ void cell(const SpIn& S, int kb, int r, int o,
                                       float& e, float& v) const {
    if constexpr (SRC == SRC_ES) {
      const float x = S.p[o];
      v = x >= 0.f ? 1.f : 0.f;
      e = fmaxf(x, 0.f);
    } else {
      const int tb = KT * Wp * SB;  // bytes a byte tile
      const uint8_t* c = S.v + voff[r] + kb * Wp * SB;
      if constexpr (SRC == SRC_EMV) {
        e = S.p[o];
        v = c[0] ? 1.f : 0.f;
      } else {
        codes_cell(table, (int8_t)c[0], (int8_t)c[tb], c[2 * tb], e, v);
      }
    }
  }

  // The posterior's scale of the rescale period starting at tile diagonal
  // kb0, thread j for its diagonal kb0 + j % 8 (ls moves only at a
  // period's last diagonal, which computes its own), to be shuffled out.
  __device__ __forceinline__ float scales(const SpIn& S, int kb0) const {
    return expf(fw.ls + S.bls[w * KT + kb0 + (fw.kk & 7)] - fw.lz);
  }

  // Diagonals d0 .. d0 + n - 1 (a tile) from stage buffer S: the lane's
  // posterior rows to out.
  __device__ __forceinline__ void tile(const SpIn& S, float* out, int d0,
                                       int n) {
    float a = scales(S, 0);
    if (n == KT) {
#pragma unroll
      for (int kb = 0; kb < KT; ++kb) {
        if (kb > 0 && (kb & 7) == 0) a = scales(S, kb);
        step<true>(S, d0 + kb, kb, __shfl_sync(mk::FULL, a, kb & 7), out);
      }
    } else {
      for (int kb = 0; kb < n; ++kb) {
        if (kb > 0 && (kb & 7) == 0) a = scales(S, kb);
        step<false>(S, d0 + kb, kb, __shfl_sync(mk::FULL, a, kb & 7), out);
      }
    }
  }

  // Generation d (tile diagonal kb, d % 8 == kb % 8) and its posterior.
  template <bool FIXED>
  __device__ __forceinline__ void step(const SpIn& S, int d, int kb,
                                       float alpha, float* out) {
    const bool rescaled = fw.cells_of(d, kb, [&](int r, float& e, float& v) {
      cell(S, kb, r, at<FIXED>(kb, r), e, v);
    });
    if (rescaled) alpha = expf(fw.ls + S.bls[w * KT + kb] - fw.lz);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float bm = S.p[(NP - 1) * plane + at<FIXED>(kb, r)];
      if (fw.row(r) < Wp) out[kb * Wp + fw.row(r)] = fw.f[r][0] * bm * alpha;
    }
    fw.publish();
  }
};

// The block of LPB lanes of a serving forward (lane b0 + w on warp w):
// tile t comes into stage buffer t % SP_STAGES, SP_STAGES - 1 tiles ahead,
// one cp.async group a tile (empty past the last, so that waits count
// tiles), and leaves from output tile t & 1 once the next tile's barrier
// has passed.
template <int LPB, int KT, int SRC, bool TMA>
struct SpBlock {
  uint8_t* raw;
  int Wp;
  size_t nin, nout;
  uint64_t* bars;

  __device__ SpBlock(uint8_t* smem, int Wp_)
      : raw(TMA ? smem + ((1024 - mk::smem_addr(smem) % 1024) % 1024)
                : smem),
        Wp(Wp_), nin(sp_in_bytes(SRC, Wp_, KT, LPB, TMA)),
        nout(sp_out_bytes(Wp_, KT, LPB)),
        bars(reinterpret_cast<uint64_t*>(raw + SP_STAGES * nin + 2 * nout)) {
    if (TMA && threadIdx.x == 0) {
      for (int s = 0; s < SP_STAGES; ++s) mk::mbar_init(bars + s);
      mk::mbar_init_fence();
    }
    if (TMA) __syncthreads();
  }

  __device__ SpIn in(int t) const {
    return sp_in<SRC, LPB, KT, TMA>(raw + (t % SP_STAGES) * nin, Wp);
  }
  __device__ uint64_t* bar(int t) const { return bars + t % SP_STAGES; }
  __device__ float* out(int t) const {
    return reinterpret_cast<float*>(raw + SP_STAGES * nin + (t & 1) * nout);
  }
  // Tile t has landed (this thread's copies, with TMA the barrier's phase
  // t / SP_STAGES, then everyone's): every warp is past tile t - 1.
  __device__ void wait(int t) const {
    mk::cp_async_wait_but<SP_STAGES - 2>();
    if (TMA) mk::mbar_wait(bar(t), (t / SP_STAGES) & 1);
    __syncthreads();
  }
};

// The serving forwards: the circular posterior band from the source's
// streams (es, or em and valid, or xb, yb and valid; `band` is null for
// the codes) and the backward's bm, bls, logZ.
template <int RPT, int LPB, int SRC, bool TMA>
__global__ void __launch_bounds__(32 * LPB)
    serve_post_kernel(const float* __restrict__ band, SrcBytes by,
                      EmitTable tab, const float* __restrict__ bm,
                      const float* __restrict__ bls,
                      const float* __restrict__ logZ,
                      const __grid_constant__ SpMaps maps, CircCoef K,
                      int chain, int d1k, int Wp, int B, int vec,
                      float* __restrict__ post) {
  constexpr int KT = sp_kt(RPT, LPB);
  extern __shared__ __align__(16) uint8_t sp_raw[];
  __shared__ float shE[25];
  if (SRC == SRC_CODES) load_table(tab, shE);  // published by a barrier
  const SpBlock<LPB, KT, SRC, TMA> blk(sp_raw, Wp);
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * LPB, b = b0 + w;
  const bool live = b < B;  // warp-uniform
  const int tiles = (d1k + KT - 1) / KT;
  auto count = [&](int t) { return min(KT, d1k - t * KT); };
  const float* const bands[2] = {sp_planes(SRC) == 2 ? band : bm, bm};
  auto stage = [&](int t) {
    if (t < tiles)
      sp_stage<SRC, LPB, KT, TMA>(blk.in(t), bands, maps, blk.bar(t), by,
                                  bls, t * KT, count(t), b0, Wp, B, vec);
    mk::cp_async_commit();
  };
  SpWarp<RPT, LPB, SRC, TMA> lane(K, chain, Wp, w, live ? logZ[b] : 0.f,
                                  shE);
  for (int t = 0; t < SP_STAGES - 1; ++t) stage(t);
  for (int t = 0; t < tiles; ++t) {
    blk.wait(t);
    if (t > 0)
      sp_flush<LPB, KT>(blk.out(t - 1), (t - 1) * KT, count(t - 1), b0, Wp,
                        B, post);
    stage(t + SP_STAGES - 1);
    if (live)
      lane.tile(blk.in(t), blk.out(t) + w * sp_stride(Wp, KT), t * KT,
                count(t));
  }
  __syncthreads();
  sp_flush<LPB, KT>(blk.out(tiles - 1), (tiles - 1) * KT, count(tiles - 1),
                    b0, Wp, B, post);
}

template <int SRC>
const void* sb_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)serve_backward_kernel<1, SRC>;
    case 2: return (const void*)serve_backward_kernel<2, SRC>;
    case 3: return (const void*)serve_backward_kernel<3, SRC>;
    case 4: return (const void*)serve_backward_kernel<4, SRC>;
  }
  return nullptr;
}

// The kernel, lanes a block (SB_LANES) and shared memory of the serving
// backward of source src at (Wp, B), its shared memory opted in.
cudaError_t sb_setup(int src, int Wp, const void** kernel, int* lanes,
                     size_t* smem) {
  switch (src) {
    case SRC_EMV: *kernel = sb_kernel_rpt<SRC_EMV>(Wp); break;
    case SRC_CODES: *kernel = sb_kernel_rpt<SRC_CODES>(Wp); break;
    case SRC_CODES_ES: *kernel = sb_kernel_rpt<SRC_CODES_ES>(Wp); break;
    default: return cudaErrorInvalidValue;
  }
  *lanes = SB_LANES;
  *smem = sv_smem(Wp, SB_LANES, src);
  return *kernel ? mk::allow_smem(*kernel, *smem) : cudaErrorInvalidValue;
}

// Launches the serving backward of source src: em (emv; else null), the
// byte streams, the HOST table (codes; else null), es out (codes_es).
cudaError_t serve_backward(int src, const float* em, SrcBytes by,
                           const float* table, const int32_t* fink,
                           const int32_t* find, const float* coef, int chain,
                           int d1k, int Wp, int B, float* bm, float* bls,
                           float* logZ, float* es, void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = sb_setup(src, Wp, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  CircCoef K = load_coef(coef);
  EmitTable T = load_table_host(table);
  int vec = mk::words_aligned(B, {by.p[0], by.p[1], by.p[2]});
  void* args[] = {&em, &by, &T,  &fink, &find, &K,   &chain, &d1k,
                  &Wp, &B,  &vec, &bm,  &bls,  &logZ, &es};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

// Whether a serving forward's launch at (Wp, B) takes TMA, as K3's does
// (csrc/fb.cu `rel_tma`): B a multiple of 4, at most two rows a thread,
// an encoder.
bool sp_tma(int Wp, int B) {
  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&
         mk::tensor_map_encoder() != nullptr;
}

// (TMA and 16 lanes a block only at one and two rows a thread.)
template <int SRC, int LPB, bool TMA>
const void* sp_kernel_rpt(int Wp) {
  switch (mk::rows_per_thread(Wp)) {
    case 1: return (const void*)serve_post_kernel<1, LPB, SRC, TMA>;
    case 2: return (const void*)serve_post_kernel<2, LPB, SRC, TMA>;
    case 3:
      return TMA || LPB > 8 ? nullptr
                            : (const void*)serve_post_kernel<3, 8, SRC, false>;
    case 4:
      return TMA || LPB > 8 ? nullptr
                            : (const void*)serve_post_kernel<4, 8, SRC, false>;
  }
  return nullptr;
}

template <int SRC>
const void* sp_kernel_lanes(int Wp, int lanes, bool tma) {
  switch (lanes) {
    case 8: return tma ? sp_kernel_rpt<SRC, 8, true>(Wp)
                       : sp_kernel_rpt<SRC, 8, false>(Wp);
    case 16: return tma ? sp_kernel_rpt<SRC, 16, true>(Wp)
                        : sp_kernel_rpt<SRC, 16, false>(Wp);
  }
  return nullptr;
}

// The kernel, lanes a block and shared memory of the serving forward of
// source src at (Wp, B), with or without TMA, its shared memory opted in.
// Lanes as K3 takes them (csrc/fb.cu `rel_lanes`): mk::warp_lanes' (16
// where that block fits and B >= 16 x SMs, else 8), but 8 above two rows a
// thread, where 16 lanes' 512 threads get at most 128 registers.
cudaError_t sp_setup(int src, int Wp, int B, bool tma, const void** kernel,
                     int* lanes, size_t* smem) {
  const bool narrow = mk::rows_per_thread(Wp) > 2;
  cudaError_t err = mk::warp_lanes(
      B,
      [=](int l) {
        return narrow && l > 8 ? SIZE_MAX : sp_smem(src, Wp, l, tma);
      },
      lanes);
  if (err != cudaSuccess) return err;
  switch (src) {
    case SRC_ES: *kernel = sp_kernel_lanes<SRC_ES>(Wp, *lanes, tma); break;
    case SRC_EMV: *kernel = sp_kernel_lanes<SRC_EMV>(Wp, *lanes, tma); break;
    case SRC_CODES:
      *kernel = sp_kernel_lanes<SRC_CODES>(Wp, *lanes, tma);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *smem = sp_smem(src, Wp, *lanes, tma);
  return mk::allow_smem(*kernel, *smem);
}

// Launches the serving forward of source src: band es or em (null for the
// codes), the byte streams, the HOST table (codes; else null); TMA where
// sp_tma allows it and both float bands map, else cp.async.
cudaError_t serve_post(int src, const float* band, SrcBytes by,
                       const float* table, const float* bm, const float* bls,
                       const float* logZ, const float* coef, int chain,
                       int d1k, int Wp, int B, float* post, void* stream) {
  if (bad_shape(d1k, Wp, B)) return cudaErrorInvalidValue;
  SpMaps maps;
  memset(&maps, 0, sizeof(maps));
  const void* kernel;
  int lanes;
  size_t smem;
  bool tma = sp_tma(Wp, B);
  cudaError_t err = sp_setup(src, Wp, B, tma, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  const float* bands[2] = {sp_planes(src) == 2 ? band : bm, bm};
  for (int q = 0; tma && q < sp_planes(src); ++q)
    if (!mk::band_map(&maps.m[q], bands[q], d1k, Wp, B, lanes,
                      sp_kt(mk::rows_per_thread(Wp), lanes))) {
      tma = false;
      err = sp_setup(src, Wp, B, false, &kernel, &lanes, &smem);
      if (err != cudaSuccess) return err;
    }
  CircCoef K = load_coef(coef);
  EmitTable T = load_table_host(table);
  int vec = mk::words_aligned(B, {by.p[0], by.p[1], by.p[2]});
  void* args[] = {&band, &by,   &T,  &bm, &bls, &logZ, &maps,
                  &K,    &chain, &d1k, &Wp, &B,  &vec,  &post};
  return cudaLaunchKernel(kernel, dim3((B + lanes - 1) / lanes),
                          dim3(32 * lanes), args, smem,
                          (cudaStream_t)stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `coef` is a HOST pointer to
// the 58 floats of `CircCoef`, `table` a HOST pointer to the 25 match
// emissions Ematch[ref][read]; device pointers for everything else.  Each
// returns a cudaError_t code.
extern "C" int circ_backward_emv_launch(const float* em, const int8_t* valid,
                                        const int32_t* fink,
                                        const int32_t* find,
                                        const float* coef, int chain, int d1k,
                                        int Wp, int B, float* bm, float* bls,
                                        float* logZ, void* stream) {
  return serve_backward(SRC_EMV, em, SrcBytes{{valid, nullptr, nullptr}},
                        nullptr, fink, find, coef, chain, d1k, Wp, B, bm, bls,
                        logZ, nullptr, stream);
}

extern "C" int circ_backward_codes_launch(
    const int8_t* xb, const int8_t* yb, const int8_t* valid,
    const float* table, const int32_t* fink, const int32_t* find,
    const float* coef, int chain, int d1k, int Wp, int B, float* bm,
    float* bls, float* logZ, void* stream) {
  return serve_backward(SRC_CODES, nullptr, SrcBytes{{xb, yb, valid}}, table,
                        fink, find, coef, chain, d1k, Wp, B, bm, bls, logZ,
                        nullptr, stream);
}

extern "C" int circ_backward_codes_es_launch(
    const int8_t* xb, const int8_t* yb, const int8_t* valid,
    const float* table, const int32_t* fink, const int32_t* find,
    const float* coef, int chain, int d1k, int Wp, int B, float* bm,
    float* bls, float* logZ, float* es, void* stream) {
  return serve_backward(SRC_CODES_ES, nullptr, SrcBytes{{xb, yb, valid}},
                        table, fink, find, coef, chain, d1k, Wp, B, bm, bls,
                        logZ, es, stream);
}

// What the serving backward of source src (1 emv, 2 codes, 3 codes_es)
// gets at band width Wp over B lanes on this device (mk::kernel_info's
// out[5]; its lanes a block are out[3] / 32).
extern "C" int serve_backward_info(int src, int Wp, int B, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err = sb_setup(src, Wp, &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

extern "C" int circ_post_es_launch(const float* es, const float* bm,
                                   const float* bls, const float* logZ,
                                   const float* coef, int chain, int d1k,
                                   int Wp, int B, float* post, void* stream) {
  return serve_post(SRC_ES, es, SrcBytes{}, nullptr, bm, bls, logZ, coef,
                    chain, d1k, Wp, B, post, stream);
}

extern "C" int circ_post_emv_launch(const float* em, const int8_t* valid,
                                    const float* bm, const float* bls,
                                    const float* logZ, const float* coef,
                                    int chain, int d1k, int Wp, int B,
                                    float* post, void* stream) {
  return serve_post(SRC_EMV, em, SrcBytes{{valid, nullptr, nullptr}},
                    nullptr, bm, bls, logZ, coef, chain, d1k, Wp, B, post,
                    stream);
}

extern "C" int circ_post_codes_launch(const int8_t* xb, const int8_t* yb,
                                      const int8_t* valid, const float* table,
                                      const float* bm, const float* bls,
                                      const float* logZ, const float* coef,
                                      int chain, int d1k, int Wp, int B,
                                      float* post, void* stream) {
  return serve_post(SRC_CODES, nullptr, SrcBytes{{xb, yb, valid}}, table, bm,
                    bls, logZ, coef, chain, d1k, Wp, B, post, stream);
}

// What the serving forward of source src (0 es, 1 emv, 2 codes) gets at
// band width Wp over B lanes on this device, with TMA where B allows it
// (mk::kernel_info's out[5]; its lanes a block are out[3] / 32).
extern "C" int serve_post_info(int src, int Wp, int B, int* out) {
  if (bad_shape(1, Wp, B)) return cudaErrorInvalidValue;
  const void* kernel;
  int lanes;
  size_t smem;
  cudaError_t err =
      sp_setup(src, Wp, B, sp_tma(Wp, B), &kernel, &lanes, &smem);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(kernel, smem, 32 * lanes, out);
}

