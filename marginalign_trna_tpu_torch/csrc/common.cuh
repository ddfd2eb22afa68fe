// Shared layout helpers for the banded anti-diagonal wavefront kernels.
//
// Every band array is C-contiguous [D1, Wp, B]: anti-diagonal d, band row k,
// lane (read) b, exactly the JAX package's layout.  Every wavefront kernel
// runs one warp per lane: the lane's band rows on the threads of its warp,
// RPT rows a thread (row k = kk + 32 r on thread kk in M, k = RPT kk + r in
// S, K1, D, K4 and fb_rel.cuh's kernels, `WarpRows`), so a row shift is a
// warp shuffle and a diagonal needs no block barrier; the block stages a
// tile of diagonals of its lanes in shared memory (cp.async or TMA) and
// writes its outputs from there, one barrier per tile.  Over lanes that
// hold several problems a tile also stages the problems' start flags as a
// byte tile and their terminal rows as per-lane records, and the terminal
// values leave through per-lane records (nw_multi and mea_multi by
// `MultiSteps` and `flush_records`; the multi-lane FB and counts pairs by
// their own).
// The code expansions E and R take neither: a thread owns one lane (E) or
// four (R) and a tile of diagonals (csrc/expand.cu).
#pragma once

#include <cuda.h>  // CUtensorMap (libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace mk {

constexpr float NEG = -1e30f;  // max-plus "impossible" (wavefront_pallas.NEG)
constexpr int MAX_RPT = 4;     // band rows per thread: Wp <= 128

// Row k + t for t in {-1, 0, 1}, wrapping circularly like the TPU kernels'
// rolls (wrapped rows are guard rows, which `valid` masks).
__device__ __forceinline__ int wrap(int k, int Wp) {
  return k < 0 ? k + Wp : (k >= Wp ? k - Wp : k);
}

// First-max-wins max/argmax of three (wavefront_pallas._max_argmax3).
__device__ __forceinline__ float max_argmax3(float v0, float v1, float v2,
                                             int& arg) {
  const float m01 = fmaxf(v0, v1);
  const int p01 = v1 > v0 ? 1 : 0;
  arg = v2 > m01 ? 2 : p01;
  return fmaxf(m01, v2);
}

inline int rows_per_thread(int Wp) { return (Wp + 31) / 32; }

// The per-diagonal streams of multi-problem lanes (ops/band.py
// `pack_multi_banded_batch`; nw_multi, mea_multi): start [D1, B] int8 (a
// problem's local d = 0), fink / find [D1, B] int32 (the terminal row, and
// >= 0 on a problem's terminal diagonal), and the terminal values term
// [NP, D1, B] the kernel writes.  Null in the single-problem instances.
struct MultiSteps {
  const int8_t* __restrict__ start;
  const int32_t* __restrict__ fink;
  const int32_t* __restrict__ find;
  float* __restrict__ term;
};

// A flat-gap model's coefficients in both of its forms, as the host builds
// them (ops/fb_circ.py `circ_coefficients`; offsets COEF_* in
// ops/fb_circ_cuda.py): the generic 5x5 mix, and the gap-chain form every
// cPecan model family takes (gap states exchange mass only with the match
// state and are carried scaled, f'[t] = f[t] / k[t]).
struct FlatGapCoef {
  float a[25];  // generic branch: a[s * 5 + u] = T[s][u] * g_u
  float t00;    // gap-chain branch: T[0][0]
  float m0[4];  // backward match-row coefficients of the gap states
  float cb[4];  // backward gap self coefficients
  float r[4];   // backward terminal injection of the gap states
  float tz[4];  // T[s][0], the gap states' share of the start mass
  float pi[4];  // forward start values of the scaled gap states
  float mc[4];  // forward match-mix coefficients of the gap states
  float c[4];   // forward gap self coefficients
  float k[4];   // the scale k[t] = g_t T[0][t] of the scaled gap states
};
static_assert(sizeof(FlatGapCoef) == 58 * sizeof(float), "coefficient layout");

// The coefficients from a HOST pointer to their 58 floats.
inline FlatGapCoef load_flat_coef(const float* coef) {
  FlatGapCoef K;
  float* dst = reinterpret_cast<float*>(&K);
  for (int i = 0; i < (int)(sizeof(FlatGapCoef) / sizeof(float)); ++i)
    dst[i] = coef[i];
  return K;
}

// Asynchronous copies from global into shared memory (cp.async): 4 bytes
// through L1, 16 bytes around it; a thread's copies since its last commit
// form one group, and wait() waits for all of its groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------- tensor memory accelerator
//
// A float band [D1, Wp, B] copied by the tensor memory accelerator (TMA):
// boxes [KT][Wp][LPB] as they lie in device memory, lanes fastest, into a
// plane of shared memory (1024-byte aligned), the 16-byte pieces swizzled
// by the map (32, 64 or 128 bytes at LPB 8, 16, 32) so that the rows of
// one lane a warp reads fall on 8 banks (4-way conflicts, not LPB-way).
// One thread asks; an mbarrier counts the bytes in (K4, K2, K3).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Where row q, lane w of a TMA plane lies (floats from its start): the
// map's swizzle XORs the 16-byte piece with bits 7.. of the offset.
template <int LPB>
__device__ __forceinline__ int swizzled(int q, int w) {
  constexpr int M = LPB == 32 ? 7 : (LPB == 16 ? 3 : 1);
  const int o = (q * LPB + w) * 4;
  return (o ^ (((o >> 7) & M) << 4)) >> 2;
}

// Sets barrier bar up for `count` arrivals a phase (one thread; then
// mbar_init_fence and a block barrier).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on bar, expecting `bytes` from the TMA copies that follow; the
// proxy fence orders the block's earlier reads of the buffer before them.
__device__ __forceinline__ void tma_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copies the box at (x, y, z) of `map` into dst; its bytes land on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(x), "r"(y), "r"(z),
         "r"(smem_addr(bar))
      : "memory");
}

// Copies the box at (x, y) of the two-dimensional `map` into dst; its
// bytes land on bar.
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(x), "r"(y),
         "r"(smem_addr(bar))
      : "memory");
}

// Arrives on bar, this thread's earlier writes released to its waiters.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar)) : "memory");
}

// Arrives on bar once every earlier cp.async copy of this thread has
// landed; the arrival counts towards the barrier's init count.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (libcuda
// is not linked); null where the installed CUDA lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return (EncodeTiled)f;
  }();
  return fn;
}

// The tensor map of a float band [D1, Wp, B] for boxes [kt][Wp][lpb]
// (lpb 8, 16 or 32); false where the band is not 16-byte aligned.  The
// caller sees to B % 4 == 0 (row strides of whole 16-byte pieces) and to
// the encoder being there.  Boxes past the band's ends read zeros.
inline bool band_map(CUtensorMap* m, const float* band, int D1, int Wp,
                     int B, int lpb, int kt) {
  if (reinterpret_cast<uintptr_t>(band) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)Wp, (cuuint64_t)D1};
  const cuuint64_t strides[2] = {(cuuint64_t)B * 4, (cuuint64_t)Wp * B * 4};
  const cuuint32_t box[3] = {(cuuint32_t)lpb, (cuuint32_t)Wp,
                             (cuuint32_t)kt};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      lpb == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (lpb == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B);
  return tensor_map_encoder()(
             m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(band),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a byte band [D1, Wp, B] for boxes [kt][Wp][lpb] (lpb
// a multiple of 16), unswizzled: the box's rows of lpb bytes lie one after the
// other in shared memory.  False where the band is not 16-byte aligned or
// B % 16 (row strides of whole 16-byte pieces); the caller sees to the
// encoder being there.  Boxes past the band's ends read zeros.
inline bool byte_band_map(CUtensorMap* m, const uint8_t* band, int D1,
                          int Wp, int B, int lpb, int kt) {
  if (reinterpret_cast<uintptr_t>(band) % 16 || B % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)Wp, (cuuint64_t)D1};
  const cuuint64_t strides[2] = {(cuuint64_t)B, (cuuint64_t)Wp * B};
  const cuuint32_t box[3] = {(cuuint32_t)lpb, (cuuint32_t)Wp,
                             (cuuint32_t)kt};
  const cuuint32_t one[3] = {1, 1, 1};
  return tensor_map_encoder()(
             m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(band),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of an int32 array [D1, B] for boxes [kt][lpb]; false
// where it is not 16-byte aligned or B % 4.
inline bool lane_rows_map(CUtensorMap* m, const int32_t* a, int D1, int B,
                          int lpb, int kt) {
  if (reinterpret_cast<uintptr_t>(a) % 16 || B % 4) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)D1};
  const cuuint64_t strides[1] = {(cuuint64_t)B * 4};
  const cuuint32_t box[2] = {(cuuint32_t)lpb, (cuuint32_t)kt};
  const cuuint32_t one[2] = {1, 1};
  return tensor_map_encoder()(
             m, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int32_t*>(a),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr unsigned FULL = 0xffffffffu;  // every thread of a warp

// ------------------------------------------------ warp per lane: rows

// A select kept as one by PTX: a chain of ?: over an array's elements by
// index (`top == r ? v[r] : down`) became a run-time index that put the
// rows of K1, D and K4 on a stack at three and four rows a thread.
__device__ __forceinline__ float psel(bool p, float a, float b) {
  float o;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n"
      " selp.f32 %0, %1, %2, q;\n}"
      : "=f"(o) : "f"(a), "f"(b), "r"((int)p));
  return o;
}
__device__ __forceinline__ int psel(bool p, int a, int b) {
  int o;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n"
      " selp.b32 %0, %1, %2, q;\n}"
      : "=r"(o) : "r"(a), "r"(b), "r"((int)p));
  return o;
}

// The band rows of a warp-per-lane kernel with RPT consecutive rows a
// thread (K1, D): row k = RPT kk + r on thread kk, so a one-row move of
// the band stays in the thread's registers but for one edge row, which a
// single shuffle brings from the neighbouring thread.  The band wraps
// circularly at Wp: row Wp - 1 moves up to row 0 and row 0 down to row
// Wp - 1, through the same shuffle (source lanes chosen once).  A lane
// takes T threads: the whole warp (T = 32), or a half or a quarter of it
// (T = 16 or 8: two or four lanes a warp, nw_multi and mea_multi at their
// narrow bands), whose shuffles stay among the lane's threads.  PSEL: the
// edge row's select chain by PTX selects (psel).
template <int RPT, int T = 32, bool PSEL = false>
struct WarpRows {
  int kk;      // this thread's place among its lane's T threads
  int up_src;  // the thread whose first row follows this thread's last
  int dn_src;  // the thread whose row precedes this thread's first
  int top;     // this thread's last band row r (row Wp - 1's on the
               // thread holding it): the next lane's first row (row 0)
               // follows it, and it is the row this thread sends down

  __device__ explicit WarpRows(int Wp) : kk(threadIdx.x & (T - 1)) {
    const int last = (Wp - 1) / RPT, rlast = (Wp - 1) % RPT;
    up_src = kk == last ? 0 : (kk + 1) & (T - 1);
    dn_src = kk == 0 ? last : kk - 1;
    top = kk == last ? rlast : RPT - 1;
  }

  __device__ int row(int r) const { return RPT * kk + r; }

  // out[r] = v at row k + t for t in {-1, 0, 1}, the same on every thread
  // of the lane; branch-free (a branch on a stream's value would cost the
  // warp a convergence barrier per move).
  template <class V>
  __device__ void roll(const V (&v)[RPT], V (&out)[RPT], int t) const {
    V down = v[RPT - 1];
#pragma unroll
    for (int r = 0; r < RPT - 1; ++r) {
      if constexpr (PSEL) down = psel(top == r, v[r], down);
      else down = top == r ? v[r] : down;
    }
    const V edge = __shfl_sync(FULL, t > 0 ? v[0] : down,
                               t > 0 ? up_src : (t < 0 ? dn_src : kk), T);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const V up = (r == top) | (r == RPT - 1) ? edge
                                               : v[r + 1 < RPT ? r + 1 : r];
      const V dn = r == 0 ? edge : v[r > 0 ? r - 1 : r];
      out[r] = t > 0 ? up : (t < 0 ? dn : v[r]);
    }
  }
};

// The one-row moves of a wavefront's reads of generation d - 1 (the plain
// versions' ops/fb.py `shift(a, t)`: row k + t for t = +-1, in place for
// any other t).  The left / Ix read takes shift s1 and the up / Iy read
// s1 - 1, so for every s1 at most one of the two moves, by `by` rows:
// `left` (s1 = +-1) or `up` (s1 = 0 or 2).  (Conditions on the diagonal
// loops' paths use & and | on bools: nvcc turns a short-circuit && / ||
// there into branches.)
struct GapMove {
  bool left, up;
  int by;
  __device__ explicit GapMove(int s1)
      : left((s1 == 1) | (s1 == -1)), up((s1 == 0) | (s1 == 2)),
        by(left ? s1 : (up ? s1 - 1 : 0)) {}
};

// The move of the diag / match read of generation d - 2, shift s2 - 1.
__device__ __forceinline__ int diag_move(int s2) {
  return (s2 == 0) | (s2 == 2) ? s2 - 1 : 0;
}

// ----------------------------------------- warp per lane: byte tiles
//
// A tile of a [D1, Wp, B] byte array (K1's codes and valid band, K1's and
// D's pointers) in shared memory keeps the block's LPB lanes fastest: row
// q = kb * Wp + k at bytes [q * byte_stride(LPB), + LPB), so one 4-byte copy
// moves four lanes of a row.  The stride is an odd number of words, so a
// warp reading one row a thread of its own lane touches 32 banks (two
// rows a thread: two-way conflicts).  `vec` says that B
// and the array's address are multiples of 4: rows then move as words
// (cp.async in, plain stores out), else byte by byte through registers.

__host__ __device__ constexpr int byte_stride(int lpb) {
  return 4 * ((lpb / 4) | 1);
}

// Starts copying rows r0 .. r0 + nrows - 1 of the [rows, B] byte array src,
// lanes b0 .. b0 + LPB - 1, into the tile at dst (the caller commits), with
// the NT threads of the block.
template <int LPB, int NT = 32 * LPB>
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const void* src,
                                            size_t r0, int nrows, int b0,
                                            int B, bool vec) {
  constexpr int S = byte_stride(LPB), W = LPB / 4;
  const uint8_t* s = static_cast<const uint8_t*>(src) + r0 * B + b0;
  if (vec) {
    for (int q = threadIdx.x; q < nrows * W; q += NT) {
      const int row = q / W, c = 4 * (q - row * W);
      if (b0 + c < B) cp_async4(dst + row * S + c, s + (size_t)row * B + c);
    }
  } else {
    for (int q = threadIdx.x; q < nrows * LPB; q += NT) {
      const int row = q / LPB, w = q - row * LPB;
      if (b0 + w < B) dst[row * S + w] = s[(size_t)row * B + w];
    }
  }
}

// Writes the tile at src to rows r0 .. r0 + nrows - 1 of dst, as
// stage_bytes reads them.
template <int LPB, int NT = 32 * LPB>
__device__ __forceinline__ void flush_bytes(uint8_t* dst, const uint8_t* src,
                                            size_t r0, int nrows, int b0,
                                            int B, bool vec) {
  constexpr int S = byte_stride(LPB), W = LPB / 4;
  uint8_t* d = dst + r0 * B + b0;
  if (vec) {
    for (int q = threadIdx.x; q < nrows * W; q += NT) {
      const int row = q / W, c = 4 * (q - row * W);
      if (b0 + c < B)
        *reinterpret_cast<uint32_t*>(d + (size_t)row * B + c) =
            *reinterpret_cast<const uint32_t*>(src + row * S + c);
    }
  } else {
    for (int q = threadIdx.x; q < nrows * LPB; q += NT) {
      const int row = q / LPB, w = q - row * LPB;
      if (b0 + w < B) d[(size_t)row * B + w] = src[row * S + w];
    }
  }
}

// One diagonal's start flag and terminal row (fink where find >= 0) as one
// int: the row in the low 16 bits (0xffff, no row, off terminal diagonals
// and for rows outside [0, 0xffff)), the flag at bit 16.
__device__ __forceinline__ int pack_steps(uint8_t start, int fink,
                                          int find) {
  const bool row = (find >= 0) & (fink >= 0) & (fink < 0xffff);
  return (row ? fink : 0xffff) | (start != 0 ? 0x10000 : 0);
}
__device__ __forceinline__ bool seeds(int steps) { return steps >> 16; }
__device__ __forceinline__ bool ends_at(int steps, int k) {
  return (steps & 0xffff) == k;
}

// Writes the per-lane records rec [NP][KT][LPB] (float, lanes fastest) of
// diagonals d0 .. d0 + n - 1 to their lane rows of dst [NP, D1, B], with
// the NT threads of the block.
template <int LPB, int NP, int KT, int NT>
__device__ __forceinline__ void flush_records(float* __restrict__ dst,
                                              const float* rec, int d0, int n,
                                              int D1, int b0, int B) {
  for (int q = threadIdx.x; q < NP * KT * LPB; q += NT) {
    const int w = q % LPB, kb = (q / LPB) % KT, p = q / (KT * LPB);
    if ((kb < n) & (b0 + w < B))
      dst[((size_t)p * D1 + d0 + kb) * B + b0 + w] = rec[q];
  }
}

// True where every pointer is 4-byte aligned and B a multiple of 4: the
// byte tiles' `vec`.
inline bool words_aligned(int B, std::initializer_list<const void*> ptrs) {
  if (B % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 4) return false;
  return true;
}

// Opt in to more than the default 48 KB of dynamic shared memory.
inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// What launches of `kernel` with `threads` threads and `smem` bytes of
// dynamic shared memory get on this device: out[0] registers per thread,
// out[1] shared memory per block (bytes), out[2] blocks resident per SM,
// out[3] threads per block, out[4] local memory per thread (bytes,
// spills).
inline cudaError_t kernel_info(const void* kernel, size_t smem, int threads,
                               int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)(smem + a.sharedSizeBytes);
  out[2] = blocks;
  out[3] = threads;
  out[4] = (int)a.localSizeBytes;
  return cudaSuccess;
}

// The current device's SM count and the shared memory a block may opt in
// to.
inline cudaError_t device_shape(int* sms, int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Whether blocks of `lanes` lanes over B lanes reach 15/16 of the SMs.
inline bool fills(int B, int lanes, int sms) {
  return (B + lanes - 1) / lanes >= sms - sms / 16;
}

// The lanes a block (16 or 8) of S's, K1's and D's warp-per-lane kernels
// over B lanes on the current device: 16 where that block fits shared
// memory (smem(lanes) bytes) and every SM still gets one (B >= 16 x SMs),
// else 8, as M takes them (csrc/fb_circ.cu `mw_lanes`).  A block copies
// LPB lanes of a row at a time, and K1 at 4 lanes (4-byte pieces) ran
// slower than at 8 even where 8 leave SMs idle (kernel_ab.py's probe
// group).
template <class Smem>
inline cudaError_t warp_lanes(int B, Smem smem, int* lanes) {
  int sms = 0, cap = 0;
  cudaError_t err = device_shape(&sms, &cap);
  if (err != cudaSuccess) return err;
  const bool wide = smem(16) <= (size_t)cap && B >= 16 * sms;
  if (!wide && smem(8) > (size_t)cap) return cudaErrorInvalidValue;
  *lanes = wide ? 16 : 8;
  return cudaSuccess;
}

}  // namespace mk
