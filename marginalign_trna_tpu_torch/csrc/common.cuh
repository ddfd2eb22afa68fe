// Shared layout helpers for the banded anti-diagonal wavefront kernels.
//
// Every band array is C-contiguous [D1, Wp, B]: anti-diagonal d, band row k,
// lane (read) b, exactly the JAX package's layout.  A block owns LANES
// consecutive lanes (threadIdx.x, so loads of [d, k, b:b+LANES] coalesce)
// and all Wp band rows of them (threadIdx.y, RPT rows per thread when Wp
// exceeds 32).  The anti-diagonal loop runs inside the block; the band's
// 0/+-1 row shifts between diagonals go through shared memory with one
// barrier per diagonal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mk {

constexpr float NEG = -1e30f;  // max-plus "impossible" (wavefront_pallas.NEG)
constexpr int LANES = 32;      // lanes per block
constexpr int MAX_RPT = 4;     // band rows per thread: Wp <= 128

// Flat index of cell (d, k, b).
__device__ __forceinline__ size_t cell(int d, int k, int b, int Wp, int B) {
  return ((size_t)d * Wp + k) * B + b;
}

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

// Per-lane maximum over the five states and all Wp rows of a frontier held
// as v[r][state] for rows k = ty + r * TY (the forward-backward rescale).
// shR is a [Wp][L] scratch plane; one barrier.
template <int RPT>
__device__ __forceinline__ float band_max(float (&v)[RPT][5], float* shR,
                                          int Wp, int L, int lane, int ty,
                                          int TY) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = ty + r * TY;
    if (k >= Wp) continue;
    const float m = fmaxf(fmaxf(fmaxf(v[r][0], v[r][1]),
                                fmaxf(v[r][2], v[r][3])), v[r][4]);
    shR[k * L + lane] = m;
  }
  __syncthreads();
  float m = shR[lane];
  for (int j = 1; j < Wp; ++j) m = fmaxf(m, shR[j * L + lane]);
  return m;
}

inline int rows_per_thread(int Wp) { return (Wp + 31) / 32; }

inline dim3 block_shape(int Wp) {
  const int rpt = rows_per_thread(Wp);
  return dim3(LANES, (Wp + rpt - 1) / rpt);
}

inline dim3 grid_shape(int B) { return dim3((B + LANES - 1) / LANES); }

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

constexpr unsigned FULL = 0xffffffffu;  // every thread of a warp

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

}  // namespace mk
