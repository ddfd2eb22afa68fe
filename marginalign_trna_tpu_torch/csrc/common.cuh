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

inline int rows_per_thread(int Wp) { return (Wp + 31) / 32; }

inline dim3 block_shape(int Wp) {
  const int rpt = rows_per_thread(Wp);
  return dim3(LANES, (Wp + rpt - 1) / rpt);
}

inline dim3 grid_shape(int B) { return dim3((B + LANES - 1) / LANES); }

// Opt in to more than the default 48 KB of dynamic shared memory.
inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mk
