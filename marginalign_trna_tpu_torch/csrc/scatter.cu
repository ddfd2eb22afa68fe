// Lane-summed scatter of marginCaller's flushed expectation stream:
//   out[v, c] += vals[c, d, b]  for every (d, b) with jm[d, b] == v,
// v in [0, rg); other targets (-1 pads and tail rows that hold no position)
// add nowhere.
//
// Replaces the TPU kernel marginalign_trna_tpu/ops/bucket_scatter.py
// `bucket_scatter_lanesum` (`_make_bucket_scatter_lanesum_kernel`).  There
// per-lane scatters scalarise, so values go through residue masks in
// aligned groups of 128 rows into a VMEM-resident [rg, C] output.  Here one
// thread per (row, lane) adds its C values into the output with atomics;
// rg has no cap.  The order of the float32 sums depends on the schedule, so
// the result agrees with the plain version to rounding only.
//
// What bounds it on an H100: bytes (C * 4 + 4 per input cell read once, the
// [rg, C] output written) while the atomics of one position stay few; a
// position is covered by every lane whose segment spans it, so at deep
// coverage the same-address atomics in L2 serialise first.  Threads with
// nothing to add (jm == -1, or a zero value) skip the atomic.
#include "common.cuh"

namespace {

__global__ void scatter_lanesum_kernel(const float* __restrict__ vals,
                                       const int32_t* __restrict__ jm,
                                       int C, int D, int B, int rg,
                                       float* __restrict__ out) {
  const size_t cells = (size_t)D * B;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < cells; idx += (size_t)gridDim.x * blockDim.x) {
    const int v = jm[idx];
    if (v < 0 || v >= rg) continue;
    for (int c = 0; c < C; ++c) {
      const float x = vals[(size_t)c * cells + idx];
      if (x != 0.f) atomicAdd(&out[(size_t)v * C + c], x);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes); device pointers.  `out` must be
// zeroed by the caller.  Returns a cudaError_t code.
extern "C" int scatter_lanesum_launch(const float* vals, const int32_t* jm,
                                      int C, int D, int B, int rg, float* out,
                                      void* stream) {
  if (C < 1 || D < 1 || B < 1 || rg < 1) return cudaErrorInvalidValue;
  const size_t cells = (size_t)D * B;
  const int threads = 256;
  const size_t want = (cells + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  scatter_lanesum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, jm, C, D, B, rg, out);
  return cudaGetLastError();
}
