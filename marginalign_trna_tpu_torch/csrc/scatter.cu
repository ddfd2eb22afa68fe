// Scatters of the fused passes' flushed streams into dense per-position
// arrays; targets outside [0, rg) (-1 pads, tail rows that hold no
// position) add nowhere.
//
// scatter_lanesum (X), marginCaller's expected base counts summed over lanes:
//   out[v, c] += vals[c, d, b]  for every (d, b) with jm[d, b] == v.
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
//
// scatter_lanes (L), the MEA's per-lane row and column posterior sums:
//   out[v, b] = sum over d with jm[d, b] == v of vals[d, b].
// Replaces marginalign_trna_tpu/ops/bucket_scatter.py `bucket_scatter`
// (via `bucket_scatter_chunked`), which places values through residue masks
// in 128-row groups and chunks its [rg, B] output to fit VMEM.  Here one
// thread per lane walks the rows in order and owns its output column: no
// atomics, no groups, no chunks, and the sums are deterministic.  A lane's
// targets run in increasing order within the flushed rows and within the
// tail rows, so the thread sums a run of equal targets in a register and
// adds it to the output once (out is zeroed by the caller); the sums are
// the plain version's, in its order.  Bound by bytes: 8 B read per row and
// lane, the output written; the loads coalesce across lanes, the output
// stores do not (each lane writes its own row).  With one thread per lane
// a bucket has few threads, so the loop is latency-bound: the thread keeps
// BATCH rows of loads in flight, and stores a run without reading the
// output back wherever the targets still increase.
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

// Adds a run's sum into out[cur]: a plain store while the run's target lies
// above every target the lane has written (the output is zeroed, so
// 0 + acc == acc exactly), a read-modify-write where targets go back (the
// tail rows after the flushed ones).
__device__ __forceinline__ void flush_run(float* out, int cur, float acc,
                                          int& hi, int B, int b) {
  float* dst = out + (size_t)cur * B + b;
  if (cur > hi) {
    *dst = acc;
    hi = cur;
  } else {
    *dst += acc;
  }
}

__global__ void scatter_lanes_kernel(const float* __restrict__ vals,
                                     const int32_t* __restrict__ jm, int D,
                                     int B, int rg, float* __restrict__ out) {
  constexpr int BATCH = 8;  // rows whose loads are in flight together
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int cur = -1, hi = -1;
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += BATCH) {
    int v[BATCH];
    float x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const size_t idx = (size_t)(d0 + u) * B + b;
      v[u] = d0 + u < D ? jm[idx] : -1;
      x[u] = d0 + u < D ? vals[idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (v[u] < 0 || v[u] >= rg) continue;
      if (v[u] == cur) {
        acc += x[u];
        continue;
      }
      if (cur >= 0) flush_run(out, cur, acc, hi, B, b);
      cur = v[u];
      acc = x[u];
    }
  }
  if (cur >= 0) flush_run(out, cur, acc, hi, B, b);
}

}  // namespace

// Plain C entry points (loaded with ctypes); device pointers.  `out` must be
// zeroed by the caller.  Each returns a cudaError_t code.
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

extern "C" int scatter_lanes_launch(const float* vals, const int32_t* jm,
                                    int D, int B, int rg, float* out,
                                    void* stream) {
  if (D < 1 || B < 1 || rg < 1) return cudaErrorInvalidValue;
  // One warp per block, so the few lanes of a bucket spread over the SMs.
  scatter_lanes_kernel<<<(B + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      vals, jm, D, B, rg, out);
  return cudaGetLastError();
}
