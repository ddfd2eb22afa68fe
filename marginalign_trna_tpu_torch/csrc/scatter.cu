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
// aligned groups of 128 rows into a VMEM-resident [rg, C] output.
//
// What bounds it on an H100: bytes (every target read once, the C values of
// each targeted cell, the [rg, C] output written).  A position is covered
// by every lane whose segment spans it (~300 on the caller's batch of 65536
// lanes over 7168 positions), so one add a cell into global memory, as the
// first design did, serialises same-address atomics in L2 (0.184 ms against
// a 0.023 ms bound there).  The design:
//   - the sums are kept in 64-bit fixed point, X_ONE units a 1: each value
//     is rounded once to a multiple of 2^-32 (exact for |v| >= 2^-9) and
//     integer adds commute, so the sums do not depend on the order in which
//     the threads reach them: two launches are bit-identical, whatever the
//     lane groups, and each output is its exact fixed-point sum rounded once
//     to float32.  Values and sums must stay below 2^31 in magnitude (the
//     caller's values are expected base counts in [0, 1]);
//   - a block owns a group of lanes (a power of two, at most one group an
//     SM) and a window of output rows [0, rows) in shared memory (X_WIN
//     64-bit sums, 224 KB: 7168 rows at C = 4, the caller's whole output up
//     to 7168 positions); its threads walk the group's cells, lanes fastest
//     (coalesced), four at a time with the targets' loads first, and add
//     each targeted value into the window as two 32-bit integer atomics
//     (the low word's add returns its carry to the high word; values in
//     [0, 1) need the second add only on a carry);
//   - a target past the window goes into a zeroed 64-bit accumulator of
//     rows [rows, rg) in device memory (a 64-bit integer atomic a channel):
//     each block covers every row once, so any rg is served, and past the
//     window a position is covered by fewer lanes, so fewer adds meet at
//     one address;
//   - a block writes its window out whole as the group's partial
//     [groups, rows, C]; a second pass sums the partials (exactly) and
//     converts every output, the accumulator's rows too, one thread an
//     output element.
// A float add to shared memory is a compare-and-swap loop on this card
// (ATOMS.CAST.SPIN); the float design before this one took 0.15 ms at rg
// 7168 on an H100 (kernel_ab.py), about half of it in those loops, and its
// sums came in the order the threads reached them (launches agreed to
// float32 rounding, not bit for bit).

// scatter_lanes (L), the MEA's per-lane row and column posterior sums:
//   out[v, b] = sum over d with jm[d, b] == v of vals[d, b].
// Replaces marginalign_trna_tpu/ops/bucket_scatter.py `bucket_scatter`
// (via `bucket_scatter_chunked`), which places values through residue masks
// in 128-row groups and chunks its [rg, B] output to fit VMEM.
//
// What bounds it on an H100: bytes (8 B read per row and lane, the output
// written once; the caller's zeroing writes it once more), provided each
// lane's rows spread over many threads: one thread per lane leaves 128
// warps on 132 SMs at B = 4096, bound by load latency.  The design:
//   - a block owns L_LANES = 4 lanes and walks the rows in tiles of
//     L_CHUNKS chunks of L_CH rows; a thread holds one chunk of one lane
//     in registers and sums its runs of equal targets, branch-free.  The
//     loads are 4 bytes a thread (a warp reads 8 rows of 16 bytes): small
//     blocks of 64 registers a thread put eight on an SM, so the 1024
//     blocks of B = 4096 run in one wave, which beat 16-byte loads over
//     4 lanes a thread (fewer, larger blocks, a second wave);
//   - a lane's targets increase within its flushed rows (each position
//     flushes once) and the last Wp tail rows go back.  A warp walks each
//     lane's chunks in parallel (a thread per chunk, ballots and a
//     shuffle scan): chunks whose targets never decrease and continue the
//     order form a segment, and the runs that cross chunk edges sum in a
//     segmented scan; each chunk then adds its own runs, inner and
//     boundary, which no other chunk of the segment holds.  Where the
//     order breaks a new segment starts, added after the earlier ones
//     (phases, one barrier apart); a chunk whose targets decrease is a
//     segment of its own and adds its runs in row order;
//   - the adds go to a window of L_WIN output rows in shared memory, which
//     is written out as coalesced rows (L_LANES lanes each) once every
//     lane has passed them; a target outside the window adds straight to
//     the output.
// No atomics, and every sum in a fixed order, so launches are
// bit-identical; the sums are the plain version's up to the order of
// float32 additions.  ptxas: 64 registers (24 B of spill stores), 5,216 B
// of static shared memory and the 16 KB window a block.
#include <climits>

#include "common.cuh"

namespace {

// ------------------------------------------------- X: windows of lanes

constexpr int X_THREADS = 1024;  // threads a block (one block an SM)
constexpr int X_WIN = 28672;     // 64-bit sums of a block's output window
constexpr int X_UNROLL = 4;      // cells a thread takes per step
constexpr float X_ONE = 4294967296.f;  // fixed-point units a 1 (2^32)

// X's launch at (C, B, rg): output rows of the window, lanes a group
// (1 << shift) and lane groups (one block each).
struct LanesumPlan {
  int rows, shift, groups;
};

inline cudaError_t lanesum_plan(int C, int B, int rg, LanesumPlan* p) {
  if (C < 1 || C > X_WIN || B < 1 || rg < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->rows = rg < X_WIN / C ? rg : X_WIN / C;
  // The fewest lanes a group (at least a warp's) that leave no more groups
  // than SMs.
  p->shift = 5;
  while (p->shift < 30 && ((B - 1) >> p->shift) + 1 > sms) ++p->shift;
  p->groups = ((B - 1) >> p->shift) + 1;
  return cudaSuccess;
}

// Dynamic shared memory of a block: the window's low and high words.
inline size_t lanesum_smem(int C, int rows) {
  return (size_t)rows * C * 2 * sizeof(uint32_t);
}

// A value in fixed point (round to nearest).
__device__ __forceinline__ long long fixed(float v) {
  return __float2ll_rn(v * X_ONE);
}

// Adds q to the window's sum at word i: its low word (lo, unsigned) by one
// atomic whose old value gives the carry, the high word (hi) by a second
// atomic where q's high word and the carry do not cancel.  Exact whatever
// the order of the adds.
__device__ __forceinline__ void window_add(uint32_t* lo, int32_t* hi, int i,
                                           long long q) {
  if (q == 0) return;
  const uint32_t ql = (uint32_t)q;
  const uint32_t old = atomicAdd(lo + i, ql);
  const int32_t h = (int32_t)(q >> 32) + (old + ql < old ? 1 : 0);
  if (h != 0) atomicAdd(hi + i, h);
}

// Adds q to a sum of the device-memory accumulator.
__device__ __forceinline__ void global_add(long long* at, long long q) {
  if (q != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(at),
              (unsigned long long)q);
}

// One block per lane group: adds the group's values whose targets fall in
// the window (output rows [0, rows)) into shared memory, the others (rows
// [rows, rg)) into acc [rg - rows, C], and writes the window to the group's
// partial [rows, C] in part.  CT is C where it is known at compile time
// (the caller's 4), else 0.
template <int CT>
__global__ void __launch_bounds__(X_THREADS, 1)
    lanesum_window_kernel(const float* __restrict__ vals,
                          const int32_t* __restrict__ jm, int C, int D, int B,
                          int rg, LanesumPlan p, long long* __restrict__ part,
                          long long* __restrict__ acc) {
  extern __shared__ __align__(16) uint32_t x_lo[];
  const int nc = CT > 0 ? CT : C;
  const int n = p.rows, g = blockIdx.x;
  int32_t* x_hi = reinterpret_cast<int32_t*>(x_lo + n * nc);
  const int b0 = g << p.shift;
  const int mask = (1 << p.shift) - 1;
  for (int i = threadIdx.x; i < 2 * n * nc; i += X_THREADS) x_lo[i] = 0;
  __syncthreads();
  const size_t cells = (size_t)D * B;
  const long long total = (long long)D << p.shift;
  for (long long i0 = threadIdx.x; i0 < total;
       i0 += (long long)X_UNROLL * X_THREADS) {
    int t[X_UNROLL];
    size_t at[X_UNROLL];
#pragma unroll
    for (int u = 0; u < X_UNROLL; ++u) {
      const long long i = i0 + (long long)u * X_THREADS;
      const int b = b0 + (int)(i & mask);
      const bool in = (i < total) & (b < B);
      at[u] = (size_t)(i >> p.shift) * B + b;
      t[u] = in ? jm[at[u]] : -1;
    }
    if (CT == 4) {
      float4 x[X_UNROLL];
#pragma unroll
      for (int u = 0; u < X_UNROLL; ++u) {
        const bool hit = (unsigned)t[u] < (unsigned)rg;
        const float* v = vals + at[u];
        x[u] = hit ? make_float4(v[0], v[cells], v[2 * cells], v[3 * cells])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < X_UNROLL; ++u) {
        const long long q[4] = {fixed(x[u].x), fixed(x[u].y), fixed(x[u].z),
                                fixed(x[u].w)};
        if ((unsigned)t[u] < (unsigned)n) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            window_add(x_lo, x_hi, t[u] * 4 + c, q[c]);
        } else if ((unsigned)t[u] < (unsigned)rg) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            global_add(acc + (size_t)(t[u] - n) * 4 + c, q[c]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < X_UNROLL; ++u) {
        if ((t[u] < 0) | (t[u] >= rg)) continue;
        for (int c = 0; c < nc; ++c) {
          const long long q = fixed(vals[(size_t)c * cells + at[u]]);
          if (t[u] < n)
            window_add(x_lo, x_hi, t[u] * nc + c, q);
          else
            global_add(acc + (size_t)(t[u] - n) * nc + c, q);
        }
      }
    }
  }
  __syncthreads();
  long long* win = part + (size_t)g * n * nc;
  for (int i = threadIdx.x; i < n * nc; i += X_THREADS)
    win[i] = (long long)(((uint64_t)(uint32_t)x_hi[i] << 32) | x_lo[i]);
}

// out[e] for e < n (the window's rows): the lane groups' partials
// part[g][e] summed (exactly, in group order); past them acc[e - n]; each
// sum converted once to float32.
__global__ void __launch_bounds__(256)
    lanesum_reduce_kernel(const long long* __restrict__ part, int groups,
                          size_t n, const long long* __restrict__ acc,
                          size_t total, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  long long s;
  if (e < n) {
    s = part[e];
#pragma unroll 8
    for (int g = 1; g < groups; ++g) s += part[(size_t)g * n + e];
  } else {
    s = acc[e - n];
  }
  out[e] = __ll2float_rn(s) * (1.f / X_ONE);
}

const void* lanesum_kernel(int C) {
  return C == 4 ? (const void*)lanesum_window_kernel<4>
                : (const void*)lanesum_window_kernel<0>;
}

constexpr int L_LANES = 4;    // lanes per block
constexpr int L_CHUNKS = 32;  // row chunks per tile (threadIdx.y)
constexpr int L_CH = 8;       // rows per chunk, held in registers
constexpr int L_WIN = 1024;   // output rows staged per block (power of 2)

// A chunk's runs of one lane: count, whether its targets never decrease,
// the first and the last run's target and sum.
struct Runs {
  int n;
  bool mono;
  int ft, lt;
  float fs, ls;
};

// Branch-free: the threads of a warp hold different target patterns, so
// every step is a select, not a branch.
__device__ __forceinline__ Runs chunk_runs(const int (&v)[L_CH],
                                           const float (&x)[L_CH], int rg) {
  Runs r{0, true, -1, -1, 0.f, 0.f};
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < L_CH; ++u) {
    const int t = v[u];
    const bool in = t >= 0 && t < rg;
    const bool same = in && r.n > 0 && t == r.lt;
    const bool fresh = in && !same;
    r.mono = r.mono && !(fresh && r.n > 0 && t < r.lt);
    r.fs = fresh && r.n == 1 ? acc : r.fs;
    r.ft = in && r.n == 0 ? t : r.ft;
    acc = same ? acc + x[u] : (fresh ? x[u] : acc);
    r.lt = fresh ? t : r.lt;
    r.n += fresh ? 1 : 0;
  }
  r.fs = r.n == 1 ? acc : r.fs;
  r.ls = acc;
  return r;
}

// The output window: rows [F, F + L_WIN) of the block's L_LANES lanes,
// win[(t % L_WIN) * L_LANES + l]; a target outside it adds straight into
// the (zeroed) output, and one past it raises `ahead`: its row must then
// be flushed with an add, not a store.
__device__ __noinline__ void add_outside(float* out, size_t at, float s,
                                        int* ahead, bool past) {
  out[at] += s;
  if (past) *ahead = 1;
}

struct Window {
  float* win;
  int* ahead;
  int F;
  float* out;
  int B, lane0;
  __device__ __forceinline__ void add(int t, int l, float s) const {
    if (t >= F && t < F + L_WIN)
      win[(t & (L_WIN - 1)) * L_LANES + l] += s;
    else
      add_outside(out, (size_t)t * B + lane0 + l, s, ahead, t >= F);
  }
};

// Adds a chunk's runs of lane l: with `all` every run in row order, else
// only the runs strictly inside the chunk (the run tracking branch-free,
// as in chunk_runs).
__device__ __forceinline__ void add_runs(const int (&v)[L_CH],
                                         const float (&x)[L_CH], int rg,
                                         bool all, const Window& w, int l) {
  int r = -1, cur = -1;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < L_CH; ++u) {
    const int t = v[u];
    const bool in = t >= 0 && t < rg;
    const bool same = in && r >= 0 && t == cur;
    const bool fresh = in && !same;
    if (fresh && r >= 0 && (all || r >= 1)) w.add(cur, l, acc);
    acc = same ? acc + x[u] : (fresh ? x[u] : acc);
    cur = fresh ? t : cur;
    r += fresh ? 1 : 0;
  }
  if (all && r >= 0) w.add(cur, l, acc);
}

// Window rows [F, F1) into the output (coalesced: L_LANES lanes per row),
// then zeroed.  Rows no target reached ahead of the window hold only what
// the window holds, so they are stored without reading the output.
__device__ __forceinline__ void flush_window(const Window& w, int F1,
                                             bool add, int tid,
                                             int nthreads) {
  for (int i = tid; i < (F1 - w.F) * L_LANES; i += nthreads) {
    const int t = w.F + i / L_LANES, l = i % L_LANES;
    float* slot = w.win + (t & (L_WIN - 1)) * L_LANES + l;
    float* dst = w.out + (size_t)t * w.B + w.lane0 + l;
    if (w.lane0 + l < w.B) *dst = add ? *dst + *slot : *slot;
    *slot = 0.f;
  }
}

// blockDim = (L_LANES, L_CHUNKS); one block per L_LANES lanes, eight
// blocks per SM, so that a grid of B / L_LANES blocks fills the card in
// one wave at the path's B = 4096; dynamic shared memory: the window,
// L_WIN * L_LANES floats.
__global__ void __launch_bounds__(L_LANES * L_CHUNKS, 8)
    scatter_lanes_kernel(const float* __restrict__ vals,
                         const int32_t* __restrict__ jm, int D, int B,
                         int rg, float* __restrict__ out) {
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(L_CHUNKS == 32 && L_LANES * L_CHUNKS / 32 == L_LANES,
                "a warp walks one lane's chunks");
  extern __shared__ float s_win[];
  __shared__ int s_ft[L_CHUNKS][L_LANES], s_lt[L_CHUNKS][L_LANES];
  __shared__ float s_fs[L_CHUNKS][L_LANES], s_ls[L_CHUNKS][L_LANES];
  __shared__ int s_n[L_CHUNKS][L_LANES];     // run count, -1: decreasing
  __shared__ int s_ph[L_CHUNKS][L_LANES];    // the chunk's phase
  // A chunk's boundary runs to add (target, -1: none, and sum): its first
  // run where it closes inside the chunk, its last where the next chunk
  // does not continue it; both with the sums of the runs they continue.
  __shared__ int s_e1t[L_CHUNKS][L_LANES], s_e2t[L_CHUNKS][L_LANES];
  __shared__ float s_e1s[L_CHUNKS][L_LANES], s_e2s[L_CHUNKS][L_LANES];
  __shared__ int s_e0t[L_LANES];             // the run pending from the
  __shared__ float s_e0s[L_LANES];           // last tile, if it closes
  // Per lane: the last target of its segment (INT_MAX after a chunk whose
  // targets decrease), its pending (last, unfinished) run's target (-1:
  // none) and sum.
  __shared__ int s_clt[L_LANES], s_pend[L_LANES];
  __shared__ float s_cps[L_LANES];
  __shared__ int s_nph, s_ahead;
  const int c = threadIdx.y;
  const int l = threadIdx.x;                 // the thread's lane
  const int nthreads = L_LANES * L_CHUNKS;
  const int tid = c * L_LANES + l;
  const int lane0 = blockIdx.x * L_LANES;
  const bool live = lane0 + l < B;
  const int wl = tid >> 5, wc = tid & 31;    // walking: lane, chunk
  for (int i = tid; i < L_WIN * L_LANES; i += nthreads) s_win[i] = 0.f;
  if (tid < L_LANES) {
    s_clt[tid] = s_pend[tid] = -1;
    s_cps[tid] = 0.f;
  }
  if (tid == 0) s_ahead = 0;
  Window w{s_win, &s_ahead, 0, out, B, lane0};

  for (int r0 = 0; r0 < D; r0 += L_CHUNKS * L_CH) {
    int v[L_CH];
    float x[L_CH];
#pragma unroll
    for (int u = 0; u < L_CH; ++u) {
      const int row = r0 + c * L_CH + u;
      const size_t at = (size_t)row * B + lane0 + l;
      const bool in = live && row < D;
      v[u] = in ? jm[at] : -1;
      x[u] = in ? vals[at] : 0.f;
    }
    const Runs rs = chunk_runs(v, x, rg);
    s_n[c][l] = rs.mono ? rs.n : -1;
    s_ft[c][l] = rs.ft;
    s_lt[c][l] = rs.lt;
    s_fs[c][l] = rs.fs;
    s_ls[c][l] = rs.ls;
    if (tid == 0) s_nph = 1;
    __syncthreads();

    // Walk the tile's chunks, a warp per lane, a thread per chunk.  A
    // chunk continues its lane's segment when its targets never decrease
    // and start at or above the last target before it; every other
    // nonempty chunk begins a new segment (phase).  Runs that cross chunks
    // sum through a segmented scan of the chunks' last-run sums.
    {
      const int c_lt = s_clt[wl], c_pt = s_pend[wl];
      const float c_ps = s_cps[wl];
      const int n = s_n[wc][wl], ft = s_ft[wc][wl], lt = s_lt[wc][wl];
      const float fs = s_fs[wc][wl], ls = s_ls[wc][wl];
      const bool ne = n != 0, mono = n > 0;
      const unsigned nem = __ballot_sync(FULL, ne);
      const unsigned upto = (2u << wc) - 1;        // chunks 0..wc
      const unsigned below = nem & (upto >> 1);
      const int pidx = below ? 31 - __clz(below) : -1;
      const int lt_eff = mono ? lt : INT_MAX;
      const int plt_sh = __shfl_sync(FULL, lt_eff, pidx < 0 ? 0 : pidx);
      const int plt = pidx < 0 ? c_lt : plt_sh;
      const bool brk = ne && !(mono && ft >= plt);
      const bool join = ne && !brk && ft == plt;
      const unsigned bm = __ballot_sync(FULL, brk);
      // The chunk's last-run sum, continuing the previous chunks' while
      // each is one run joined to the one before.
      float val = ne ? ls : 0.f;
      int flag = ne && !(join && n == 1) ? 1 : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float vu = __shfl_up_sync(FULL, val, o);
        const int fu = __shfl_up_sync(FULL, flag, o);
        if (wc >= o) {
          if (!flag) val = vu + val;
          flag |= fu;
        }
      }
      const float out_c = flag ? val : c_ps + val;
      const float pin_sh = __shfl_sync(FULL, out_c, pidx < 0 ? 0 : pidx);
      const float pin = pidx < 0 ? c_ps : pin_sh;
      const unsigned above = nem & ~upto;
      const int nidx = above ? __ffs(above) - 1 : -1;
      const int jn = __shfl_sync(FULL, join ? 1 : 0, nidx < 0 ? 0 : nidx);
      const int c0 = nem ? __ffs(nem) - 1 : 0;
      const int j0 = __shfl_sync(FULL, join ? 1 : 0, c0);
      const int cl = nem ? 31 - __clz(nem) : 0;
      const int lt_cl = __shfl_sync(FULL, lt_eff, cl);
      const float out_cl = __shfl_sync(FULL, out_c, cl);
      s_ph[wc][wl] = __popc(bm & upto);
      s_e1t[wc][wl] = mono && n >= 2 ? ft : -1;
      s_e1s[wc][wl] = join ? pin + fs : fs;
      s_e2t[wc][wl] = mono && nidx >= 0 && !jn ? lt : -1;
      s_e2s[wc][wl] = out_c;
      __syncwarp();
      if (wc == 0) {
        s_e0t[wl] = nem && !j0 ? c_pt : -1;
        s_e0s[wl] = c_ps;
        if (nem) {
          s_clt[wl] = lt_cl;
          s_pend[wl] = lt_cl == INT_MAX ? -1 : lt_cl;
          s_cps[wl] = out_cl;
        }
        if (bm) atomicMax(&s_nph, __popc(bm) + 1);
      }
    }
    __syncthreads();

    const int nph = s_nph;
    for (int p = 0; p < nph; ++p) {
      if (live) {
        if (p == 0 && c == 0 && s_e0t[l] >= 0) w.add(s_e0t[l], l, s_e0s[l]);
        const int n = s_n[c][l];
        if (n != 0 && s_ph[c][l] == p) {
          // A chunk in order adds its inner runs and its closed boundary
          // runs; one whose targets decrease adds all its runs in row
          // order.
          if (n < 0 || n > 2) add_runs(v, x, rg, n < 0, w, l);
          if (n > 0 && s_e1t[c][l] >= 0) w.add(s_e1t[c][l], l, s_e1s[c][l]);
          if (n > 0 && s_e2t[c][l] >= 0) w.add(s_e2t[c][l], l, s_e2s[c][l]);
        }
      }
      if (p + 1 < nph) __syncthreads();
    }
    __syncthreads();
    // Rows below every lane's pending run are complete: write them out.
    // The window follows the leading lanes, so that the next tile's
    // targets (at most one per row on a flush stream) fit in it; a lane
    // left behind (one that has finished) adds what it still holds below
    // the window straight to the output.
    int lo = INT_MAX, hi = -1;
    for (int l = 0; l < L_LANES; ++l) {
      if (s_pend[l] < 0) continue;
      lo = min(lo, s_pend[l]);
      hi = max(hi, s_pend[l]);
    }
    int F1 = max(lo, hi + L_CHUNKS * L_CH - L_WIN);
    F1 = min(F1, min(w.F + L_WIN, rg));
    if (hi >= 0 && F1 > w.F) {
      flush_window(w, F1, s_ahead != 0, tid, nthreads);
      w.F = F1;
    }
  }
  __syncthreads();  // the last tile's flush is done with the window
  if (tid < L_LANES && lane0 + tid < B && s_pend[tid] >= 0)
    w.add(s_pend[tid], tid, s_cps[tid]);
  __syncthreads();
  flush_window(w, w.F + L_WIN < rg ? w.F + L_WIN : rg, s_ahead != 0, tid,
               nthreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes); device pointers.  Each returns
// a cudaError_t code.

// X's plan at (C, B, rg) on this device: out[0] its lane groups, out[1]
// the rows of its output window; the launch takes a scratch of
// (groups * rows + rg - rows) * C 64-bit sums (scatter_lanesum_launch).
extern "C" int scatter_lanesum_plan(int C, int B, int rg, int* out) {
  LanesumPlan p;
  const cudaError_t err = lanesum_plan(C, B, rg, &p);
  if (err == cudaSuccess) {
    out[0] = p.groups;
    out[1] = p.rows;
  }
  return err;
}

// What the window kernel of X's launch at (C, B, rg) gets on this device
// (mk::kernel_info's out[5]).
extern "C" int scatter_lanesum_info(int C, int B, int rg, int* out) {
  LanesumPlan p;
  const cudaError_t err = lanesum_plan(C, B, rg, &p);
  if (err != cudaSuccess) return err;
  return mk::kernel_info(lanesum_kernel(C), lanesum_smem(C, p.rows),
                         X_THREADS, out);
}

// out [rg, C]; scratch: (groups * rows + rg - rows) * C 64-bit sums of the
// plan (scatter_lanesum_plan), the groups' partials [groups, rows, C] and
// the accumulator of rows [rows, rg), which the caller zeroes.
extern "C" int scatter_lanesum_launch(const float* vals, const int32_t* jm,
                                      int C, int D, int B, int rg,
                                      long long* scratch, int groups,
                                      float* out, void* stream) {
  if (D < 1) return cudaErrorInvalidValue;
  LanesumPlan p;
  cudaError_t err = lanesum_plan(C, B, rg, &p);
  if (err != cudaSuccess) return err;
  if (groups != p.groups || scratch == nullptr) return cudaErrorInvalidValue;
  const void* kernel = lanesum_kernel(C);
  const size_t smem = lanesum_smem(C, p.rows);
  err = mk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)p.rows * C, total = (size_t)rg * C;
  long long* acc = scratch + (size_t)groups * n;
  void* args[] = {&vals, &jm, &C, &D, &B, &rg, &p, &scratch, &acc};
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaLaunchKernel(kernel, dim3(p.groups), dim3(X_THREADS), args, smem,
                         s);
  if (err != cudaSuccess) return err;
  lanesum_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      scratch, groups, n, acc, total, out);
  return cudaGetLastError();
}

extern "C" int scatter_lanes_launch(const float* vals, const int32_t* jm,
                                    int D, int B, int rg, float* out,
                                    void* stream) {
  if (D < 1 || B < 1 || rg < 1) return cudaErrorInvalidValue;
  const size_t win = (size_t)L_WIN * L_LANES * sizeof(float);
  scatter_lanes_kernel<<<(B + L_LANES - 1) / L_LANES, dim3(L_LANES, L_CHUNKS),
                         win, (cudaStream_t)stream>>>(vals, jm, D, B, rg,
                                                      out);
  return cudaGetLastError();
}
