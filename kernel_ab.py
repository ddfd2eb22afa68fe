"""A/B timing of the port's redesigned kernels against another checkout of
the port, on the same inputs, in one process on one CUDA card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 kernel_ab.py build/parent [group ...]

Groups (fused, wavefront, counts, scatter, rel, serve, multi, fb_multi
and traceback when none is named):
  traceback
         the device tracebacks nw_moves and mea_moves (csrc/traceback.cu):
         nw_moves on K1's pointers of the guide batch [7168, 48, 1024] (its
         pairs sorted by m + n, as the guide's buckets sort them), at
         widths 93 and 126 (Wp 96, 128) and on its lanes repeated to 4101
         ("_odd": no multiple of 4, so the slabs come by cp.async at a
         byte shift); mea_moves on D's pointers of the realign bucket
         [3072, 24, 4096] (sorted), at widths 93 and 126 and on 4101 lanes,
         and on K4's pointers of the REL batch [3072, 24, 1024] (the
         generic batch, weights from the REL FB pair's posteriors): the
         move stream byte for byte against the plain version and the other
         checkout, times, the bound (a pointer byte and an offset a move
         made, the stream, the lane arrays), resources (registers, shared
         memory a block, blocks an SM, spills, lanes a block, diagonals a
         tile, stages, route), the bytes the kernel streams from its
         blocks' tops and their time at 3.35 TB/s (the slab floor), the
         longest block's diagonals; where this checkout's kernel takes
         TMA, also on the band copied 4 and 1 bytes into a buffer (the
         cp.async route at byte shift 0, then 1), timed and byte-equal.
         Must not move (bit-equal to the other checkout, both timed): K1
         on the guide batch, D on the bucket.
  probe_traceback (named on the command line only): nw_moves and
         mea_moves with one part removed (outputs wrong by design): the
         walk alone (the producers stop after the ring's first stages: the
         serial floor) and the stream alone (no walk), on the traceback
         group's nw_moves, mea_moves and mea_moves_rel cells.
  multi  nw_multi and mea_multi (rows 5 and 7), the multi instances of K1's
         and K4's one-warp-per-lane kernels, on the multi batch (tRNA-scale
         problems several to a 1024-diagonal lane, 4096 lanes): nw_multi at
         the guide's width 40 [1024, 48, 4096] and at widths 21, 93, 126
         (Wp 24, 96, 128), mea_multi with random weights at width 21
         [1024, 24, 4096] and at widths 40, 93, 126 (Wp 48, 96, 128), and
         both on the batch's lanes repeated to 4101 ("_odd": no multiple of
         8, 16 or 4, so mea_multi copies its weights by cp.async): pointers
         and term bit for bit against the plain versions and the other
         checkout, times, bounds and resources (`warp_lane_resources`).
         Must not move (bit-equal to the other checkout, both timed): K1 on
         the guide batch [7168, 48, 1024], K4 on the generic batch [3072,
         24, 1024] and on its lanes repeated to 4096, the multi-lane FB
         pair (row 10) on the multi batch [1024, 24, 4096].
  fb_multi
         the multi-lane FB pair fb_multi_forward and fb_multi_backward
         (row 10) on the multi batch [1024, 24, 4096] (the shipped model:
         the gap-chain branch), on its lanes twice [1024, 24, 8192] (the
         call_multi launch's size), on the multi batch with the flat-gap
         model whose gap states 1 and 2 exchange mass (the generic
         branch) and on the multi batch packed at widths 45, 93 and 126
         (Wp 48, 96, 128; its first 1024 lanes): the backward on the plain
         forward's outputs and chained on each checkout's own; fm, lsf,
         term and post bit for bit against the plain versions and the
         other checkout, times, bounds and resources (`fb_multi_resources`).
         Must not move (bit-equal to the other checkout, both timed): K2
         and K3 on the REL batch [3072, 24, 1024].
  serve  the eight serving kernels of the circular serving route
         (serve=<mode>): the backwards circ_backward_emv, _codes and
         _codes_es, the posterior forwards circ_post_es, _emv and _codes
         and the checkpoint pair circ_ckpt_backward and circ_ckpt_post, on
         the serve phase's realign shape [3072, 24, 1024] (the generic
         batch's kilobase pairs in the circular layout, the shipped model),
         on its caller shape [128, 24, 32768] (the fused group's caller
         pairs repeated) and on the generic batch at widths 45, 93 and 126
         (Wp 48, 96, 128; 1024 lanes): each forward on S's (bm, bls, logZ)
         of the signed stream, which every backward equals, the
         checkpoint posterior pass on this checkout's checkpoints at
         `ckpt_block`'s KB; every output bit for bit against the plain
         version and the other checkout, times, bounds (over the band's
         d1k Wp B cells) and resources (`serve_resources`,
         `ckpt_resources`).  Must not move (bit-equal to the other
         checkout, both timed): S (sv_backward) on the realign and caller
         shapes; S and M (mw_forward) on the fused group's realign bucket
         [3072, 24, 4096], S with the generic branch on its first 1024
         lanes, S and C (cx_forward) on its caller batch [128, 24, 65536].
  rel    K2 (fb_backward) and K3 (fb_forward), the REL pair, on the REL
         path's batch [3072, 24, 1024] (the generic batch's kilobase pairs,
         the shipped model), on tRNA-length segments [256, 24, 16384] and
         on the generic batch's pairs packed at widths 45, 93 and 126 (Wp
         48, 96, 128; 1024 lanes): K2 on the batch, K3 on the plain K2's
         (bm, bls, logZ) and chained on each checkout's own; bm, bls, logZ
         and post bit for bit against the plain versions and the other
         checkout, times, bounds and resources.  Must not move (bit-equal
         to the other checkout, both timed): K4 on the REL batch's
         weights.
  wavefront
         K1 (banded_nw) on the guide batch [7168, 48, 1024] and at Wp 24,
         96 and 128 (the guide's pairs packed at widths 21, 93, 126), D
         (mea_dl) on the realign bucket [3072, 24, 4096] and at Wp 48, 96
         and 128 (the bucket's pairs at widths 45, 93, 126), each on the
         outputs of R or of the fused realign pass (E, S, M, L) for the
         fused group's seeded pairs; their resources (registers, shared
         memory a block, blocks an SM, spills, lanes a block), bounds, and
         the largest difference from the plain version and from the other
         checkout on valid cells, with whether every cell is equal (0 and
         yes expected).  K4 (banded_mea) the same way on the generic
         batch [3072, 24, 1024] (the REL and generic paths' shape) and on
         the EM batch's first 2048 lanes [512, 24, 2048] (em_band), both
         with weights from the REL FB pair's posteriors (ops/mea.py
         `mea_weights`), on the bucket's closed-form weight bands
         [3072, 24, 4096] and on their first 1024 lanes at Wp 48, 96 and
         128.
  scatter
         X (scatter_lanesum) on the caller batch's flush streams
         [4, 152, 65536] with random values and the lanes' reference
         offsets drawn over rg 7168 and over rg 65536, and at the card
         test's one-row case (rg 1, [4, 41, 9000]: ~2.5e5 values in one
         row): the largest difference from the plain version and from the
         other checkout (absolute and relative) and of each (and of the
         other checkout's plain version) from a float64 sum, whether two
         launches are bit-identical, times, bound, resources and
         index_add_'s time.  Must not move: L
         (scatter_lanes) on the counts group's flush stream.
  fused  S (sv_backward), R (expand_rel), M (mw_forward), E
         (expand_streams) and C (cx_forward), and the kernels beside them
         that must not move.
         S and M on a realign bucket [3072, 24, 4096] with the shipped
         model (gap-chain branch), on [3072, 24, 1024] with a flat-gap
         model whose gap states 1 and 2 exchange mass (the generic branch,
         as --em's trained model runs it) and on the bucket's pairs at Wp
         48, 96 and 128 (gap-chain branch; where the other checkout's
         kernel refuses a shape, its error); S on a caller batch [128, 24,
         65536]; R on a guide batch [7168, 48, 1024] and on the guide's
         pairs at Wp 24, 96 and 128 (widths 21, 93, 126); E on the bucket
         without yb and on the caller batch with yb; their resources
         (`*_resources`), bounds and the largest difference from the plain
         version and from the other checkout on every cell (0 expected).
         Must not move (bit-equal to the other checkout, both timed): K1
         banded_nw on R's code bands of the guide batch.  Then the fused
         realign posteriors of the bucket (ops/fb_circ.py
         `posteriors_weights_compact`: E + S + M and the flush streams, a
         sync) on the host clock.  C (cx_forward) is timed as S and M
         are: on the caller batch with the shipped model and with the
         generic model (both coefficient forms), and on the caller's
         pairs packed at widths 45, 93 and 126 (Wp 48, 96, 128; the
         other checkout's C may refuse Wp 128), bit-equal to plain and
         to the other checkout on fl and tails.
  probe  variants of this checkout's S, R, M, E, K1 and D (PROBES:
         source edits of csrc/, in copies under build/probe/), timed
         beside the kernel they vary: S with 8 or 16 lanes a block or its
         tiles copied without cp.async, on the bucket, the caller batch
         and the generic row; R with byte stores or every code read from
         device memory (no windows) on the guide batch; M with one part of
         its work removed (outputs wrong by design) or with 4, 8, 16 or 32
         lanes a block, on the bucket (gap-chain branch) and on M's
         generic row; E with every code read from device memory (no
         windows) on the bucket and the caller batch; K1 with 4, 8 or 16
         lanes a block on the guide batch; D with every gap weight loaded
         from the sums at each diagonal (no delay line) on the bucket.
         probe_fused: the S and R variants only; probe_wavefront: the K1
         and D variants only; probe_counts: the checkpoint forward with
         8 or 16 lanes a block, with one block staging its lanes' tile
         once for all three trials (8 lanes x 3 trials a block), with at
         most 64 registers (it spills) or 80 (at 8 lanes), with its tile
         loop rolled, with its code tiles copied without cp.async, and
         with one part removed (no device memory after the first tiles,
         no block barrier), on the EM batch, the em_multi batch and its
         first trial; probe_cx: C with 8 or 16 lanes a block, tiles of 16
         diagonals, at most 64 registers, es and bm copied without
         cp.async, and with one part removed (no sink, no device memory
         after the first tiles, no block barrier), on the caller batch;
         probe_generic: the generic pair (both kernels in each variant)
         with 8 or 16 lanes a block, its tiles copied without cp.async,
         and without output tiles (each F_match and posterior value
         stored from its row's thread), on the generic batch,
         call_generic and em_band (the counts group's cells).  Named on
         the command line only: their edits follow the sources' text.
  counts scatter_lanes (L) on a realign row-flush stream [3096, 4096];
         the stored pair (counts_fwd_all + counts_bwd, the multi instances
         over multi lanes) on the EM batch [3, 512, 24, 8192] (the pair
         forced), on its first trial, on its first 1024 lanes (em32: the
         smoke's EM parity run, [3, 512, 24, 1024]) and 2048 lanes
         (em_band: --updateTheBand's E-step), on its pairs packed at
         widths 5, 13 and 29 (Wp 8, 16, 32), on the em_multi batch
         [3, 1024, 24, 4096] and its first trial: each forward on the
         batch, each backward on the plain forward's outputs, f_all, lsf,
         term and the posterior band bit-equal to plain and to the other
         checkout, the lane-summed count partials' relative difference
         from both, with bounds and resources (registers, shared memory a
         block, blocks an SM, threads a block, spills); the E-step
         (`counts_trials` / `counts_multi_trials`, host clock) with each
         pair; the kernels that must not move (`unmoved`: bit-equal to
         the other checkout, timed): the checkpoint forwards and
         backwards on the EM and em_multi batches, the generic pair
         (fb_generic_fwd, fb_generic_bwd) with a non-flat model on the
         "generic" [3072, 24, 1024] and "em_band" [512, 24, 2048]
         batches.
  probe_stored (named on the command line only): the stored pair with 8
         or 16 lanes a block, with its tiles copied without cp.async, the
         backward with a ring of three buffers or without its register
         cap, the forward at 8 lanes and 128 registers (two blocks an
         SM), and with one part removed (outputs wrong by design: no
         flush after the first tiles; the backward without its count
         partials), on the EM batch, the EM batch at width 29 (Wp 32) and
         the em_multi batch.
  probe_rel (named on the command line only): K2 and K3 with one part
         removed (no device memory after the first tiles, no recursion
         after the first two), with tiles of 8 diagonals at one row a
         thread, with three stage buffers, with at most 64 registers,
         without TMA, on the rel group's REL and tRNA cells.
  probe_wavefront_multi (named on the command line only): nw_multi with
         8 warps' worth of lanes a block whatever B and with three stage
         buffers; mea_multi at 16 lanes a block whatever B and without
         TMA; both with one part removed (outputs wrong by design: no
         device memory after the first tiles); on the multi group's
         nw_multi and mea_multi cells.
  probe_multi (named on the command line only): the multi-lane FB pair
         at 8 lanes a block whatever B or at 16 wherever `rel_lanes`
         allows them, without TMA, and with one part removed (outputs
         wrong by design: the backward's posterior scale without its exp,
         no device memory after the first tiles, no recursion after the
         first two); on the multi group's multi, call_multi and wp48
         cells and the multi batch's first 1024 lanes.
  probe_serve (named on the command line only): the serving backwards
         in S's ring of three buffers or without their register caps;
         the serving forwards by cp.async only (no TMA), with 16-diagonal
         tiles at 16 lanes a block too, or with 8-diagonal tiles
         everywhere; on the serve group's realign and caller cells.
  probe_ckpt (named on the command line only): the checkpoint posterior
         pass always pipelined (a replay and a forward warp a lane, 8
         lanes a block) or always sequential (one warp a lane replays each
         block, then runs its forward; 16 lanes a block), and with one
         part removed (outputs wrong by design: no replay after the first
         block, no forward, no flush or staging after the first blocks,
         no block barrier after the first two phases); the checkpoint
         backward without its checkpoints; on the serve group's realign
         and caller cells.
  probe_mea, probe_scatter (named on the command line only): K4 with 8,
         16 or 32 lanes a block whatever B, its weight tiles by cp.async
         (no TMA), with three or four stage buffers,
         with one part removed (no device memory after the first tiles,
         no decode after the first two), on the wavefront group's generic
         and em_band cells and the generic cell's lanes repeated to 4096;
         X with 1 or 8 cells a thread a step, with twice the lane groups,
         with one part removed (plain adds for its window's atomics, no
         value loads), on the scatter group's cells.

The other checkout's package is imported under another name and builds its
own kernels beside its sources.  A time is the CUDA-event mean over REPS
launches after a warm-up (host rows: the host clock over EM_REPS calls),
taken in the order other, this, this, other.  Prints one JSON line per
kernel group as it goes, then the whole report with the card's name and
power limit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import HBM_BYTES_PER_S, bound

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "marginalign_trna_tpu_torch"
REPS = 20
EM_REPS = 3
# Input sizes: L's flush stream (d1k, Wp, B), the EM batch's lanes and
# diagonals, the em_multi batch's problems and lanes, the generic batch's
# lanes and diagonals.
FLUSH = (3072, 24, 4096)
EM_LANES, EM_STEPS = 8192, 512
MULTI_PROBLEMS, MULTI_LANES = 14300, 4096
GENERIC_LANES, GENERIC_STEPS = 1024, 3072
# The fused group's batches: the realign bucket (diagonals, lanes; M's
# generic row takes its first M_GENERIC_LANES lanes), the caller batch
# (CALLER_UNIQUE pairs repeated to CALLER_LANES lanes), the guide batch.
BUCKET_STEPS, BUCKET_LANES = 3072, 4096
M_GENERIC_LANES = 1024
CALLER_STEPS, CALLER_LANES, CALLER_UNIQUE = 128, 65536, 4096
# The generic pair's caller batch: the caller batch's unique pairs
# repeated to the lanes of the smoke's caller_generic launch.
CALL_GENERIC_LANES = 32768
GUIDE_STEPS, GUIDE_LANES = 7168, 1024
# The rel group's tRNA-length segments: diagonals, lanes.
TRNA_STEPS, TRNA_LANES = 256, 16384
# M's wider bands: band width -> Wp.
M_WIDE = {45: 48, 93: 96, 126: 128}
# X's launches a cell compared with the plain version (the card test's
# repeat count).
LANESUM_RUNS = 20


def load_port(root, alias):
    """The port package under `root`, imported as `alias`."""
    path = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(port, name):
    return importlib.import_module(port.__name__ + "." + name)


def time_ms(fn, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ab(this_fn, other_fn, reps=REPS):
    """Times in the order other, this, this, other: (this, other, spreads)."""
    o1 = time_ms(other_fn, reps)
    t1 = time_ms(this_fn, reps)
    t2 = time_ms(this_fn, reps)
    o2 = time_ms(other_fn, reps)
    return {"ms": (t1 + t2) / 2, "other_ms": (o1 + o2) / 2,
            "speedup": (o1 + o2) / (t1 + t2),
            "ms_runs": [t1, t2], "other_ms_runs": [o1, o2]}


def noisy(rng, ref, sub=0.1, indel=0.03):
    out = []
    for base in ref:
        u = rng.random()
        if u < indel:
            continue
        out.append(base if rng.random() >= sub else int(rng.integers(0, 4)))
        if u > 1 - indel:
            out.append(int(rng.integers(0, 4)))
    return np.asarray(out, np.int8)


def models(P, ntr):
    out = []
    for t in range(ntr):
        hmm = P.PairHmm.random(seed=20 + t)
        hmm.apply_model_type_constraints()
        out.append(hmm)
    return out


def flush_stream(port, dev, seed=1):
    """(vals [d1k + wp, B], jm, rg): a mw pass's row-flush stream and tails
    (ops/expectations.py `fused_row_jmaps`) for bands whose lower edge
    steps on about half the diagonals, random values."""
    import torch

    ex = sub(port, "ops.expectations")
    d1k, wp, B = FLUSH
    rng = np.random.default_rng(seed)
    steps = rng.random((d1k, B)) < 0.5
    steps[0] = False
    lo = torch.from_numpy(np.cumsum(steps, axis=0).astype(np.int32)).to(dev)
    m = (lo[-1] + wp - 3).to(torch.int32)
    jmap, jtail = ex.fused_row_jmaps(lo, m, wp, d1k)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fl = torch.rand((d1k, B), device=dev, generator=gen)
    tail = torch.rand((wp, B), device=dev, generator=gen)
    vals, jm = ex.concat_flush_tails(fl, tail, jmap, jtail)
    rg = -(-int(m.max()) // 256) * 256
    return vals.contiguous(), jm.contiguous(), rg


def em_batch(band, seed=2, width=21):
    """EM_LANES noisy pairs of up to 250 bases, width 21 (Wp 24) unless
    `width` says otherwise."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    hi = min(251, EM_STEPS // 2 - 5)
    while len(reads) < EM_LANES:
        ref = rng.integers(0, 4, int(rng.integers(hi - 50, hi))).astype(
            np.int8)
        read = noisy(rng, ref)
        if len(read) + len(ref) + 1 <= EM_STEPS:
            reads.append(read)
            refs.append(ref)
    return band.pack_banded_batch(reads, refs, width=width,
                                  pad_steps_to=EM_STEPS)


def multi_batch(band, seed=3, width=21):
    """tRNA-scale problems (references of 70-90 bases, 12% substitutions)
    packed several per 1024-diagonal lane, at band width `width`, to 4096
    lanes."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, int(rng.integers(70, 91))).astype(np.int8)
            for _ in range(MULTI_PROBLEMS)]
    reads = [noisy(rng, r, sub=0.12) for r in refs]
    return band.pack_multi_banded_batch(reads, refs, width=width,
                                        pad_steps_to=1024,
                                        pad_batch_to=MULTI_LANES)


def generic_batch(band, seed=4, width=21):
    """Kilobase pairs (m + n near GENERIC_STEPS) for the generic pair, width
    21 unless `width` says otherwise."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    while len(reads) < GENERIC_LANES:
        ref = rng.integers(0, 4, GENERIC_STEPS // 2 - 56).astype(np.int8)
        read = noisy(rng, ref, indel=0.005)
        if len(read) + len(ref) + 1 <= GENERIC_STEPS:
            reads.append(read)
            refs.append(ref)
    return band.pack_banded_batch(reads, refs, width=width,
                                  pad_steps_to=GENERIC_STEPS)


def trna_batch(band, seed=5, width=21):
    """TRNA_LANES single tRNA-length pairs (references of 70-90 bases, 12%
    substitutions) as REL segments [TRNA_STEPS, Wp, TRNA_LANES]."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, int(rng.integers(70, 91))).astype(np.int8)
            for _ in range(TRNA_LANES)]
    reads = [noisy_fast(rng, r, sub=0.12) for r in refs]
    return band.pack_banded_batch(reads, refs, width=width,
                                  pad_steps_to=TRNA_STEPS)


def noisy_fast(rng, ref, sub=0.1, indel=0.03):
    """ref with `sub` substitutions and about `indel` deletions and
    insertions each (noisy's rates), vectorised for kilobase batches."""
    read = ref.copy()
    hit = rng.random(len(ref)) < sub
    read[hit] = rng.integers(0, 4, int(hit.sum()))
    read = read[rng.random(len(read)) >= indel]
    at = np.flatnonzero(rng.random(len(read)) < indel)
    return np.insert(read, at, rng.integers(0, 4, len(at))).astype(np.int8)


def pairs(rng, lanes, steps, slack):
    """`lanes` noisy pairs with m + n + 1 <= steps: references of
    steps / 2 - slack to steps / 2 - slack / 4 bases."""
    reads, refs = [], []
    while len(reads) < lanes:
        ref = rng.integers(0, 4, int(rng.integers(
            steps // 2 - slack, steps // 2 - slack // 4))).astype(np.int8)
        read = noisy_fast(rng, ref)
        if len(read) + len(ref) + 1 <= steps:
            reads.append(read)
            refs.append(ref)
    return reads, refs


def fused_pairs():
    """The fused and wavefront groups' pairs, drawn in this order from one
    seeded generator: the realign bucket's, the caller batch's (unique
    pairs) and the guide batch's."""
    rng = np.random.default_rng(5)
    return (pairs(rng, BUCKET_LANES, BUCKET_STEPS, 240),
            pairs(rng, CALLER_UNIQUE, CALLER_STEPS, 16),
            pairs(rng, GUIDE_LANES, GUIDE_STEPS, 200))


def compact(port, reads, refs, width, steps, cuda, repeat=1):
    """The compact batch of the pairs on the card, its lanes repeated
    `repeat` times."""
    comp = sub(port, "ops.band").pack_compact_batch(
        reads, refs, width=width, pad_steps_to=steps)
    dev = sub(port, "ops.fb_circ").compact_device_batch(comp, cuda)
    if repeat > 1:
        dev = type(dev)(*(t.repeat(1, repeat) if t.dim() == 2
                          else t.repeat(repeat) for t in dev))
    return dev


def generic_tables(fb, path):
    """The model at `path` with gap states 1 and 2 exchanging mass: flat
    gap emissions, the generic 5x5 branch of the circular kernels."""
    t = fb.tables_from_file(path)
    T = t.T.numpy().copy()
    T[1, 2] = T[2, 1] = 0.05
    T /= T.sum(axis=1, keepdims=True)
    return fb.FbTables(T, t.Ematch.numpy(), t.Egap.numpy(), t.pi.numpy())


def nbytes(*objs):
    import torch

    return sum(t.numel() * t.element_size() for t in objs
               if torch.is_tensor(t))


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


def max_diff(got, want):
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want) if g is not None)


def all_equal(got, want):
    import torch

    return all(torch.equal(g, w) for g, w in zip(got, want) if g is not None)


def kernel_resources(fc, name, cuda, shape):
    """What this checkout's launch of S, M, R or C at `shape` [d1k, Wp, B]
    gets on the card (`*_resources`)."""
    _, wp, B = shape
    if name == "expand_rel":
        return fc.expand_rel_resources(cuda, wp)
    return getattr(fc, name + "_resources")(cuda, wp, B)


def ab_exact(fc, ofc, name, args, cuda):
    """S, M, R or C (`name`) of both checkouts against the plain version on
    every cell, timed, with bound and resources; where the other
    checkout's kernel refuses the shape, its error and this kernel's
    time."""
    kernel = getattr(fc, name + "_cuda")
    got = outputs(kernel(*args))
    plain = outputs(getattr(fc, name + "_plain")(*args))
    # C's outputs are per diagonal and position; its band is es's.
    band = args[2] if name == "cx_forward" else got[0]
    shape = list(band.shape)
    row = {"shape": shape, "max_abs_err_plain": max_diff(got, plain),
           "bit_equal_plain": all_equal(got, plain),
           **bound(name, band.numel(), nbytes(*args, *got)),
           "resources": kernel_resources(fc, name, cuda, shape)}
    if name != "expand_rel":
        row["chain"] = bool(args[1])
    del plain
    other = getattr(ofc, name + "_cuda")
    try:
        ref = outputs(other(*args))
    except RuntimeError as exc:
        return {**row, "other_error": str(exc),
                "ms": time_ms(lambda: kernel(*args))}
    return {**row, "max_abs_err_other": max_diff(got, ref),
            "bit_equal_other": all_equal(got, ref),
            **ab(lambda: kernel(*args), lambda: other(*args))}


def ab_expand(fc, ofc, args, cuda):
    """E of both checkouts against the plain version (es and fr, yb on
    valid cells), timed."""
    got = fc.expand_streams_cuda(*args)
    plain = fc.expand_streams_plain(*args)
    ref = ofc.expand_streams_cuda(*args)
    valid = plain[0] >= 0

    def on_valid(out):
        return (out[0], out[2]) + ((out[1][valid],) if args[9] else ())

    d1k, wp, B = args[8], args[7], args[3].shape[1]
    return {
        "shape": [d1k, wp, B], "yb": args[9],
        "max_abs_err_plain": max_diff(on_valid(got), on_valid(plain)),
        "max_abs_err_other": max_diff(on_valid(got), on_valid(ref)),
        "equal_plain": all_equal(on_valid(got), on_valid(plain)),
        "equal_other": all_equal(on_valid(got), on_valid(ref)),
        **ab(lambda: fc.expand_streams_cuda(*args),
             lambda: ofc.expand_streams_cuda(*args)),
        **bound("expand_streams", d1k * wp * B, nbytes(*args, *got)),
        "resources": fc.expand_streams_resources(cuda, wp)}


def unmoved(this_fn, other_fn, args):
    """A kernel that must not move: bit-equal to the other checkout's,
    timed."""
    got = outputs(this_fn(*args))
    return {"shape": list(got[0].shape),
            "bit_equal_other": all_equal(got, outputs(other_fn(*args))),
            **ab(lambda: this_fn(*args), lambda: other_fn(*args))}


def wall_ab(this_fn, other_fn):
    """Host milliseconds of one call ending in a sync of each checkout
    (other, this, this, other; EM_REPS calls each after a warm-up)."""
    import torch

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EM_REPS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / EM_REPS

    o1, t1, t2, o2 = wall(other_fn), wall(this_fn), wall(this_fn), \
        wall(other_fn)
    return {"ms": (t1 + t2) / 2, "other_ms": (o1 + o2) / 2,
            "ms_runs": [t1, t2], "other_ms_runs": [o1, o2]}


def run_fused(this, other, cuda, report):
    """Fills `report` with the fused group's rows."""
    import torch

    fc, ofc = (sub(p, "ops.fb_circ_cuda") for p in (this, other))
    fcirc, ofcirc = (sub(p, "ops.fb_circ") for p in (this, other))
    wf, owf = (sub(p, "ops.wavefront_cuda") for p in (this, other))
    fb = sub(this, "ops.fb")
    band = sub(this, "ops.band")
    model = os.path.join(ROOT, PKG, "models", "last_hmm_20.txt")
    tables = fb.tables_from_file(model, cuda)
    coef, chain = fcirc.circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    wp = band.padded_band_width(21)
    bucket, caller, guide = fused_pairs()

    def show(*names):
        print(json.dumps({n: report[n] for n in names}), flush=True)

    # The realign bucket: E, S, M; S's and M's generic branch on its first
    # lanes; the fused posteriors on the host clock.
    dev = compact(this, *bucket, 21, BUCKET_STEPS, cuda)
    eargs = (ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, 21, wp,
             BUCKET_STEPS, False)
    report["expand_streams"] = ab_expand(fc, ofc, eargs, cuda)
    show("expand_streams")
    es = fc.expand_streams_cuda(*eargs)[0]
    fr, frr, lom = band.circ_mw_streams(dev.lo, 21, wp, BUCKET_STEPS)
    sargs = (coef, chain, es, dev.fink, dev.final_d)
    report["sv_backward"] = ab_exact(fc, ofc, "sv_backward", sargs, cuda)
    bm, bls, logZ = fc.sv_backward_cuda(*sargs)
    report["mw_forward"] = ab_exact(
        fc, ofc, "mw_forward", (coef, chain, es, fr, frr, lom, bm, bls,
                                logZ), cuda)
    show("sv_backward", "mw_forward")

    def cut(t):
        return t[..., :M_GENERIC_LANES].contiguous()

    del bm, bls, logZ
    gcoef, gchain = fcirc.circ_coefficients(generic_tables(fb, model))
    gargs = (gcoef, gchain, cut(es), cut(dev.fink), cut(dev.final_d))
    report["sv_backward_generic"] = ab_exact(fc, ofc, "sv_backward", gargs,
                                             cuda)
    gback = fc.sv_backward_cuda(*gargs)
    report["mw_forward_generic"] = ab_exact(
        fc, ofc, "mw_forward", (gcoef, gchain, cut(es), cut(fr), cut(frr),
                                cut(lom), *gback), cuda)
    del es, fr, frr, lom, gback
    show("sv_backward_generic", "mw_forward_generic")
    report["realign_bucket"] = {
        "shape": [BUCKET_STEPS, wp, BUCKET_LANES],
        **wall_ab(lambda: fcirc.posteriors_weights_compact(tables, dev, 21),
                  lambda: ofcirc.posteriors_weights_compact(tables, dev,
                                                            21))}
    show("realign_bucket")
    del dev
    torch.cuda.empty_cache()

    # The caller batch: E with yb, S, then C.
    cdev = compact(this, *caller, 21, CALLER_STEPS, cuda,
                   repeat=CALLER_LANES // CALLER_UNIQUE)
    ceargs = (ematch, cdev.reads, cdev.refs, cdev.lo, cdev.m, cdev.n, 21,
              wp, CALLER_STEPS, True)
    report["expand_streams_caller"] = ab_expand(fc, ofc, ceargs, cuda)
    es, yb, fl = fc.expand_streams_cuda(*ceargs)
    csargs = (coef, chain, es, cdev.fink, cdev.final_d)
    report["sv_backward_caller"] = ab_exact(fc, ofc, "sv_backward", csargs,
                                            cuda)
    back = fc.sv_backward_cuda(*csargs)
    report["cx_forward"] = ab_exact(fc, ofc, "cx_forward",
                                    (coef, chain, es, yb, fl, *back), cuda)
    del back
    gback = fc.sv_backward_cuda(gcoef, gchain, es, cdev.fink, cdev.final_d)
    report["cx_forward_generic"] = ab_exact(
        fc, ofc, "cx_forward", (gcoef, gchain, es, yb, fl, *gback), cuda)
    del cdev, es, yb, fl, gback
    show("expand_streams_caller", "sv_backward_caller", "cx_forward",
         "cx_forward_generic")

    # The guide batch: R at width 40 (Wp 48) and K1 on its outputs, then R
    # on the guide's pairs packed at widths 21, 93 and 126.
    for width in (40, 21, 93, 126):
        gdev = compact(this, *guide, width, GUIDE_STEPS, cuda)
        gwp = band.padded_band_width(width)
        name = "expand_rel" if width == 40 else "expand_rel_wp%d" % gwp
        report[name] = ab_exact(
            fc, ofc, "expand_rel", (gdev.reads, gdev.refs, gdev.lo, gdev.m,
                                    gdev.n, gwp, GUIDE_STEPS), cuda)
        show(name)
        del gdev
        torch.cuda.empty_cache()
    report["banded_nw"] = unmoved(wf.banded_nw_cuda, owf.banded_nw_cuda,
                                  guide_nw_args(this, guide, 40, cuda))
    show("banded_nw")
    torch.cuda.empty_cache()

    # C at wider bands, the caller's pairs packed at each width, then S and
    # M, the bucket's pairs packed at each width (last: a launch the other
    # checkout refuses leaves its last-error state set, and the block
    # kernels of that checkout report it at their next launch; its C at
    # Wp 128 and M at Wp 128 refuse, and S and M report their own launch).
    for width, wwp in M_WIDE.items():
        cdev = compact(this, *caller, width, CALLER_STEPS, cuda,
                       repeat=CALLER_LANES // CALLER_UNIQUE)
        wes, wyb, wfl = fc.expand_streams_cuda(
            ematch, cdev.reads, cdev.refs, cdev.lo, cdev.m, cdev.n, width,
            wwp, CALLER_STEPS, True)
        name = "cx_forward_wp%d" % wwp
        report[name] = ab_exact(
            fc, ofc, "cx_forward",
            (coef, chain, wes, wyb, wfl, *fc.sv_backward_cuda(
                coef, chain, wes, cdev.fink, cdev.final_d)), cuda)
        del cdev, wes, wyb, wfl
        torch.cuda.empty_cache()
        show(name)
    for width, wwp in M_WIDE.items():
        wdev = compact(this, *bucket, width, BUCKET_STEPS, cuda)
        wes = fc.expand_streams_cuda(ematch, wdev.reads, wdev.refs, wdev.lo,
                                     wdev.m, wdev.n, width, wwp,
                                     BUCKET_STEPS, False)[0]
        wsargs = (coef, chain, wes, wdev.fink, wdev.final_d)
        report["sv_backward_wp%d" % wwp] = ab_exact(fc, ofc, "sv_backward",
                                                    wsargs, cuda)
        name = "mw_forward_wp%d" % wwp
        report[name] = ab_exact(
            fc, ofc, "mw_forward", (coef, chain, wes,
                                    *band.circ_mw_streams(wdev.lo, width,
                                                          wwp, BUCKET_STEPS),
                                    *fc.sv_backward_cuda(*wsargs)), cuda)
        del wdev, wes
        torch.cuda.empty_cache()
        show("sv_backward_wp%d" % wwp, name)



def guide_nw_args(port, guide, width, cuda):
    """K1's inputs for the guide pairs at band width `width`, built as
    align/guide.py builds them: R's code bands, band_masks' valid band and
    shifts, the shipped scores."""
    return guide_moves_args(port, guide, width, cuda)[0]


def bucket_dl_args(port, bucket, width, cuda):
    """D's inputs for the realign bucket's pairs at band width `width`, as
    the fused realign path builds them: the posterior band and the row and
    column sums of E, S, M and L (ops/fb_circ.py
    `posteriors_weights_compact`, ops/mea.py `rowcol_sums_from_flushed`)
    with the shipped model; the CLI's gapGamma 0.5 and matchGamma 0."""
    band, fcirc = sub(port, "ops.band"), sub(port, "ops.fb_circ")
    fb, mea = sub(port, "ops.fb"), sub(port, "ops.mea")
    tables = fb.tables_from_file(
        os.path.join(ROOT, PKG, "models", "last_hmm_20.txt"), cuda)
    comp = band.pack_compact_batch(*bucket, width=width,
                                   pad_steps_to=BUCKET_STEPS)
    dev = fcirc.compact_device_batch(comp, cuda)
    _, post, flc, flr, tc, tr = fcirc.posteriors_weights_compact(
        tables, dev, width)
    accr, accc = mea.rowcol_sums_from_flushed(comp, dev, flc, flr, tc, tr)
    return (post, dev.lo, dev.m, dev.n, width, dev.final_d, dev.final_k,
            accr, accc, 0.5, 0.0)


def mea_cells(port, cuda, names=("banded_mea", "banded_mea_em_band")):
    """{cell: K4's arguments} (`names` of them): "banded_mea" on the
    generic batch [3072, 24, 1024] (the REL and generic paths' shape) and
    "banded_mea_em_band" on the EM batch's first 2048 lanes [512, 24,
    2048]; wdiag, wup and wleft from the REL FB pair's posteriors with the
    shipped model (ops/mea.py `mea_weights`, gapGamma 0.5, matchGamma 0)."""
    import torch

    band, fb = sub(port, "ops.band"), sub(port, "ops.fb")
    fbc, mea = sub(port, "ops.fb_cuda"), sub(port, "ops.mea")
    tables = fb.tables_from_file(
        os.path.join(ROOT, PKG, "models", "last_hmm_20.txt"), cuda)
    cells = {}
    for name in names:
        if name == "banded_mea":
            batch, lanes = generic_batch(band), slice(None)
        else:
            batch, lanes = em_batch(band), slice(0, 2048)
        dev = fb.device_batch(batch, cuda)
        _, post = fbc.posteriors_pre(tables, dev)
        lo = torch.from_numpy(batch.lo).to(cuda)
        wup, wleft = mea.mea_weights(post, dev.valid, lo, 0.5,
                                     int(batch.m.max()), int(batch.n.max()))
        cells[name] = tuple(t[..., lanes].contiguous() for t in (
            torch.where(post > 0, post, mea.NEG), wup, wleft, dev.valid,
            dev.s1, dev.s2, dev.final_d, dev.final_k))
        del dev, post, lo, wup, wleft
        torch.cuda.empty_cache()
    return cells


def rel_cells(port, cuda, names=("rel", "trna", "wp48", "wp96", "wp128")):
    """(cell, K2's arguments) one cell at a time (`names` of them): "rel"
    the generic batch [3072, 24, 1024] (the REL path's shape), "trna"
    tRNA-length segments [256, 24, 16384], "wp48" / "wp96" / "wp128" the
    generic batch at band widths 45, 93, 126; the shipped model's
    coefficients and premasked match emissions (ops/fb_cuda.py
    `fb_inputs`)."""
    import torch

    band, fb = sub(port, "ops.band"), sub(port, "ops.fb")
    fbc = sub(port, "ops.fb_cuda")
    tables = fb.tables_from_file(
        os.path.join(ROOT, PKG, "models", "last_hmm_20.txt"), cuda)
    widths = {"rel": (generic_batch, 21), "trna": (trna_batch, 21),
              **{"wp%d" % wp: (generic_batch, w) for w, wp in M_WIDE.items()}}
    for name in names:
        make, width = widths[name]
        dev = fb.device_batch(make(band, width=width), cuda)
        coef, em = fbc.fb_inputs(tables, dev)
        yield name, (coef, em, dev.valid, dev.s1, dev.final_d, dev.final_k)
        del dev, em
        torch.cuda.empty_cache()


def same_bits(got, want):
    """Whether every output is equal bit for bit (NaN included)."""
    import torch

    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def ab_rel(fc, ofc, bargs, cuda):
    """K2 and K3 of both checkouts against the plain versions, K3 on the
    plain K2's outputs and chained on each checkout's own: bit-equality to
    plain and other, largest differences, times, bounds, resources."""
    got = fc.fb_backward_cuda(*bargs)
    plain = fc.fb_backward_plain(*bargs)
    ref = ofc.fb_backward_cuda(*bargs)
    D1, wp, B = got[0].shape
    fargs = tuple(bargs[:4]) + tuple(plain)
    post = (fc.fb_forward_cuda(*fargs),)
    rpost = (fc.fb_forward_plain(*fargs),)
    opost = (ofc.fb_forward_cuda(*fargs),)
    chained = (fc.fb_forward_cuda(*bargs[:4], *got),)
    ochained = (ofc.fb_forward_cuda(*bargs[:4], *ref),)
    return {
        "fb_backward": {
            "shape": [D1, wp, B],
            "max_abs_err_plain": max_diff(got, plain),
            "max_abs_err_other": max_diff(got, ref),
            "bit_equal_plain": same_bits(got, plain),
            "bit_equal_other": same_bits(got, ref),
            **ab(lambda: fc.fb_backward_cuda(*bargs),
                 lambda: ofc.fb_backward_cuda(*bargs)),
            **bound("fb_backward", got[0].numel(), nbytes(*bargs, *got)),
            "resources": fc.fb_rel_resources(cuda, wp, B, True)},
        "fb_forward": {
            "shape": [D1, wp, B],
            "max_abs_err_plain": max_diff(post, rpost),
            "max_abs_err_other": max_diff(post, opost),
            "bit_equal_plain": same_bits(post, rpost),
            "bit_equal_other": same_bits(post, opost),
            "chained_bit_equal_plain": same_bits(chained, rpost),
            "chained_bit_equal_other": same_bits(chained, ochained),
            **ab(lambda: fc.fb_forward_cuda(*fargs),
                 lambda: ofc.fb_forward_cuda(*fargs)),
            **bound("fb_forward", post[0].numel(), nbytes(*fargs, *post)),
            "resources": fc.fb_rel_resources(cuda, wp, B, False)}}


def run_rel(this, other, cuda, report):
    """Fills `report` with the rel group's rows."""
    import torch

    fc, ofc = (sub(p, "ops.fb_cuda") for p in (this, other))

    def show(name):
        print(json.dumps({name: report[name]}), flush=True)

    for name, bargs in rel_cells(this, cuda):
        report["rel_" + name] = ab_rel(fc, ofc, bargs, cuda)
        show("rel_" + name)
        del bargs
        torch.cuda.empty_cache()

    # Must not move: K4 on the REL batch's weights.
    wf, owf = (sub(p, "ops.wavefront_cuda") for p in (this, other))
    args = mea_cells(this, cuda, ("banded_mea",))["banded_mea"]
    report["rel_banded_mea"] = unmoved(wf.banded_mea_cuda,
                                       owf.banded_mea_cuda, args)
    show("rel_banded_mea")


def multi_cells(port, cuda, names=("multi", "call_multi", "multi_generic",
                                   "wp48", "wp96", "wp128")):
    """(cell, the forward's arguments, (fink, find, step_final)) one cell
    at a time (`names` of them): "multi" the multi batch [1024, 24, 4096]
    with the shipped model (the gap-chain branch), "call_multi" its lanes
    twice [1024, 24, 8192] (the smoke's call_multi launch), "multi_generic"
    the multi batch with the flat-gap model whose gap states 1 and 2
    exchange mass (the generic branch), "wp48" / "wp96" / "wp128" the
    multi batch packed at band widths 45, 93, 126, its first 1024 lanes;
    the premasked match emissions of the shipped model."""
    import torch

    band, fb = sub(port, "ops.band"), sub(port, "ops.fb")
    fcirc = sub(port, "ops.fb_circ")
    path = os.path.join(ROOT, PKG, "models", "last_hmm_20.txt")
    tables = fb.tables_from_file(path, cuda)
    wide = {"wp%d" % wp: w for w, wp in M_WIDE.items()}
    for name in names:
        mdev = fb.multi_device_batch(
            multi_batch(band, width=wide.get(name, 21)), cuda)
        B = {"call_multi": 2 * MULTI_LANES}.get(
            name, 1024 if name in wide else MULTI_LANES)

        def lanes(t):
            reps = -(-B // t.shape[-1])
            return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :B] \
                .contiguous()

        xb, yb, valid, s1, start, fink, find, sf = (lanes(t) for t in (
            mdev.xb, mdev.yb, mdev.valid, mdev.s1, mdev.start, mdev.fink,
            mdev.find, mdev.step_final))
        coef, chain = fcirc.circ_coefficients(
            generic_tables(fb, path) if name == "multi_generic" else tables)
        em = tables.Ematch[xb.long(), yb.long()] * valid
        yield name, (coef, chain, em, valid, s1, start, fink), (fink, find,
                                                                 sf)
        del mdev, xb, yb, valid, s1, start, fink, find, sf, em
        torch.cuda.empty_cache()


def multi_bargs(fargs, fwd, streams):
    """The backward's arguments on the forward's outputs fwd (fm, lsf,
    term): L is log(term) + lsf at each diagonal's problem's terminal
    diagonal (ops/fb.py `multi_logz`)."""
    import torch

    fink, find, sf = streams
    fm, lsf, term = fwd
    L = (torch.log(term.clamp(min=1e-30)) + lsf).gather(0, sf.long())
    return (*fargs[:2], fm, lsf, L, fargs[2], fargs[3], fargs[4], fink, find)


def ab_multi(fm, ofm, fargs, streams, cuda):
    """The multi-lane FB pair of both checkouts against the plain versions,
    the backward on the plain forward's outputs and chained on each
    checkout's own: bit-equality to plain and other, largest differences,
    times, bounds, resources."""
    got = fm.fb_multi_forward_cuda(*fargs)
    plain = fm.fb_multi_forward_plain(*fargs)
    ref = ofm.fb_multi_forward_cuda(*fargs)
    D1, wp, B = got[0].shape
    bargs = multi_bargs(fargs, plain, streams)
    post = (fm.fb_multi_backward_cuda(*bargs),)
    rpost = (fm.fb_multi_backward_plain(*bargs),)
    opost = (ofm.fb_multi_backward_cuda(*bargs),)
    chained = (fm.fb_multi_backward_cuda(*multi_bargs(fargs, got, streams)),)
    ochained = (ofm.fb_multi_backward_cuda(
        *multi_bargs(fargs, ref, streams)),)
    return {
        "fb_multi_forward": {
            "shape": [D1, wp, B], "chain": bool(fargs[1]),
            "max_abs_err_plain": max_diff(got, plain),
            "max_abs_err_other": max_diff(got, ref),
            "bit_equal_plain": same_bits(got, plain),
            "bit_equal_other": same_bits(got, ref),
            **ab(lambda: fm.fb_multi_forward_cuda(*fargs),
                 lambda: ofm.fb_multi_forward_cuda(*fargs)),
            **bound("fb_multi_forward", got[0].numel(),
                    nbytes(*fargs, *got)),
            "resources": fm.fb_multi_resources(cuda, wp, B, False)},
        "fb_multi_backward": {
            "shape": [D1, wp, B], "chain": bool(fargs[1]),
            "max_abs_err_plain": max_diff(post, rpost),
            "max_abs_err_other": max_diff(post, opost),
            "bit_equal_plain": same_bits(post, rpost),
            "bit_equal_other": same_bits(post, opost),
            "chained_bit_equal_plain": same_bits(chained, rpost),
            "chained_bit_equal_other": same_bits(chained, ochained),
            "post_finite": bool(post[0].isfinite().all()),
            **ab(lambda: fm.fb_multi_backward_cuda(*bargs),
                 lambda: ofm.fb_multi_backward_cuda(*bargs)),
            **bound("fb_multi_backward", post[0].numel(),
                    nbytes(*bargs, *post)),
            "resources": fm.fb_multi_resources(cuda, wp, B, True)}}


def run_fb_multi(this, other, cuda, report):
    """Fills `report` with the fb_multi group's rows."""
    import torch

    fm, ofm = (sub(p, "ops.fb_multi_cuda") for p in (this, other))

    def show(name):
        print(json.dumps({name: report[name]}), flush=True)

    for name, fargs, streams in multi_cells(this, cuda):
        report["multi_" + name] = ab_multi(fm, ofm, fargs, streams, cuda)
        show("multi_" + name)
        del fargs, streams
        torch.cuda.empty_cache()

    # Must not move: K2 and K3 on the REL batch (K3 on the plain K2's
    # outputs).
    fc, ofc = (sub(p, "ops.fb_cuda") for p in (this, other))
    for name, bargs in rel_cells(this, cuda, ("rel",)):
        report["multi_unmoved_fb_backward"] = unmoved(
            fc.fb_backward_cuda, ofc.fb_backward_cuda, bargs)
        show("multi_unmoved_fb_backward")
        fargs = tuple(bargs[:4]) + tuple(fc.fb_backward_plain(*bargs))
        report["multi_unmoved_fb_forward"] = unmoved(
            fc.fb_forward_cuda, ofc.fb_forward_cuda, fargs)
        show("multi_unmoved_fb_forward")
        del bargs, fargs
        torch.cuda.empty_cache()


def wave_multi_cells(port, cuda):
    """(cell, kernel, arguments) one cell at a time: nw_multi on the multi
    batch at the guide's width 40 [1024, 48, 4096] ("nw_multi") and at
    widths 21, 93, 126 ("nw_multi_wp24" ...), mea_multi with random
    weights (wdiag in [0, 1), wup and wleft in [0, 0.5)) at width 21
    [1024, 24, 4096] ("mea_multi") and at widths 40, 93, 126; both on the
    batch's lanes repeated to 4101 ("nw_multi_odd" at width 40,
    "mea_multi_odd" at width 21)."""
    import torch

    fb, band = sub(port, "ops.fb"), sub(port, "ops.band")
    params = tuple(sub(port, "ops.nw").NwParams())
    gen = torch.Generator(device=cuda).manual_seed(6)

    def odd(t):
        return torch.cat([t, t[..., :5]], dim=-1).contiguous()

    for width in (40, 21, 93, 126):
        wp = band.padded_band_width(width)
        mdev = fb.multi_device_batch(multi_batch(band, width=width), cuda)
        streams = (mdev.valid, mdev.s1, mdev.s2, mdev.start, mdev.fink,
                   mdev.find)
        nw = (params, mdev.xb, mdev.yb, *streams)
        weights = tuple(
            torch.rand(tuple(mdev.xb.shape), device=cuda, generator=gen) * c
            for c in (1.0, 0.5, 0.5))
        mea = (*weights, *streams)
        yield ("nw_multi" if width == 40 else "nw_multi_wp%d" % wp,
               "nw_multi", nw)
        if width == 40:
            yield "nw_multi_odd", "nw_multi", (params, *map(odd, nw[1:]))
        yield ("mea_multi" if width == 21 else "mea_multi_wp%d" % wp,
               "mea_multi", mea)
        if width == 21:
            yield "mea_multi_odd", "mea_multi", tuple(map(odd, mea))
        del mdev, streams, nw, weights, mea
        torch.cuda.empty_cache()


def ab_wave_multi(wf, owf, name, args, cuda):
    """nw_multi or mea_multi (`name`) of both checkouts against the plain
    version: pointers and term bit for bit, largest differences, timed,
    with bound and resources."""
    kernel, other = getattr(wf, name + "_cuda"), getattr(owf, name + "_cuda")
    got = kernel(*args)
    plain = getattr(wf, name + "_plain")(*args)
    ref = other(*args)
    D1, wp, B = got[0].shape
    return {
        "shape": [D1, wp, B],
        "max_abs_err_plain": max_diff(got, plain),
        "max_abs_err_other": max_diff(got, ref),
        "bit_equal_plain": all_equal(got, plain),
        "bit_equal_other": all_equal(got, ref),
        **ab(lambda: kernel(*args), lambda: other(*args)),
        **bound(name, got[0].numel(), nbytes(*args, *got)),
        "resources": wf.warp_lane_resources(name, cuda, wp, B)}


def run_multi(this, other, cuda, report):
    """Fills `report` with the multi group's rows."""
    import torch

    wf, owf = (sub(p, "ops.wavefront_cuda") for p in (this, other))

    def show(name):
        print(json.dumps({name: report[name]}), flush=True)

    for cell, name, args in wave_multi_cells(this, cuda):
        report["multi_" + cell] = ab_wave_multi(wf, owf, name, args, cuda)
        show("multi_" + cell)
        del args
        torch.cuda.empty_cache()

    # Must not move: K1 on the guide batch, K4 on the generic batch and on
    # its lanes repeated to 4096, the multi-lane FB pair on the multi batch
    # (the backward on this checkout's forward outputs).
    _, _, guide = fused_pairs()
    report["multi_unmoved_banded_nw"] = unmoved(
        wf.banded_nw_cuda, owf.banded_nw_cuda,
        guide_nw_args(this, guide, 40, cuda))
    show("multi_unmoved_banded_nw")
    k4 = mea_cells(this, cuda, ("banded_mea",))["banded_mea"]
    for cell, args in (("banded_mea", k4), ("banded_mea_x4", tuple(
            t.repeat(*([1] * (t.dim() - 1)), 4).contiguous() for t in k4))):
        report["multi_unmoved_" + cell] = unmoved(
            wf.banded_mea_cuda, owf.banded_mea_cuda, args)
        show("multi_unmoved_" + cell)
    del k4
    torch.cuda.empty_cache()
    fm, ofm = (sub(p, "ops.fb_multi_cuda") for p in (this, other))
    for _, fargs, streams in multi_cells(this, cuda, ("multi",)):
        report["multi_unmoved_fb_multi_forward"] = unmoved(
            fm.fb_multi_forward_cuda, ofm.fb_multi_forward_cuda, fargs)
        show("multi_unmoved_fb_multi_forward")
        bargs = multi_bargs(fargs, fm.fb_multi_forward_cuda(*fargs), streams)
        report["multi_unmoved_fb_multi_backward"] = unmoved(
            fm.fb_multi_backward_cuda, ofm.fb_multi_backward_cuda, bargs)
        show("multi_unmoved_fb_multi_backward")
        del fargs, streams, bargs
        torch.cuda.empty_cache()


SERVE_KERNELS = ("circ_backward_emv", "circ_backward_codes",
                 "circ_backward_codes_es", "circ_post_es", "circ_post_emv",
                 "circ_post_codes")
CKPT_KERNELS = ("circ_ckpt_backward", "circ_ckpt_post")


def serve_cells(port, cuda, names=None):
    """(cell, circular device batch, lane repeats) one cell at a time (those
    of `names`, every one when None):
    "serve_realign" the generic batch [3072, 24, 1024], "serve_call" the
    fused group's caller pairs at CALLER_STEPS diagonals, to be repeated to
    CALL_GENERIC_LANES lanes [128, 24, 32768], "serve_wp48" / "_wp96" /
    "_wp128" the generic batch at widths 45, 93, 126."""
    import torch

    band, fb = sub(port, "ops.band"), sub(port, "ops.fb")
    cells = [("serve_realign", 21), ("serve_call", 21)] + [
        ("serve_wp%d" % wp, w) for w, wp in M_WIDE.items()]
    for name, width in cells:
        if names and name not in names:
            continue
        if name == "serve_call":
            _, caller, _ = fused_pairs()
            batch = band.pack_banded_batch(*caller, width=width,
                                           pad_steps_to=CALLER_STEPS)
            repeat = CALL_GENERIC_LANES // CALLER_UNIQUE
        else:
            batch = generic_batch(band, width=width)
            repeat = 1
        yield name, fb.circ_device_batch(batch, fb.device_batch(batch, cuda)), \
            repeat
        del batch
        torch.cuda.empty_cache()


def serve_args(port, cdev, repeat, coef, chain, table):
    """{kernel: arguments} of the serving kernels, S and the checkpoint
    pair on circular batch cdev, its lanes repeated `repeat` times: es and
    em from the codes (ops/fb_circ.py `emission_stream`), the forwards on
    S's outputs, the checkpoint posterior pass on the checkpoint
    backward's."""
    fc, fcirc = sub(port, "ops.fb_circ_cuda"), sub(port, "ops.fb_circ")

    def rep(t):
        return (t.repeat(*([1] * (t.dim() - 1)), repeat).contiguous()
                if repeat > 1 else t)

    xb, yb, fink, find = (rep(t) for t in (cdev.xb, cdev.yb, cdev.fink,
                                           cdev.final_d))
    valid = rep(cdev.valid).view(xb.dtype)
    es = fcirc.emission_stream(table, xb, yb, valid, True)
    em = fcirc.emission_stream(table, xb, yb, valid, False)
    back = fc.sv_backward_cuda(coef, chain, es, fink, find)
    codes = (coef, chain, table, xb, yb, valid)
    kb = fc.ckpt_block(xb.shape[1])
    ck = fc.circ_ckpt_backward_cuda(*codes, fink, find, kb)
    return {"sv_backward": (coef, chain, es, fink, find),
            "circ_backward_emv": (coef, chain, em, valid, fink, find),
            "circ_backward_codes": codes + (fink, find),
            "circ_backward_codes_es": codes + (fink, find),
            "circ_post_es": (coef, chain, es, *back),
            "circ_post_emv": (coef, chain, em, valid, *back),
            "circ_post_codes": codes + tuple(back),
            "circ_ckpt_backward": codes + (fink, find, kb),
            "circ_ckpt_post": codes + (fink, find, *ck, kb)}


def ab_serve(fc, ofc, name, args, cuda):
    """Serving kernel `name` of both checkouts against the plain version
    on `args`: bit-equality to plain and other, largest differences,
    times, bound over the band's cells, resources."""
    import torch

    kernel, other = (getattr(m, name + "_cuda") for m in (fc, ofc))
    got = outputs(kernel(*args))
    want = outputs(getattr(fc, name + "_plain")(*args))
    ref = outputs(other(*args))
    d1k, wp, B = next(a for a in args
                      if torch.is_tensor(a) and a.dim() == 3).shape
    res = (fc.ckpt_resources(cuda, name, wp, B, args[-1])
           if name in CKPT_KERNELS else
           fc.serve_resources(cuda, name, wp, B))
    return {"shape": [d1k, wp, B],
            "max_abs_err_plain": max_diff(got, want),
            "max_abs_err_other": max_diff(got, ref),
            "bit_equal_plain": same_bits(got, want),
            "bit_equal_other": same_bits(got, ref),
            **ab(lambda: kernel(*args), lambda: other(*args)),
            **bound(name, d1k * wp * B, nbytes(*args, *got)),
            "resources": res}


def run_serve(this, other, cuda, report):
    """Fills `report` with the serve group's rows."""
    import torch

    fc, ofc = (sub(p, "ops.fb_circ_cuda") for p in (this, other))
    fb, band = sub(this, "ops.fb"), sub(this, "ops.band")
    model = os.path.join(ROOT, PKG, "models", "last_hmm_20.txt")
    tables = fb.tables_from_file(model, cuda)
    coef, chain = sub(this, "ops.fb_circ").circ_coefficients(tables)
    table = tables.Ematch.cpu().numpy().reshape(-1)

    def show(*names):
        print(json.dumps({n: report[n] for n in names}), flush=True)

    for cell, cdev, repeat in serve_cells(this, cuda):
        args = serve_args(this, cdev, repeat, coef, chain, table)
        for name in SERVE_KERNELS + CKPT_KERNELS:
            report[cell + "_" + name] = ab_serve(fc, ofc, name, args[name],
                                                 cuda)
            show(cell + "_" + name)
        if cell in ("serve_realign", "serve_call"):
            report[cell + "_sv_backward"] = unmoved(
                fc.sv_backward_cuda, ofc.sv_backward_cuda,
                args["sv_backward"])
            show(cell + "_sv_backward")
        del args, cdev
        torch.cuda.empty_cache()

    # Must not move: S and M on the realign bucket, S's generic branch on
    # its first lanes, S and C on the caller batch.
    ematch = table
    wp = band.padded_band_width(21)
    bucket, caller, _ = fused_pairs()
    dev = compact(this, *bucket, 21, BUCKET_STEPS, cuda)
    es = fc.expand_streams_cuda(ematch, dev.reads, dev.refs, dev.lo, dev.m,
                                dev.n, 21, wp, BUCKET_STEPS, False)[0]
    sargs = (coef, chain, es, dev.fink, dev.final_d)
    report["serve_sv_backward_bucket"] = unmoved(
        fc.sv_backward_cuda, ofc.sv_backward_cuda, sargs)
    report["serve_mw_forward_bucket"] = unmoved(
        fc.mw_forward_cuda, ofc.mw_forward_cuda,
        (coef, chain, es, *band.circ_mw_streams(dev.lo, 21, wp,
                                                 BUCKET_STEPS),
         *fc.sv_backward_cuda(*sargs)))
    gcoef, gchain = sub(this, "ops.fb_circ").circ_coefficients(
        generic_tables(fb, model))
    report["serve_sv_backward_generic"] = unmoved(
        fc.sv_backward_cuda, ofc.sv_backward_cuda,
        (gcoef, gchain) + tuple(t[..., :M_GENERIC_LANES].contiguous()
                                for t in (es, dev.fink, dev.final_d)))
    show("serve_sv_backward_bucket", "serve_mw_forward_bucket",
         "serve_sv_backward_generic")
    del dev, es, sargs
    torch.cuda.empty_cache()
    cdev = compact(this, *caller, 21, CALLER_STEPS, cuda,
                   repeat=CALLER_LANES // CALLER_UNIQUE)
    es, yb, fl = fc.expand_streams_cuda(ematch, cdev.reads, cdev.refs,
                                        cdev.lo, cdev.m, cdev.n, 21, wp,
                                        CALLER_STEPS, True)
    csargs = (coef, chain, es, cdev.fink, cdev.final_d)
    report["serve_sv_backward_caller"] = unmoved(
        fc.sv_backward_cuda, ofc.sv_backward_cuda, csargs)
    report["serve_cx_forward_caller"] = unmoved(
        fc.cx_forward_cuda, ofc.cx_forward_cuda,
        (coef, chain, es, yb, fl, *fc.sv_backward_cuda(*csargs)))
    show("serve_sv_backward_caller", "serve_cx_forward_caller")


def lanesum_cells(port, cuda):
    """{cell: X's arguments (vals, jm, rg)}: the caller batch's flush
    streams [128 + 24, 65536] (the fused group's CALLER_UNIQUE pairs
    repeated) with four random value planes, the lanes' reference offsets
    drawn over rg = 7168 ("scatter_lanesum": the smoke's two 3.5 kb
    references) and over rg = 65536 ("scatter_lanesum_rg65536": a
    reference set of some hundred tRNA genes and more); targets as
    ops/expectations.py `fused_flush_jmaps` gives them."""
    import torch

    ex = sub(port, "ops.expectations")
    _, caller, _ = fused_pairs()
    cdev = compact(port, *caller, 21, CALLER_STEPS, cuda,
                   repeat=CALLER_LANES // CALLER_UNIQUE)
    wp = sub(port, "ops.band").padded_band_width(21)
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=cuda).manual_seed(8)
    fl = torch.rand((4, CALLER_STEPS, CALLER_LANES), device=cuda,
                    generator=gen)
    tails = torch.rand((4, wp, CALLER_LANES), device=cuda, generator=gen)
    n = cdev.n.long().cpu().numpy()
    cells = {}
    for name, rg in (("scatter_lanesum", 7168),
                     ("scatter_lanesum_rg65536", 65536)):
        off = torch.from_numpy(
            (rng.random(len(n)) * (rg - n + 1)).astype(np.int64)).to(cuda)
        jmap, jtail = ex.fused_flush_jmaps(cdev.lo, off, cdev.n, 21, wp,
                                           CALLER_STEPS)
        vals, jm = ex.concat_flush_tails(fl, tails, jmap, jtail)
        cells[name] = (vals.contiguous(), jm.contiguous(), rg)
    # tests/test_torch_cuda.py's one-row case (test_scatter_lanesum_windows
    # at rg 1, 9000 lanes): ~2.5e5 values of [0, 1) in one output row.
    rng = np.random.default_rng(1 + 9000)
    vals = rng.random((4, 41, 9000)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = 0
    jm = rng.integers(0, 1, (41, 9000))
    u = rng.random((41, 9000))
    jm[u < 0.3] = -1
    jm[u > 0.97] = 1 + rng.integers(0, 9, int((u > 0.97).sum()))
    cells["scatter_lanesum_rg1"] = (torch.from_numpy(vals).to(cuda),
                                    torch.from_numpy(jm.astype(np.int32))
                                    .to(cuda), 1)
    return cells


def ab_lanesum(tb, ob, vals, jm, rg, cuda):
    """X of both checkouts against the plain version (rtol 1e-5, atol 1e-4
    as the smoke holds it) and each other, whether two launches are
    bit-identical, timed, with bound, resources and index_add_'s time."""
    import torch

    got, again = tb.scatter_lanesum_cuda(vals, jm, rg), \
        tb.scatter_lanesum_cuda(vals, jm, rg)
    ref = ob.scatter_lanesum_cuda(vals, jm, rg)
    plain = tb.scatter_lanesum_plain(vals, jm, rg)
    C = vals.shape[0]
    hit = (jm >= 0) & (jm < rg)
    n_hit = int(hit.sum())
    tgt = torch.where(hit, jm, rg).long().reshape(-1)
    src = vals.reshape(C, -1).t().contiguous()
    lib_out = torch.zeros((rg + 1, C), dtype=torch.float32, device=cuda)

    def rel(a, b):
        return ((a - b).abs() / b.abs().clamp(min=1e-6)).max().item()

    # A float64 sum, and how far each side's sums and the other checkout's
    # lie from it; whether X is within the card test's bound of its plain
    # version over RUNS launches (both checkouts, each with its own plain
    # version), and whether this X's RUNS launches are identical.
    exact = torch.zeros((rg + 1, C), dtype=torch.float64, device=cuda)
    exact.index_add_(0, tgt, src.double())
    exact = exact[:rg]
    oplain = ob.scatter_lanesum_plain(vals, jm, rg)

    def f64(a):
        """The largest difference from the float64 sum, absolute and as a
        share of the card test's bound (atol 1e-4, rtol 1e-5) there."""
        d = (a.double() - exact).abs()
        return [d.max().item(),
                (d / (1e-4 + 1e-5 * exact.abs())).max().item()]

    runs, oruns, same = 0, 0, True
    for _ in range(LANESUM_RUNS):
        x, ox = tb.scatter_lanesum_cuda(vals, jm, rg), \
            ob.scatter_lanesum_cuda(vals, jm, rg)
        runs += bool(torch.allclose(x, plain, rtol=1e-5, atol=1e-4))
        oruns += bool(torch.allclose(ox, oplain, rtol=1e-5, atol=1e-4))
        same = same and bool(torch.equal(x, got))
    return {
        "shape": list(vals.shape), "rg": rg, "target_cells": n_hit,
        "f64_max_abs_err": f64(got), "other_f64_max_abs_err": f64(ref),
        "plain_f64_max_abs_err": f64(plain),
        "other_plain_f64_max_abs_err": f64(oplain),
        "within_plain_runs": [runs, LANESUM_RUNS],
        "other_within_plain_runs": [oruns, LANESUM_RUNS],
        "runs_identical": same,
        "max_abs_err_plain": (got - plain).abs().max().item(),
        "max_rel_err_plain": rel(got, plain),
        "within_plain": bool(torch.allclose(got, plain, rtol=1e-5,
                                            atol=1e-4)),
        "max_abs_err_other": (got - ref).abs().max().item(),
        "max_rel_err_other": rel(got, ref),
        "repeat_identical": bool(torch.equal(got, again)),
        **ab(lambda: tb.scatter_lanesum_cuda(vals, jm, rg),
             lambda: ob.scatter_lanesum_cuda(vals, jm, rg)),
        "library_ms": time_ms(lambda: lib_out.index_add_(0, tgt, src)),
        **bound("scatter_lanesum", n_hit,
                nbytes(jm, got) + n_hit * C * vals.element_size()),
        "resources": tb.scatter_lanesum_resources(cuda, C, vals.shape[2],
                                                  rg)}


def run_scatter(this, other, cuda, report):
    """Fills `report` with the scatter group's rows: X on both lanesum
    cells; L, which must not move (bit-equal to the other checkout, timed),
    on the counts group's flush stream."""
    import torch

    tb, ob = (sub(p, "ops.bucket_scatter") for p in (this, other))
    for name, (vals, jm, rg) in lanesum_cells(this, cuda).items():
        report[name] = ab_lanesum(tb, ob, vals, jm, rg, cuda)
        print(json.dumps({name: report[name]}), flush=True)
        del vals, jm
        torch.cuda.empty_cache()
    report["scatter_lanes"] = unmoved(tb.scatter_lanes_cuda,
                                      ob.scatter_lanes_cuda,
                                      flush_stream(this, cuda))
    print(json.dumps({"scatter_lanes": report["scatter_lanes"]}), flush=True)


def ab_wave(wf, owf, name, args, valid, cuda):
    """K1, K4 or D (`name`) of both checkouts against the plain version:
    largest differences on valid cells, whether every cell is equal,
    timed, with bound and resources."""
    kernel, other = getattr(wf, name + "_cuda"), getattr(owf, name + "_cuda")
    got = kernel(*args)
    plain = getattr(wf, name + "_plain")(*args)
    ref = other(*args)

    def on_valid(out):
        return (out[0][valid],) + tuple(out[1:])

    D1, wp, B = got[0].shape
    return {
        "shape": [D1, wp, B],
        "max_abs_err_plain": max_diff(on_valid(got), on_valid(plain)),
        "max_abs_err_other": max_diff(on_valid(got), on_valid(ref)),
        "all_cells_equal_plain": all_equal(got, plain),
        "all_cells_equal_other": all_equal(got, ref),
        **ab(lambda: kernel(*args), lambda: other(*args)),
        **bound(name, got[0].numel(), nbytes(*args, *got)),
        "resources": wf.warp_lane_resources(name, cuda, wp, B)}


def run_wavefront(this, other, cuda, report):
    """Fills `report` with the wavefront group's rows."""
    import torch

    wf, owf = (sub(p, "ops.wavefront_cuda") for p in (this, other))
    band, fb = sub(this, "ops.band"), sub(this, "ops.fb")
    bucket, _, guide = fused_pairs()

    def show(name):
        print(json.dumps({name: report[name]}), flush=True)

    # K1 on the guide batch (width 40, Wp 48), then at Wp 24, 96 and 128.
    for width in (40, 21, 93, 126):
        args = guide_nw_args(this, guide, width, cuda)
        name = "banded_nw" if width == 40 else \
            "banded_nw_wp%d" % band.padded_band_width(width)
        report[name] = ab_wave(wf, owf, "banded_nw", args, args[3], cuda)
        show(name)
        del args
        torch.cuda.empty_cache()

    # K4 on the REL / generic path's [3072, 24, 1024] and on em_band's
    # [512, 24, 2048] (--updateTheBand's realign of the EM batch's first
    # 2048 lanes), weights from the FB pair's posteriors as ops/mea.py
    # builds them.
    for name, args in mea_cells(this, cuda).items():
        report[name] = ab_wave(wf, owf, "banded_mea", args, args[3], cuda)
        show(name)
        del args
        torch.cuda.empty_cache()

    # D on the realign bucket (width 21, Wp 24), then at Wp 48, 96 and 128;
    # K4 on the bucket's closed-form weight bands: all 4096 lanes at Wp 24,
    # the first 1024 lanes (the REL path's batch) at the wider bands.
    for width in (21, *M_WIDE):
        wp = band.padded_band_width(width)
        args = bucket_dl_args(this, bucket, width, cuda)
        post, lo, m, n = args[:4]
        valid, s1, s2 = band.band_masks(lo, m, n, width, wp)
        name = "mea_dl" if width == 21 else "mea_dl_wp%d" % wp
        report[name] = ab_wave(wf, owf, "mea_dl", args, valid, cuda)
        show(name)
        lanes = slice(None) if width == 21 else slice(0, 1024)
        kargs = tuple(t[..., lanes].contiguous() for t in (
            torch.where(post > 0, post, wf.NEG),
            *wf.mea_dl_gap_bands(lo, args[7], args[8], 0.5, wp), valid, s1,
            s2, args[5], args[6]))
        del args, post, lo, m, n, valid, s1, s2
        torch.cuda.empty_cache()
        name = "banded_mea_bucket" if width == 21 else \
            "banded_mea_wp%d" % wp
        report[name] = ab_wave(wf, owf, "banded_mea", kargs, kargs[3], cuda)
        show(name)
        del kargs
        torch.cuda.empty_cache()



def probe_port(name, source, edits):
    """A copy of this checkout's port under build/probe/<name> with
    csrc/<source> edited, its kernels built, imported as probe_<name>.  An
    edit (old, new) applies to `source`, an edit (file, old, new) to
    csrc/<file>."""
    import shutil

    root = os.path.join(ROOT, "build", "probe", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit in edits:
        where, old, new = edit if len(edit) == 3 else (source, *edit)
        path = os.path.join(root, PKG, "csrc", where)
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise RuntimeError("probe %s: edit anchor not found once" % name)
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    port = load_port(root, "probe_" + name)
    sub(port, "ops._build").load()
    return port


def probe_cases(this, cuda, kernels):
    """{kernel: {case: wrapper arguments}} for the probe group's kernels
    of `kernels`: M on the bucket (gap-chain branch) and on M's generic
    row, E on the bucket and the caller batch, K1 on the guide batch, D on
    the bucket, C on the caller batch, the checkpoint forwards on the EM
    batch and on the em_multi batch (and its first trial)."""
    fc = sub(this, "ops.fb_circ_cuda")
    fcirc = sub(this, "ops.fb_circ")
    fb = sub(this, "ops.fb")
    band = sub(this, "ops.band")
    model = os.path.join(ROOT, PKG, "models", "last_hmm_20.txt")
    tables = fb.tables_from_file(model, cuda)
    coef, chain = fcirc.circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    wp = band.padded_band_width(21)
    bucket, caller, guide = fused_pairs()
    cases = {}
    if "banded_nw" in kernels:
        cases["banded_nw"] = {"guide": guide_nw_args(this, guide, 40, cuda)}
    if "mea_dl" in kernels:
        cases["mea_dl"] = {"bucket": bucket_dl_args(this, bucket, 21, cuda)}
    if "expand_rel" in kernels:
        gdev = compact(this, *guide, 40, GUIDE_STEPS, cuda)
        cases["expand_rel"] = {"guide": (gdev.reads, gdev.refs, gdev.lo,
                                         gdev.m, gdev.n,
                                         band.padded_band_width(40),
                                         GUIDE_STEPS)}
    if {"counts_fwd_ckpt", "counts_multi_fwd_ckpt"} & set(kernels):
        P, fbc = sub(this, "models.hmm"), sub(this, "ops.fb_counts")
        tables = fb.tables_stacked(models(P, 3), cuda)
        tabs = (tables.T, tables.Ematch, tables.Egap)
        *streams, _ = fbc.kernel_inputs(fb.device_batch(em_batch(band),
                                                        cuda))
        cases["counts_fwd_ckpt"] = {"em": (*tabs, *streams)}
        *mstreams, _ = fbc.multi_kernel_inputs(fb.multi_device_batch(
            multi_batch(band), cuda))
        cases["counts_multi_fwd_ckpt"] = {
            "em_multi": (*tabs, *mstreams),
            "em_multi_one_trial": (*(t[:1].contiguous() for t in tabs),
                                   *mstreams)}
    if {"fb_generic_fwd", "fb_generic_bwd"} & set(kernels):
        tg = sub(this, "ops.fb_generic_cuda")
        fbc = sub(this, "ops.fb_counts")
        gtabs = generic_pair_tables(this, cuda)
        cases["fb_generic_fwd"], cases["fb_generic_bwd"] = {}, {}
        for name, (streams, fd) in generic_cells(
                this, cuda, ("generic", "call_generic", "em_band")).items():
            cases["fb_generic_fwd"][name + "_fwd"] = (*gtabs, *streams)
            fm, lsf, term = tg.fb_generic_fwd_cuda(*gtabs, *streams)
            lz = fbc.logz_from_terminal(lsf[None], term[None], fd)[0]
            cases["fb_generic_bwd"][name + "_bwd"] = (*gtabs, fm, lsf,
                                                      *streams, fd, lz)
    if set(_ST) & set(kernels):
        P, fbc = sub(this, "models.hmm"), sub(this, "ops.fb_counts")
        tc = sub(this, "ops.fb_counts_cuda")
        tables = fb.tables_stacked(models(P, 3), cuda)
        tabs = (tables.T, tables.Ematch, tables.Egap)
        *streams, fd = fbc.kernel_inputs(fb.device_batch(em_batch(band),
                                                         cuda))
        f_all, lsf, term = tc.counts_fwd_all_cuda(*tabs, *streams)
        cases["counts_fwd_all"] = {"em_fwd": (*tabs, *streams)}
        cases["counts_bwd"] = {"em_bwd": (
            *tabs, f_all, lsf, *streams, fd,
            fbc.logz_from_terminal(lsf, term, fd))}
        # The EM batch at width 29 (Wp 32: the backward takes 8 lanes).
        *streams, fd = fbc.kernel_inputs(fb.device_batch(
            em_batch(band, width=29), cuda))
        f_all, lsf, term = tc.counts_fwd_all_cuda(*tabs, *streams)
        cases["counts_fwd_all"]["em_wp32_fwd"] = (*tabs, *streams)
        cases["counts_bwd"]["em_wp32_bwd"] = (
            *tabs, f_all, lsf, *streams, fd,
            fbc.logz_from_terminal(lsf, term, fd))
        mdev = fb.multi_device_batch(multi_batch(band), cuda)
        *mstreams, mfd = fbc.multi_kernel_inputs(mdev)
        f_all, lsf, term = tc.counts_multi_fwd_all_cuda(*tabs, *mstreams)
        cases["counts_multi_fwd_all"] = {"em_multi_fwd": (*tabs, *mstreams)}
        cases["counts_multi_bwd"] = {"em_multi_bwd": (
            *tabs, f_all, lsf, *mstreams, mfd,
            fb.multi_logz(lsf, term, mdev)[0])}
    if {"fb_backward", "fb_forward"} & set(kernels):
        fbc = sub(this, "ops.fb_cuda")
        cases["fb_backward"], cases["fb_forward"] = {}, {}
        for name, bargs in rel_cells(this, cuda, ("rel", "trna")):
            cases["fb_backward"][name + "_bwd"] = bargs
            cases["fb_forward"][name + "_fwd"] = (
                *bargs[:4], *fbc.fb_backward_cuda(*bargs))
    if set(_MULTI) & set(kernels):
        fm = sub(this, "ops.fb_multi_cuda")
        cases["fb_multi_forward"], cases["fb_multi_backward"] = {}, {}
        for name, fargs, streams in multi_cells(
                this, cuda, ("multi", "call_multi", "wp48")):
            cases["fb_multi_forward"][name + "_fwd"] = fargs
            cases["fb_multi_backward"][name + "_bwd"] = multi_bargs(
                fargs, fm.fb_multi_forward_cuda(*fargs), streams)
        # The multi batch's first 1024 lanes (8 lanes a block: 128 blocks).
        for k, case in (("fb_multi_forward", "multi_fwd"),
                        ("fb_multi_backward", "multi_bwd")):
            cases[k][case[:-4] + "_1024" + case[-4:]] = tuple(
                t[..., :1024].contiguous() if hasattr(t, "dim")
                and t.dim() >= 2 else t for t in cases[k][case])
    if "banded_mea" in kernels:
        cases["banded_mea"] = mea_cells(this, cuda)
        # The generic cell's lanes repeated to the bucket's 4096.
        cases["banded_mea"]["banded_mea_x4"] = tuple(
            t.repeat(*([1] * (t.dim() - 1)), 4).contiguous()
            for t in cases["banded_mea"]["banded_mea"])
    if "scatter_lanesum" in kernels:
        cases["scatter_lanesum"] = lanesum_cells(this, cuda)
    if {"nw_moves", "mea_moves"} & set(kernels):
        cases["nw_moves"], cases["mea_moves"] = {}, {}
        for cell, name, args, _ in traceback_cells(
                this, cuda, ("nw_moves", "mea_moves", "mea_moves_rel")):
            cases[name][cell] = args
    if {"nw_multi", "mea_multi"} & set(kernels):
        cases["nw_multi"], cases["mea_multi"] = {}, {}
        for cell, name, args in wave_multi_cells(this, cuda):
            if cell in ("nw_multi", "mea_multi", "mea_multi_odd"):
                cases[name][cell] = args
    if set(SERVE_KERNELS + CKPT_KERNELS) & set(kernels):
        table = ematch
        for name in SERVE_KERNELS + CKPT_KERNELS:
            cases[name] = {}
        for cell, cdev, repeat in serve_cells(this, cuda, ("serve_realign",
                                                           "serve_call")):
            args = serve_args(this, cdev, repeat, coef, chain, table)
            for name in SERVE_KERNELS + CKPT_KERNELS:
                cases[name][cell + "_" + name] = args[name]
    if "cx_forward" in kernels:
        cdev = compact(this, *caller, 21, CALLER_STEPS, cuda,
                       repeat=CALLER_LANES // CALLER_UNIQUE)
        es, yb, fl = fc.expand_streams_cuda(
            ematch, cdev.reads, cdev.refs, cdev.lo, cdev.m, cdev.n, 21, wp,
            CALLER_STEPS, True)
        cases["cx_forward"] = {"caller": (coef, chain, es, yb, fl,
                                          *fc.sv_backward_cuda(
                                              coef, chain, es, cdev.fink,
                                              cdev.final_d))}
    if not {"mw_forward", "expand_streams", "sv_backward"} & set(kernels):
        return {k: v for k, v in cases.items() if k in kernels}
    dev = compact(this, *bucket, 21, BUCKET_STEPS, cuda)
    eargs = (ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, 21, wp,
             BUCKET_STEPS, False)
    es = fc.expand_streams_cuda(*eargs)[0]
    fr, frr, lom = band.circ_mw_streams(dev.lo, 21, wp, BUCKET_STEPS)
    cdev = compact(this, *caller, 21, CALLER_STEPS, cuda,
                   repeat=CALLER_LANES // CALLER_UNIQUE)

    def cut(t):
        return t[..., :M_GENERIC_LANES].contiguous()

    gcoef, gchain = fcirc.circ_coefficients(generic_tables(fb, model))
    cases["mw_forward"] = {
        "chain": (coef, chain, es, fr, frr, lom, *fc.sv_backward_cuda(
            coef, chain, es, dev.fink, dev.final_d)),
        "generic": (gcoef, gchain, cut(es), cut(fr), cut(frr), cut(lom),
                    *fc.sv_backward_cuda(gcoef, gchain, cut(es),
                                         cut(dev.fink), cut(dev.final_d)))}
    cases["sv_backward"] = {
        "bucket": (coef, chain, es, dev.fink, dev.final_d),
        "caller": (coef, chain, fc.expand_streams_cuda(
            ematch, cdev.reads, cdev.refs, cdev.lo, cdev.m, cdev.n, 21, wp,
            CALLER_STEPS, False)[0], cdev.fink, cdev.final_d),
        "generic": (gcoef, gchain, cut(es), cut(dev.fink),
                    cut(dev.final_d))}
    cases["expand_streams"] = {
        "bucket": eargs,
        "caller": (ematch, cdev.reads, cdev.refs, cdev.lo, cdev.m, cdev.n,
                   21, wp, CALLER_STEPS, True)}
    return {k: v for k, v in cases.items() if k in kernels}


def probed(kernel):
    """The kernels a PROBES variant varies: its kernel or tuple of them."""
    return kernel if isinstance(kernel, tuple) else (kernel,)


def run_probe(this, other, cuda, report, kernels=None):
    """Fills `report["probe"]` with the time of this checkout's kernels of
    `kernels` (every kernel PROBES varies when None) on their probe cases
    (`probe_cases`), beside each PROBES variant of that kernel timed in
    turn (this, the variants, this again); and whether each variant's
    outputs equal this checkout's."""
    import torch

    kernels = kernels or tuple(dict.fromkeys(
        k for v, _, _ in PROBES.values() for k in probed(v)))
    cases = probe_cases(this, cuda, kernels)
    variants = {name: (probed(kernel), probe_port(name, source, edits))
                for name, (kernel, source, edits) in PROBES.items()
                if set(probed(kernel)) & set(kernels)}
    rows = {}
    for kernel, kcases in cases.items():
        for case, args in kcases.items():
            fn = getattr(sub(this, KERNEL_MODULES[kernel]), kernel + "_cuda")
            want = outputs(fn(*args))
            row = {"kernel": kernel, "shape": list(want[0].shape),
                   "this_ms_runs": [time_ms(lambda: fn(*args))]}
            for name, (vkernels, vport) in variants.items():
                if kernel not in vkernels:
                    continue
                vfn = getattr(sub(vport, KERNEL_MODULES[kernel]),
                              kernel + "_cuda")
                try:
                    row[name] = {"ms": time_ms(lambda: vfn(*args)),
                                 "equal_this": all_equal(
                                     outputs(vfn(*args)), want)}
                except RuntimeError as exc:  # a shape the variant refuses
                    row[name] = {"error": str(exc)}
                print(json.dumps({"probe": {case: {name: row[name]}}}),
                      flush=True)
            row["this_ms_runs"].append(time_ms(lambda: fn(*args)))
            rows[case] = row
            del want
            torch.cuda.empty_cache()
    report.setdefault("probe", {}).update(rows)
    print(json.dumps({"probe": rows}), flush=True)


def ab_stored(this, other, tabs, streams, fd, norm, multi, cuda):
    """The stored pair (counts_fwd_all + counts_bwd, or their counts_multi_
    instances) of both checkouts on one batch: the forward on the streams,
    the backward on the plain forward's outputs and norm(lsf, term) (logZ
    or L); f_all, lsf, term and the posterior band against the plain
    version and the other checkout, the lane-summed count partials' largest
    relative difference from both, both kernels timed, with bounds and
    resources."""
    import torch

    tc, oc = (sub(p, "ops.fb_counts_cuda") for p in (this, other))
    fname, bname = (("counts_multi_fwd_all", "counts_multi_bwd") if multi
                    else ("counts_fwd_all", "counts_bwd"))
    fargs = (*tabs, *streams)
    ntr = tabs[0].shape[0]
    d1k, wp, B = streams[0].shape
    cells = ntr * streams[0].numel()
    kernel, okernel = (getattr(m, fname + "_cuda") for m in (tc, oc))
    got = kernel(*fargs)
    plain = getattr(tc, fname + "_plain")(*fargs)
    ref = okernel(*fargs)
    row = {"shape": [ntr, d1k, wp, B], "fwd": {
        "max_abs_err_plain": max_diff(got, plain),
        "bit_equal_plain": all_equal(got, plain),
        "bit_equal_other": all_equal(got, ref),
        **bound(fname, cells, nbytes(*fargs, *got)),
        "resources": tc.stored_resources(cuda, wp, B, ntr, multi)}}
    del got, ref
    torch.cuda.empty_cache()
    row["fwd"].update(ab(lambda: kernel(*fargs), lambda: okernel(*fargs)))
    f_all, lsf, term = plain
    bargs = (*tabs, f_all, lsf, *streams, fd, norm(lsf, term))
    kernel, okernel = (getattr(m, bname + "_cuda") for m in (tc, oc))
    got = kernel(*bargs)
    want = getattr(tc, bname + "_plain")(*bargs)
    ref = okernel(*bargs)
    row["bwd"] = {
        "post_max_abs_err_plain": max_diff(got[:1], want[:1]),
        "post_bit_equal_plain": all_equal(got[:1], want[:1]),
        "post_bit_equal_other": all_equal(got[:1], ref[:1]),
        "counts_rel_err_plain": counts_rel(got[1:], want[1:]),
        "counts_rel_err_other": counts_rel(got[1:], ref[1:]),
        **bound(bname, cells, nbytes(*bargs, *got)),
        "resources": tc.stored_resources(cuda, wp, B, ntr, multi,
                                         backward=True)}
    del got, want, ref
    torch.cuda.empty_cache()
    row["bwd"].update(ab(lambda: kernel(*bargs), lambda: okernel(*bargs)))
    return row


def generic_pair_tables(port, cuda):
    """The shipped model with its first gap state's emissions perturbed
    (not flat), as the generic pair takes it: (T, Ematch, Egap)."""
    P, fb = sub(port, "models.hmm"), sub(port, "ops.fb")
    hmm = P.PairHmm.load(os.path.join(ROOT, PKG, "models", "last_hmm_20.txt"))
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    t = fb.tables_from_hmm(hmm, cuda)
    return (t.T, t.Ematch, t.Egap)


def generic_cells(port, cuda, names=None):
    """{cell: (the forward's streams (xb, yb, valid, s1, fink), find)} of the
    generic pair's batches (`names` of them, all when None): "generic"
    [3072, 24, 1024] (marginAlign --inputModel), "call_generic" [128, 24,
    32768] (marginCaller --alignmentModel: the CALLER_UNIQUE pairs of the
    fused group's caller batch repeated), "em_band" [512, 24, 2048] (--em
    --updateTheBand: the EM batch's first 2048 lanes) and the generic
    batch's pairs packed at widths 5, 13 and 29 (Wp 8, 16, 32)."""
    import torch

    band, fb = sub(port, "ops.band"), sub(port, "ops.fb")
    fbc = sub(port, "ops.fb_counts")
    names = names or ("generic", "call_generic", "em_band", "generic_wp8",
                      "generic_wp16", "generic_wp32")

    def kernel_streams(batch, lanes=None, repeat=1):
        xb, yb, valid, s1, fk, fd = fbc.kernel_inputs(
            fb.device_batch(batch, cuda))
        out = []
        for t in (xb, yb, valid, s1, fk, fd):
            t = t[..., :lanes] if lanes else t
            out.append((t.repeat(*([1] * (t.dim() - 1)), repeat)
                        if repeat > 1 else t).contiguous())
        return tuple(out[:5]), out[5]

    cells = {}
    for name in names:
        if name == "call_generic":
            _, caller, _ = fused_pairs()
            batch = band.pack_banded_batch(*caller, width=21,
                                           pad_steps_to=CALLER_STEPS)
            cells[name] = kernel_streams(
                batch, repeat=CALL_GENERIC_LANES // CALLER_UNIQUE)
        elif name == "em_band":
            cells[name] = kernel_streams(em_batch(band), lanes=2048)
        else:
            width = {"generic": 21, "generic_wp8": 5, "generic_wp16": 13,
                     "generic_wp32": 29}[name]
            cells[name] = kernel_streams(generic_batch(band, width=width))
        torch.cuda.empty_cache()
    return cells


def sorted_pairs(reads, refs):
    """The pairs in order of m + n, as the guide and realign buckets sort
    their lanes (align/guide.py, align/realign.py)."""
    order = sorted(range(len(reads)), key=lambda i: len(reads[i]) +
                   len(refs[i]))
    return [reads[i] for i in order], [refs[i] for i in order]


def guide_moves_args(port, guide, width, cuda):
    """(K1's inputs, lo, m, n) of the guide pairs at band width `width`:
    R's code bands, band_masks' valid band and shifts, the shipped scores,
    as align/guide.py builds them, and the lanes' offsets and lengths."""
    fc, band = sub(port, "ops.fb_circ_cuda"), sub(port, "ops.band")
    wp = band.padded_band_width(width)
    gdev = compact(port, *guide, width, GUIDE_STEPS, cuda)
    xb, yb = fc.expand_rel_cuda(gdev.reads, gdev.refs, gdev.lo, gdev.m,
                                gdev.n, wp, GUIDE_STEPS)
    valid, s1, s2 = band.band_masks(gdev.lo, gdev.m, gdev.n, width, wp)
    return ((tuple(sub(port, "ops.nw").NwParams()), xb, yb, valid, s1, s2,
             gdev.final_d, gdev.final_k), gdev.lo, gdev.m, gdev.n)


def odd_lanes(args, B=4101):
    """Every tensor of `args` with its lanes (last axis) repeated to B."""
    import torch

    def wide(t):
        reps = -(-B // t.shape[-1])
        return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :B].contiguous()
    return tuple(wide(t) if torch.is_tensor(t) else t for t in args)


def traceback_cells(port, cuda, names=None):
    """(cell, kernel, its arguments, (the kernel whose pointers it walks,
    that kernel's arguments) or None) one cell at a time: nw_moves on K1's
    pointers of the guide batch [7168, 48, 1024] (its pairs sorted by
    m + n), at widths 93 and 126 (Wp 96, 128) and on its lanes repeated to
    4101 ("_odd": no multiple of 4, cp.async at a byte shift); mea_moves on
    D's pointers of the realign bucket [3072, 24, 4096] (sorted), at widths
    93 and 126 and on 4101 lanes; mea_moves on K4's pointers of the REL
    batch [3072, 24, 1024] (the generic batch, weights from the REL FB
    pair's posteriors).  `names`: those cells only."""
    import torch

    def want(*cells):
        return names is None or set(cells) & set(names)

    wf = sub(port, "ops.wavefront_cuda")
    band = sub(port, "ops.band")
    bucket, _, guide = fused_pairs()
    guide, bucket = sorted_pairs(*guide), sorted_pairs(*bucket)
    for width in (40, 93, 126):
        wp = band.padded_band_width(width)
        if not want(*(("nw_moves", "nw_moves_odd") if width == 40
                      else ("nw_moves_wp%d" % wp,))):
            continue
        k1, lo, m, n = guide_moves_args(port, guide, width, cuda)
        ptr, _, state = wf.banded_nw_cuda(*k1)
        args = (ptr, lo, m, n, state)
        if width == 40:
            if want("nw_moves"):
                yield "nw_moves", "nw_moves", args, ("banded_nw", k1)
            del k1
            torch.cuda.empty_cache()
            if want("nw_moves_odd"):
                yield "nw_moves_odd", "nw_moves", odd_lanes(args), None
        else:
            yield "nw_moves_wp%d" % wp, "nw_moves", args, None
        del args, ptr, lo, m, n, state
        torch.cuda.empty_cache()
    for width in (21, 93, 126):
        wp = band.padded_band_width(width)
        if not want(*(("mea_moves", "mea_moves_odd") if width == 21
                      else ("mea_moves_wp%d" % wp,))):
            continue
        dl = bucket_dl_args(port, bucket, width, cuda)
        ptr, _ = wf.mea_dl_cuda(*dl)
        args = (ptr, *dl[1:4])
        if width == 21:
            if want("mea_moves"):
                yield "mea_moves", "mea_moves", args, ("mea_dl", dl)
            del dl
            torch.cuda.empty_cache()
            if want("mea_moves_odd"):
                yield "mea_moves_odd", "mea_moves", odd_lanes(args), None
        else:
            del dl
            yield "mea_moves_wp%d" % wp, "mea_moves", args, None
        del args, ptr
        torch.cuda.empty_cache()
    if not want("mea_moves_rel"):
        return
    k4 = mea_cells(port, cuda, ("banded_mea",))["banded_mea"]
    batch = generic_batch(band)
    lanes = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                  .to(cuda) for a in (batch.lo, batch.m, batch.n))
    yield ("mea_moves_rel", "mea_moves",
           (wf.banded_mea_cuda(*k4)[0], *lanes), None)


def moves_slab(args, res):
    """The bytes the traceback kernel streams at its lanes a block and
    tile (`res`: moves_resources): each block's tiles from its top,
    min(D1 - 1, its largest m + n), down, the box's Wp pointer rows and lo
    row of LPB lanes a diagonal; their time at the card's memory rate (the
    slab floor); the longest block's diagonals."""
    import torch

    ptr, lo, m, n = args[:4]
    D1, wp, B = ptr.shape
    lpb, kt = res["lanes_per_block"], res["diagonals_per_tile"]
    s = (m.long() + n.long()).cpu()
    s = torch.cat([s, s.new_zeros((-B) % lpb)]).view(-1, lpb)
    tops = s.max(1).values.clamp(0, D1 - 1)
    streamed = int(((tops + kt - 1) // kt).sum()) * kt * lpb * (wp + 4)
    return {"streamed_bytes": streamed,
            "slab_ms": 1e3 * streamed / HBM_BYTES_PER_S,
            "top_diagonals": int(tops.max()), "blocks": len(tops)}


def ab_moves(tb, otb, name, args):
    """nw_moves or mea_moves (`name`) of both checkouts against the plain
    version, byte for byte, timed, with the bound (the pointer byte and
    offset of each move made, the stream and the lane arrays), resources
    and slab; where this checkout's kernel takes TMA, also on copies of
    the band 4 and 1 bytes into a buffer (so by cp.async at byte shift 0,
    then 1), timed and byte-equal."""
    import torch

    kernel, other = getattr(tb, name + "_cuda"), getattr(otb, name + "_cuda")
    got = kernel(*args)
    plain = getattr(tb, name + "_plain")(*args)
    ref = other(*args)
    D1, wp, B = args[0].shape
    made = int((tb.unpack_moves(got.cpu().numpy(), D1 - 1)
                != tb.NO_MOVE).sum())
    res = tb.moves_resources(name, args[0].device, wp, B)
    row = {"shape": [D1, wp, B], "moves": made,
           "bit_equal_plain": bool(torch.equal(got, plain)),
           "bit_equal_other": bool(torch.equal(got, ref)),
           **ab(lambda: kernel(*args), lambda: other(*args)),
           **bound(name, made, 5 * made + nbytes(got, *args[2:])),
           "resources": res, **moves_slab(args, res)}
    del plain, ref
    for at in ((4, 1) if res["route"] == "tma" else ()):
        buf = torch.empty(args[0].numel() + at, dtype=torch.uint8,
                          device=args[0].device)
        band = buf[at:].view(args[0].shape).copy_(args[0])
        sargs = (band, *args[1:])
        row["shifted_at%d" % at] = {
            "ms": time_ms(lambda: kernel(*sargs)),
            "bit_equal": bool(torch.equal(kernel(*sargs), got))}
        del buf, band, sargs
    return row


def run_traceback(this, other, cuda, report):
    """Fills `report` with the traceback group's rows."""
    import torch

    tb, otb = (sub(p, "ops.traceback_device") for p in (this, other))
    wf, owf = (sub(p, "ops.wavefront_cuda") for p in (this, other))
    for cell, name, args, upstream in traceback_cells(this, cuda):
        report["traceback_" + cell] = ab_moves(tb, otb, name, args)
        print(json.dumps({"traceback_" + cell:
                          report["traceback_" + cell]}), flush=True)
        if upstream is not None:
            # Must not move: the kernel whose pointers the cell walks.
            kname, kargs = upstream
            key = "traceback_unmoved_" + kname
            report[key] = unmoved(getattr(wf, kname + "_cuda"),
                                  getattr(owf, kname + "_cuda"), kargs)
            print(json.dumps({key: report[key]}), flush=True)
        del args, upstream
        torch.cuda.empty_cache()


def counts_rel(got, want):
    return max(((g.sum(-1) - w.sum(-1)).abs()
                / w.sum(-1).abs().clamp(min=1e-6)).max().item()
               for g, w in zip(got, want))


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


GROUPS = ("fused", "wavefront", "probe", "probe_wavefront", "probe_fused",
          "probe_counts", "probe_cx", "probe_generic", "probe_stored",
          "probe_mea", "probe_scatter", "probe_rel", "counts", "scatter",
          "rel", "serve", "probe_serve", "probe_ckpt", "multi",
          "probe_multi", "fb_multi", "probe_wavefront_multi", "traceback",
          "probe_traceback")
DEFAULT_GROUPS = ("fused", "wavefront", "counts", "scatter", "rel", "serve",
                  "multi", "fb_multi", "traceback")
# The module of the port that holds each probed kernel's wrapper.
KERNEL_MODULES = {"mw_forward": "ops.fb_circ_cuda",
                  "fb_backward": "ops.fb_cuda",
                  "fb_forward": "ops.fb_cuda",
                  "fb_multi_forward": "ops.fb_multi_cuda",
                  "fb_multi_backward": "ops.fb_multi_cuda",
                  "cx_forward": "ops.fb_circ_cuda",
                  "counts_fwd_ckpt": "ops.fb_counts_cuda",
                  "fb_generic_fwd": "ops.fb_generic_cuda",
                  "fb_generic_bwd": "ops.fb_generic_cuda",
                  "counts_multi_fwd_ckpt": "ops.fb_counts_cuda",
                  "counts_fwd_all": "ops.fb_counts_cuda",
                  "counts_bwd": "ops.fb_counts_cuda",
                  "counts_multi_fwd_all": "ops.fb_counts_cuda",
                  "counts_multi_bwd": "ops.fb_counts_cuda",
                  "expand_streams": "ops.fb_circ_cuda",
                  "sv_backward": "ops.fb_circ_cuda",
                  "expand_rel": "ops.fb_circ_cuda",
                  "banded_nw": "ops.wavefront_cuda",
                  "banded_mea": "ops.wavefront_cuda",
                  "nw_multi": "ops.wavefront_cuda",
                  "mea_multi": "ops.wavefront_cuda",
                  "scatter_lanesum": "ops.bucket_scatter",
                  **{name: "ops.fb_circ_cuda"
                     for name in SERVE_KERNELS + CKPT_KERNELS},
                  "mea_dl": "ops.wavefront_cuda",
                  "nw_moves": "ops.traceback_device",
                  "mea_moves": "ops.traceback_device"}
# The probe group's variants: name -> (the kernel it varies, or a tuple of
# the kernels it varies, its source under csrc/, edits (old, new) of that
# source).
_LANES_AT = "  *lanes = wide ? 16 : 8;"
_LANES_CASE = "    case 8: return mw_kernel_rpt<8>(Wp);"


def _lanes(n):
    """M with n lanes a block whatever B (n of 8 or 16 need no instance)."""
    edits = [(_LANES_AT, "  *lanes = %d;" % n)]
    if n not in (8, 16):
        edits.append((_LANES_CASE, "    case %d: return mw_kernel_rpt<%d>"
                      "(Wp);\n%s" % (n, n, _LANES_CASE)))
    return ("mw_forward", "fb_circ.cu", edits)


_M_PARTS = {
    # No posterior: no bm, alpha, band-relative row or accumulators.
    "no_sink": [("    sink(d, rec, post, post_rel, flc, flr);\n", "")],
    # No device memory after the first two tiles: later tiles compute on
    # the stage buffers as they are, and no output leaves.
    "no_global": [("  if (b < B) {", "  if (b < B && d0 < 2 * MW_KT) {"),
                  ("  if (b >= B) return;", "  return;")],
    # No block barrier per tile after the first two (each thread still
    # waits for its own copies).
    "no_barrier": [("    mk::cp_async_wait();\n    __syncthreads();\n",
                    "    mk::cp_async_wait();\n    if (t < 2) __syncthreads();"
                    "\n")],

    # No shuffles for the rolls (one row a thread).
    "no_roll": [("fb_circ.cuh",
                 "    out[0] = __shfl_sync(mk::FULL, v[0], kk == 0 ? Wp - 1 : "
                 "kk - 1);", "    out[0] = v[0];")],
    # No expf for the posterior's scale.
    "no_expf": [("    const float a = expf(fw.ls + rec[kk & 7].bls - fw.lz);",
                 "    const float a = fw.lz;"),
                ("    if (fw.cells(d, kb, es)) alpha = expf(fw.ls + rec.bls - "
                 "fw.lz);", "    if (fw.cells(d, kb, es)) alpha = fw.lz;")],
}
# K1 and D: probe tag -> (kernel, source, its pipeline depth constant and
# the depth it ships with).
_WAVE = {"nw": ("banded_nw", "nw.cu", "NW_STAGES", 2,
                "    if (t < tiles)\n      nw_stage<LPB, MULTI, NT>", None),
         "dl": ("mea_dl", "mea.cu", "DL_STAGES", 2,
                "    if (t < tiles) {\n      dl_stage_post<LPB>",
                "    if (regular) {")}


def _wave_parts(source, stages, default, staging, unrolled):
    """K1's or D's variants, {part: (source, edits)}: other pipeline depths
    (tiles in shared memory), D with every tile through the rolled loop,
    and with one part removed (outputs wrong by design): no device memory
    after the first tiles (later tiles compute on the stage buffers as they
    are, no pointers leave), no block barrier after the first two tiles, no
    row shuffles (csrc/common.cuh `WarpRows::roll` leaves rows in place, so
    K1 and D of that copy both change)."""
    depth = "constexpr int %s = %d;" % (stages, default)
    rolled = {"rolled": (source, [(unrolled, "    if (false) {")])} \
        if unrolled else {}
    return {
        **rolled,
        **{"stages_%d" % n: (source, [
            (depth, "constexpr int %s = %d;" % (stages, n))])
           for n in (2, 3, 4, 6) if n != default},
        "no_global": (source, [
            (staging, staging.replace("t < tiles",
                                      "t < min(tiles, %s)" % stages)),
            ("    if (t > 0) flush(t - 1);\n    stage(t + %s - 1);" % stages,
             "    if (t > 0 && t < 3) flush(t - 1);\n    stage(t + %s - 1);"
             % stages)]),
        "no_barrier": (source, [
            ("    mk::cp_async_wait_but<%s - 2>();\n    __syncthreads();"
             % stages,
             "    mk::cp_async_wait_but<%s - 2>();\n    if (t < 2) "
             "__syncthreads();" % stages)]),
        "no_shift": ("common.cuh", [
            ("  __device__ void roll(const V (&v)[RPT], V (&out)[RPT], int t) "
             "const {\n",
             "  __device__ void roll(const V (&v)[RPT], V (&out)[RPT], int t) "
             "const {\n    for (int r = 0; r < RPT; ++r) out[r] = v[r];\n"
             "    if (RPT > 0) return;\n")]),
    }


_MEA_LANES_AT = "  cudaError_t err = mea_lanes(Wp, B, tma, multi, lanes);"
_NW_LANES_CASE = "    case 8: return nw_kernel_rpt<8 * L, MULTI, T>(rpt);"
_NW_LANES_AT = ("mk::warp_lanes(\n        B, [Wp, multi](int l) { return "
                "nw_smem(Wp, l, multi); }, lanes);")
PROBES = {
    **{name: ("mw_forward", "fb_circ.cu", edits)
       for name, edits in _M_PARTS.items()},
    **{"lanes_%d" % n: _lanes(n) for n in (4, 8, 16, 32)},
    # E with every code read from device memory (no windows).
    "direct": ("expand_streams", "expand.cu",
               [("  const int wmax = e_streams_window(Wp);",
                 "  const int wmax = 0;")]),
    # K1 with n lanes a block whatever B (4 with an instance of its own).
    **{"nw_lanes_%d" % n: ("banded_nw", "nw.cu", [
        (_NW_LANES_AT, "(*lanes = %d, cudaSuccess);" % n)] + ([
        (_NW_LANES_CASE, "    case 4: return nw_kernel_rpt<4 * L, MULTI, T>"
         "(rpt);\n" + _NW_LANES_CASE)] if n == 4 else []))
       for n in (4, 8, 16)},
    # D with both gap-weight windows loaded from the sums at every
    # diagonal (2 Wp scattered loads a lane-diagonal), no delay line.
    "dl_direct": ("mea_dl", "mea.cu",
                  [("    if (!REGULAR && ((d == 1) | ((t1 != 0) & (t1 != 1)))) "
                    "seed(d, l0);", "    seed(d, l0);")]),
    **{"%s_%s" % (tag, part): (kernel, where, edits)
       for tag, (kernel, source, *depth) in _WAVE.items()
       for part, (where, edits) in _wave_parts(source, *depth).items()},
    # S with n lanes a block whatever B, with tiles of 8 or 16 diagonals
    # whatever Wp, and with its es tiles copied by plain loads and stores
    # (no cp.async: each tile's copy stalls the thread until its loads
    # land).
    **{"sv_lanes_%d" % n: ("sv_backward", "fb_circ.cu", [
        ("      mk::warp_lanes(B, [Wp](int l) { return sv_smem(Wp, l); }, "
         "lanes);", "      (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16)},
    **{"sv_kt%d" % n: ("sv_backward", "fb_circ.cuh", [
        ("{ return rpt == 1 ? 16 : 8; }", "{ return %d; }" % n)])
       for n in (8, 16)},
    "sv_sync_stage": ("sv_backward", "fb_circ.cuh", [
        ("      mk::cp_async4(s + r, es + g + (size_t)r * B);",
         "      s[r] = es[g + (size_t)r * B];")]),
    # S with one part removed (outputs wrong by design): no device memory
    # after the first tiles (later tiles compute on the stage buffers as
    # they are, no output leaves), no block barrier after the first two
    # tiles, no shuffles for the rolls.
    "sv_no_global": ("sv_backward", "fb_circ.cuh", [
        ("    if (u > 0)\n      sv_flush<LPB, KT, SRC>(",
         "    if (u > 0 && u < 3)\n      sv_flush<LPB, KT, SRC>("),
        ("    if (u + 1 < tiles) stage(u + 1);",
         "    if (u + 1 < tiles && u < 2) stage(u + 1);")]),
    "sv_no_barrier": ("sv_backward", "fb_circ.cuh", [
        ("    __syncthreads();      // then everyone's: tile u has landed",
         "    if (u < 2) __syncthreads();")]),
    "sv_no_roll": ("sv_backward", "fb_circ.cuh", [
        ("    rows.roll(p, p1, 1);\n    rows.roll(ga, g2, 1);\n"
         "    rows.roll(gb, g4, 1);",
         "    for (int r = 0; r < RPT; ++r) {\n      p1[r] = p[r];\n"
         "      g2[r] = ga[r];\n      g4[r] = gb[r];\n    }")]),
    # R with byte stores (no transpose), and with every code read from
    # device memory (no windows).
    "rel_bytes": ("expand_rel", "expand.cu", [
        ("constexpr bool R_PACK = true;", "constexpr bool R_PACK = false;")]),
    # R with other tiles and blocks.
    **{"rel_tile%d" % n: ("expand_rel", "expand.cu", [
        ("constexpr int R_TILE = 32;", "constexpr int R_TILE = %d;" % n)])
       for n in (16, 64)},
    **{"rel_threads%d" % n: ("expand_rel", "expand.cu", [
        ("constexpr int R_THREADS = 64;",
         "constexpr int R_THREADS = %d;" % n)]) for n in (32, 128)},
    "rel_direct": ("expand_rel", "expand.cu", [
        ("  const int nw = rel_window_words(Wp);", "  const int nw = 0;")]),
    # R with one part removed (outputs wrong by design): no window staged
    # (the rows read whatever shared memory holds), almost no store (the
    # rows are computed, a store only where a data-dependent test holds).
    "rel_no_stage": ("expand_rel", "expand.cu", [
        ("  if (win) {\n#pragma unroll\n    for (int q = 0; q < R_GROUP; ++q)"
         " {\n      rel_stage(",
         "  if (false) {\n#pragma unroll\n    for (int q = 0; q < R_GROUP; "
         "++q) {\n      rel_stage(")]),
    "rel_no_store": ("expand_rel", "expand.cu", [
        ("                  const uint32_t (&X)[4]) {\n",
         "                  const uint32_t (&X)[4]) {\n"
         "    if ((Y[0] ^ X[1]) != 0x5a5a5a5au) return;\n")]),
    # K4 with n lanes a block whatever B (32: one row a thread only), with
    # three or four stage buffers.  (Each also varies mea_multi, K4's
    # kernel with the MULTI flag.)
    **{"mea_lanes_%d" % n: ("banded_mea", "mea.cu", [
        (_MEA_LANES_AT,
         "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16, 32)},
    # K4 staging its weight tiles by cp.async whatever B (no TMA).
    "mea_no_tma": ("banded_mea", "mea.cu", [
        ("  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&",
         "  return false && B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&")]),
    **{"mea_stages_%d" % n: ("banded_mea", "mea.cu", [
        ("constexpr int MEA_STAGES = 2;", "constexpr int MEA_STAGES = %d;" % n)])
       for n in (3, 4)},
    # K4 with one part removed (outputs wrong by design): no device memory
    # after the first tiles (later tiles compute on the stage buffers as
    # they are, no pointers leave), no decode after the first two tiles.
    "mea_no_global": ("banded_mea", "mea.cu", [
        ("    if (t < tiles)\n      mea_stage<LPB, KT, TMA, MULTI, NT>",
         "    if (t < min(tiles, MEA_STAGES))\n"
         "      mea_stage<LPB, KT, TMA, MULTI, NT>"),
        ("    if (t > 0) flush(t - 1);\n    stage(t + MEA_STAGES - 1);",
         "    if (t > 0 && t < 3) flush(t - 1);\n    stage(t + MEA_STAGES - 1);"),
        # (and no wait for TMA boxes that are never asked for)
        ("    mk::cp_async_wait_but<MEA_STAGES - 2>();\n    if (TMA) mk::",
         "    mk::cp_async_wait_but<MEA_STAGES - 2>();\n"
         "    if (TMA && t < MEA_STAGES) mk::")]),
    "mea_no_compute": ("banded_mea", "mea.cu", [
        ("    if (live)\n      lane.tile(in(t), out(t), rec(t), w, t * KT,",
         "    if (live && t < 2)\n      lane.tile(in(t), out(t), rec(t), w, "
         "t * KT,")]),
    # X taking 1 or 8 cells a thread a step, with twice the lane groups
    # (two blocks an SM's worth), with scalar atomics past the window in
    # place of 16-byte ones.
    **{"x_unroll_%d" % n: ("scatter_lanesum", "scatter.cu", [
        ("constexpr int X_UNROLL = 4;", "constexpr int X_UNROLL = %d;" % n)])
       for n in (1, 8)},
    "x_groups_2": ("scatter_lanesum", "scatter.cu", [
        ("((B - 1) >> p->shift) + 1 > sms)",
         "((B - 1) >> p->shift) + 1 > 2 * sms)")]),
    # X with one part removed (outputs wrong by design): plain adds in
    # place of the window's integer atomics; no value loads (1 added).
    "x_no_atomic": ("scatter_lanesum", "scatter.cu", [
        ("  const uint32_t old = atomicAdd(lo + i, ql);",
         "  const uint32_t old = lo[i];\n  lo[i] = old + ql;"),
        ("  if (h != 0) atomicAdd(hi + i, h);", "  if (h != 0) hi[i] += h;")]),
    "x_no_vals": ("scatter_lanesum", "scatter.cu", [
        ("        x[u] = hit ? make_float4(v[0], v[cells], v[2 * cells], "
         "v[3 * cells])",
         "        x[u] = hit ? make_float4(1.f, 1.f, 1.f, 1.f)")]),
    # The traceback kernels with one part removed (outputs wrong by
    # design): the producers stop after the ring's first stages and the
    # walker waits only for those (the walk alone: the serial floor), or
    # the walker waits on and releases every tile without walking it (the
    # stream alone).
    "tb_no_stream": (("nw_moves", "mea_moves"), "traceback.cu", [
        ("    for (int it = 0; it < tiles; ++it) {\n"
         "      const int s = it % S, d0",
         "    for (int it = 0; it < min(tiles, S); ++it) {\n"
         "      const int s = it % S, d0"),
        ("    mk::mbar_wait(full + s, (it / S) & 1);",
         "    if (it < S) mk::mbar_wait(full + s, (it / S) & 1);")]),
    "tb_no_walk": (("nw_moves", "mea_moves"), "traceback.cu", [
        ("    for (int qb = KT / 4 - 1; qb >= 0; --qb) {",
         "    for (int qb = KT / 4 - 1; qb >= 0 && tiles < 0; --qb) {")]),
}


# The checkpoint forward (counts_fwd_ckpt, counts_multi_fwd_ckpt): with 8
# or 16 lanes a block whatever B and Ntr, with one block staging its lanes'
# tile once for all three trials of a batch (8 lanes x 3 trials a block,
# against one trial a block), with its code tiles copied by plain loads and
# stores (no cp.async: csrc/common.cuh `stage_bytes`, which K1 and D of
# that copy share), and with one part removed (outputs wrong by design):
# no device memory after the first tiles (later tiles compute on the stage
# buffers as they are, no output leaves), no block barrier after the first
# two tiles.
_CF = ("counts_fwd_ckpt", "counts_multi_fwd_ckpt")


def _cf_cap(n):
    """The checkpoint forward with at least n / LPB blocks an SM: a
    register cap."""
    return ("__global__ void __launch_bounds__(32 * LPB)\n"
            "    counts_fwd_ckpt_kernel(",
            "__global__ void __launch_bounds__(32 * LPB, %d / LPB)\n"
            "    counts_fwd_ckpt_kernel(" % n)


_CF_ROLLED = ("#pragma unroll\n    for (int kb = 0; kb < K; ++kb) {\n"
              "      const int t1 = word_of(",
              "#pragma unroll 1\n    for (int kb = 0; kb < K; ++kb) {\n"
              "      const int t1 = word_of(")
_CF_LANES_AT = ("  cudaError_t err = mk::warp_lanes(\n"
                "      B * ntr, [Wp](int l) { return cf_smem(Wp, l, OUT); }, "
                "lanes);")
# Three trials a block at 8 lanes where the launch has three trials (else
# one trial at 16 lanes): the block's warps in groups of LPB, one a trial,
# each with its own tables and output tiles; the first group stages the
# tiles all three read.
_CF_TRIALS = [
    ("__global__ void __launch_bounds__(32 * LPB)\n"
     "    counts_fwd_ckpt_kernel(",
     "__global__ void __launch_bounds__((LPB == 8 ? 96 : 32) * LPB)\n"
     "    counts_fwd_ckpt_kernel("),
    ("  float* tab = cf_raw;  // [CF_NTAB]\n"
     "  uint8_t* buf = reinterpret_cast<uint8_t*>(cf_raw + CF_NTAB);\n"
     "  const size_t nin = cf_in_bytes(Wp, LPB),\n"
     "               nout = cf_out_bytes(Wp, LPB, OUT);",
     "  const int tl = threadIdx.x / (32 * LPB);\n"
     "  const int ntb = blockDim.x / (32 * LPB);\n"
     "  float* tab = cf_raw + tl * CF_NTAB;\n"
     "  uint8_t* buf = reinterpret_cast<uint8_t*>(cf_raw + 3 * CF_NTAB);\n"
     "  const size_t nin = cf_in_bytes(Wp, LPB),\n"
     "               nout = 3 * cf_out_bytes(Wp, LPB, OUT);"),
    ("  const int tid = threadIdx.x, w = tid >> 5;\n"
     "  const int b0 = blockIdx.x * LPB, b = b0 + w, t = blockIdx.y;",
     "  const int tid = threadIdx.x % (32 * LPB), w = tid >> 5;\n"
     "  const int b0 = blockIdx.x * LPB, b = b0 + w,\n"
     "            t = blockIdx.y * ntb + tl;"),
    ("  cf_stage<MULTI, LPB>(in(0), 0,",
     "  if (tl == 0) cf_stage<MULTI, LPB>(in(0), 0,"),
    ("    if (g > 0)\n      cf_flush<LPB, OUT>(out(g - 1), g - 1,",
     "    if (g > 0)\n"
     "      cf_flush<LPB, OUT>(out(g - 1) + tl * LPB * cf_rec(Wp, OUT, LPB), "
     "g - 1,"),
    ("    if (g + 1 < G)\n      cf_stage<MULTI, LPB>(",
     "    if (g + 1 < G && tl == 0)\n      cf_stage<MULTI, LPB>("),
    ("lane.tile(in(g), out(g) + w * cf_rec(Wp, OUT, LPB), g, w);",
     "lane.tile(in(g), out(g) + (tl * LPB + w) * cf_rec(Wp, OUT, LPB), g, "
     "w);"),
    ("  cf_flush<LPB, OUT>(out(G - 1), G - 1,",
     "  cf_flush<LPB, OUT>(out(G - 1) + tl * LPB * cf_rec(Wp, OUT, LPB), "
     "G - 1,"),
    ("  const int i0 = threadIdx.x / LPB;  // 0 .. 31",
     "  const int i0 = threadIdx.x % (32 * LPB) / LPB;"),
    ("  return CF_NTAB * sizeof(float) +\n"
     "         2 * (cf_in_bytes(Wp, lpb) + cf_out_bytes(Wp, lpb, out));",
     "  return 3 * CF_NTAB * sizeof(float) +\n"
     "         2 * (cf_in_bytes(Wp, lpb) + 3 * cf_out_bytes(Wp, lpb, out));"),
    (_CF_LANES_AT,
     "  cudaError_t err = (*lanes = ntr == 3 ? 8 : 16, cudaSuccess);"),
    ("dim3((B + lanes - 1) / lanes, ntr),\n"
     "                          dim3(32 * lanes),",
     "dim3((B + lanes - 1) / lanes, ntr == 3 ? 1 : ntr),\n"
     "                          dim3(32 * lanes * (ntr == 3 ? 3 : 1)),"),
]
PROBES.update({
    **{"cf_lanes_%d" % n: (_CF, "fb_counts.cu", [
        (_CF_LANES_AT, "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16)},
    "cf_trials": (_CF, "fb_counts.cu", _CF_TRIALS),
    "cf_sync_stage": (_CF, "common.cuh", [
        ("      if (b0 + c < B) cp_async4(dst + row * S + c, s + (size_t)row "
         "* B + c);",
         "      if (b0 + c < B) *reinterpret_cast<uint32_t*>(dst + row * S + "
         "c) = *reinterpret_cast<const uint32_t*>(s + (size_t)row * B + c);")
    ]),
    "cf_no_global": (_CF, "fb_counts.cu", [
        ("    if (g > 0)\n      cf_flush<LPB, OUT>(",
         "    if (g > 0 && g < 3)\n      cf_flush<LPB, OUT>("),
        ("    if (g + 1 < G)\n      cf_stage<MULTI, LPB>(",
         "    if (g + 1 < G && g < 2)\n      cf_stage<MULTI, LPB>(")]),
    "cf_cap64": (_CF, "fb_counts.cu", [_cf_cap(32)]),
    # The tile's diagonals in a rolled loop, without and with the cap;
    # 8 lanes a block with at most 80 registers (three blocks an SM).
    "cf_rolled": (_CF, "fb_counts.cu", [_CF_ROLLED]),
    "cf_rolled_cap64": (_CF, "fb_counts.cu", [_CF_ROLLED, _cf_cap(32)]),
    "cf_lanes_8_cap80": (_CF, "fb_counts.cu", [
        (_CF_LANES_AT, "  cudaError_t err = (*lanes = 8, cudaSuccess);"),
        _cf_cap(24)]),
    "cf_no_barrier": (_CF, "fb_counts.cu", [
        ("    mk::cp_async_wait();\n    __syncthreads();\n    if (g > 0)",
         "    mk::cp_async_wait();\n    if (g < 2) __syncthreads();\n"
         "    if (g > 0)")]),
})
# C: with 8 or 16 lanes a block whatever B, with tiles of 16 diagonals,
# with at most 64 registers (two blocks of 16 lanes an SM), with its es
# and bm tiles copied by plain loads and stores (no cp.async), and with
# one part removed (outputs wrong by design): no sink
# (no code accumulators, no fl), no device memory after the first tiles,
# no block barrier after the first two tiles.
PROBES.update({
    **{"cx_lanes_%d" % n: ("cx_forward", "fb_circ.cu", [
        ("      mk::warp_lanes(B, [Wp](int l) { return cx_smem(Wp, l); }, "
         "lanes);", "      (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16)},
    "cx_kt16": ("cx_forward", "fb_circ.cu", [
        ("constexpr int CX_KT = 8;", "constexpr int CX_KT = 16;")]),
    "cx_sync_stage": ("cx_forward", "fb_circ.cu", [
        ("      mk::cp_async4(es_s + r, es + at);\n"
         "      mk::cp_async4(bm_s + r, bm + at);",
         "      es_s[r] = es[at];\n      bm_s[r] = bm[at];")]),
    "cx_no_sink": ("cx_forward", "fb_circ.cu", [
        ("      sink(d0 + kb, rec[kb].fr, post, yb + kb * Wp * "
         "mk::byte_stride(LPB),\n           fl + kb);\n", "")]),
    "cx_cap64": ("cx_forward", "fb_circ.cu", [
        ("__global__ void __launch_bounds__(32 * LPB)\n    cx_forward_kernel(",
         "__global__ void __launch_bounds__(32 * LPB, 32 / LPB)\n"
         "    cx_forward_kernel(")]),
    "cx_no_global": ("cx_forward", "fb_circ.cu", [
        ("    if (t > 0)\n      cx_flush<LPB>(",
         "    if (t > 0 && t < 3)\n      cx_flush<LPB>("),
        ("    if (t + 1 < tiles)\n      cx_stage<LPB>(",
         "    if (t + 1 < tiles && t < 2)\n      cx_stage<LPB>(")]),
    "cx_no_barrier": ("cx_forward", "fb_circ.cu", [
        ("    __syncthreads();  // tile t in, tile t - 1 done",
         "    if (t < 2) __syncthreads();")]),
})
# The generic pair (fb_generic_fwd: the checkpoint forward's MATCH mode,
# fb_generic_bwd: generic_bwd_kernel), both kernels in each variant: with 8
# or 16 lanes a block whatever B, with its tiles copied by plain loads and
# stores (no cp.async: the code bytes through csrc/common.cuh
# `stage_bytes`, s1 and F_match), and without output tiles (each F_match
# and posterior value stored to device memory from its row's thread; the
# tiles' F_match and posterior rows stay in shared memory, lsf and term
# leave as before).  Every variant's outputs equal the kernel's.
_GB = ("fb_generic_fwd", "fb_generic_bwd")
# The forward with at most 64 registers (two blocks of 16 lanes an SM);
# the backward alone with at most 128 registers (two blocks of 8 lanes an
# SM) or 64 (four of 8, two of 16), its tile's diagonals in a rolled
# loop, and both.
_GB_BOUNDS = ("template <int LPB>\n__global__ void __launch_bounds__(32 * "
              "LPB)\n    generic_bwd_kernel(")
_GB_ROLLED = ("tile(const GbBuf& S, int g, int w) {\n#pragma unroll\n    for "
              "(int kb = K - 1; kb >= 0; --kb) step(",
              "tile(const GbBuf& S, int g, int w) {\n#pragma unroll 1\n    "
              "for (int kb = K - 1; kb >= 0; --kb) step(")


def _gb_cap(n):
    return (_GB_BOUNDS, _GB_BOUNDS.replace("(32 * LPB)",
                                           "(32 * LPB, %d / LPB)" % n))

_GB_LANES_AT = "      B, [Wp](int l) { return gb_smem(Wp, l); }, lanes);"
PROBES.update({
    **{"gen_lanes_%d" % n: (_GB, "fb_counts.cu", [
        (_CF_LANES_AT, "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n),
        ("  cudaError_t err = mk::warp_lanes(\n" + _GB_LANES_AT,
         "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16)},
    "gen_sync_stage": (_GB, "fb_counts.cu", [
        ("common.cuh",
         "      if (b0 + c < B) cp_async4(dst + row * S + c, s + (size_t)row "
         "* B + c);",
         "      if (b0 + c < B) *reinterpret_cast<uint32_t*>(dst + row * S + "
         "c) = *reinterpret_cast<const uint32_t*>(s + (size_t)row * B + c);"),
        ("      mk::cp_async4(S.s1 + w * K + kb, s1 + at);\n"
         "      if (MULTI)",
         "      S.s1[w * K + kb] = s1[at];\n      if (MULTI)"),
        ("r < K * Wp; r += 32)\n      mk::cp_async4(dst + r, src + (size_t)r "
         "* B);", "r < K * Wp; r += 32)\n      dst[r] = src[(size_t)r * B];"),
        ("      mk::cp_async4(S.s1 + w * K + kb, s1 + at);\n"
         "      mk::cp_async4(S.lsf + w * K + kb, lsf + at);",
         "      S.s1[w * K + kb] = s1[at];\n      S.lsf[w * K + kb] = lsf[at];")]),
    "gen_fwd_cap64": ("fb_generic_fwd", "fb_counts.cu", [_cf_cap(32)]),
    "gen_bwd_cap128": ("fb_generic_bwd", "fb_counts.cu", [_gb_cap(16)]),
    "gen_bwd_cap64": ("fb_generic_bwd", "fb_counts.cu", [_gb_cap(32)]),
    "gen_bwd_rolled": ("fb_generic_bwd", "fb_counts.cu", [_GB_ROLLED]),
    "gen_bwd_rolled_cap64": ("fb_generic_bwd", "fb_counts.cu",
                             [_GB_ROLLED, _gb_cap(32)]),
    "gen_no_tile": (_GB, "fb_counts.cu", [
        ("  float ls = 0.f, cprev = 1.f;\n  int sprev = 0;\n",
         "  float ls = 0.f, cprev = 1.f;\n  int sprev = 0;\n"
         "  float* gout = nullptr;\n  size_t gB = 0, gb = 0;\n"),
        ("      if (OUT == CF_MATCH && row) o[kb * Wp + k] = f[0];",
         "      if (OUT == CF_MATCH && row)\n"
         "        gout[((size_t)(g * K + kb) * Wp + k) * gB + gb] = f[0];"),
        ("                                 live && !MULTI ? fink[b] : -1, "
         "live);",
         "                                 live && !MULTI ? fink[b] : -1, "
         "live);\n  lane.gout = ckpt;\n  lane.gB = B;\n  lane.gb = b;"),
        ("  for (int r = i0; r < nck; r += 32) ck[(size_t)r * B] = o[r];",
         "  for (int r = i0; OUT != CF_MATCH && r < nck; r += 32) "
         "ck[(size_t)r * B] = o[r];"),
        ("  float g1[4] = {0.f, 0.f, 0.f, 0.f};  // e_s * b_s of d+1\n\n"
         "  __device__ GbWarp(",
         "  float g1[4] = {0.f, 0.f, 0.f, 0.f};  // e_s * b_s of d+1\n"
         "  float* gout = nullptr;\n  size_t gB = 0, gb = 0;\n\n"
         "  __device__ GbWarp("),
        ("    if (row) *fm = (*fm * nb[0]) * alpha0;",
         "    if (row) gout[((size_t)d * Wp + k) * gB + gb] = (*fm * nb[0]) * "
         "alpha0;"),
        ("                   live ? logZ[b] : 0.f, live);",
         "                   live ? logZ[b] : 0.f, live);\n"
         "  lane.gout = post;\n  lane.gB = B;\n  lane.gb = b;"),
        ("  float* dst = post + (size_t)d0 * Wp * B + b;",
         "  return;\n  float* dst = post + (size_t)d0 * Wp * B + b;")]),
})
# The stored pair (counts_fwd_all: the checkpoint forward's CF_ALL mode;
# counts_bwd: counts_stored_bwd_kernel; and their multi instances), both
# kernels in each variant but the backward's own: with 8 or 16 lanes a
# block whatever B and Ntr; with its tiles copied by plain loads and stores
# (no cp.async: the code bytes through csrc/common.cuh `stage_bytes`, s1,
# fink, f_all, lsf, find and L); the backward alone with a ring of three
# buffers (one barrier a tile; 16 lanes no longer fit at Wp 24, so
# mk::warp_lanes takes 8) or without its register cap at 8 lanes (one block
# an SM where it takes more than 128).  Every variant's outputs equal the
# kernel's.
_ST = ("counts_fwd_all", "counts_bwd", "counts_multi_fwd_all",
       "counts_multi_bwd")
# K2 and K3 (both kernels in each variant): with one part removed (outputs
# wrong by design): no device memory after the first tiles (no copies in,
# no rows out), no recursion after the first two tiles; with tiles of 8
# diagonals at one row a thread; with three stage buffers (tiles two
# ahead); with at most 64 registers (4 blocks of 8 lanes, 2 of 16 an SM);
# with every band by cp.async (no TMA).
_REL = ("fb_backward", "fb_forward")
_REL_BOUNDS = "__global__ void __launch_bounds__(32 * LPB)\n    rel_%s_kernel"
_STAGE = "    if (%s < tiles)\n      rel_stage<%s,"
_FLUSH = ("    if (%s > 0)\n      rel_flush<LPB, KT>(blk.out(%s - 1), %s, "
          "count(%s - 1), b0, Wp,\n                         B, %s,")
_FIRST = {"u": "first(u - 1)", "t": "(t - 1) * KT"}


def _no_global(walks):
    """Edits of the kernels' source that stop the kernels of `walks` ((the
    tile index, rel_stage's template counts, the first output) of each)
    from staging or flushing tiles past the first few; the TMA waits of the
    tiles never asked for go too (csrc/fb_rel.cuh)."""
    return [("fb_rel.cuh", "    if (TMA) mk::mbar_wait(",
             "    if (TMA && u < REL_STAGES) mk::mbar_wait(")] + [
        edit for i, counts, dst in walks for edit in (
            (_STAGE % (i, counts),
             _STAGE.replace("< tiles", "< min(tiles, REL_STAGES)")
             % (i, counts)),
            (_FLUSH % (i, i, _FIRST[i], i, dst),
             _FLUSH.replace("> 0)", "> 0 && %s < 3)" % i)
             % (i, i, _FIRST[i], i, dst)))]


PROBES.update({
    "fb_rel_no_global": (_REL, "fb.cu", _no_global(
        [("u", "1, 1", "bm"), ("t", "2, 2", "post")])),
    "fb_rel_no_compute": (_REL, "fb.cu", [
        ("    if (live)\n      lane.tile(blk.in(u), blk.rows(u, w), "
         "blk.rec(u, 0, w), first(u),",
         "    if (live && u < 2)\n      lane.tile(blk.in(u), "
         "blk.rows(u, w), blk.rec(u, 0, w), first(u),"),
        ("    if (live) lane.tile(blk.in(t), blk.rows(t, w), t * KT, "
         "count(t));",
         "    if (live && t < 2) lane.tile(blk.in(t), blk.rows(t, w), "
         "t * KT, count(t));")]),
    "fb_rel_no_tma": (_REL, "fb_rel.cuh", [
        ("  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&",
         "  return false && B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&")]),
    "fb_rel_kt8": (_REL, "fb_rel.cuh", [
        ("constexpr int rel_kt(int rpt) { return rpt == 1 ? 16 : 8; }",
         "constexpr int rel_kt(int rpt) { return 8; }")]),
    "fb_rel_stages_3": (_REL, "fb_rel.cuh", [("constexpr int REL_STAGES = 2;",
                                      "constexpr int REL_STAGES = 3;")]),
    "fb_rel_cap64": (_REL, "fb.cu", [
        (_REL_BOUNDS % k, _REL_BOUNDS.replace("LPB)", "LPB, 32 / LPB)") % k)
        for k in ("backward", "forward")]),
})
# The multi-lane FB pair (both kernels in each variant): at 8 lanes a
# block whatever B, or at 16 wherever `rel_lanes` allows them; with every
# band by cp.async (no TMA); and with one part removed (outputs wrong by
# design):
# the backward's posterior scale without its exp, no device memory after
# the first tiles, no recursion after the first two tiles.
_MULTI = ("fb_multi_forward", "fb_multi_backward")
PROBES.update({
    "fb_multi_lanes_8": (_MULTI, "fb_rel.cuh", [
        ("  const bool narrow = mk::rows_per_thread(Wp) > (kind == REL_MB "
         "? 1 : 2);",
         "  const bool narrow = mk::rows_per_thread(Wp) > (kind == REL_MB "
         "? 1 : 2) || kind >= REL_MF;")]),
    "fb_multi_lanes_16": (_MULTI, "fb_rel.cuh", [
        ("  return mk::warp_lanes(\n      B,",
         "  if (kind >= REL_MF && !narrow) return (*lanes = 16, "
         "cudaSuccess);\n  return mk::warp_lanes(\n      B,")]),
    "fb_multi_no_tma": (_MULTI, "fb_rel.cuh", [
        ("  return B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&",
         "  return false && B % 4 == 0 && mk::rows_per_thread(Wp) <= 2 &&")]),
    "fb_multi_no_expf": (_MULTI, "fb_multi.cu", [
        ("    const float alpha = expf(a.lsf + bls - a.L);",
         "    const float alpha = a.lsf + bls - a.L;")]),
    "fb_multi_no_global": (_MULTI, "fb_multi.cu", _no_global(
        [("t", "1, 2", "fm"), ("u", "2, 5", "post")])),
    "fb_multi_no_compute": (_MULTI, "fb_multi.cu", [
        ("    if (live)\n      lane.tile(blk.in(t), blk.rows(t, w), "
         "blk.rec(t, 0, w),",
         "    if (live && t < 2)\n      lane.tile(blk.in(t), "
         "blk.rows(t, w), blk.rec(t, 0, w),"),
        ("    if (live) lane.tile(blk.in(u), blk.rows(u, w), first(u), "
         "count(u));",
         "    if (live && u < 2) lane.tile(blk.in(u), blk.rows(u, w), "
         "first(u), count(u));")]),
})
_ST_BWD = ("counts_bwd", "counts_multi_bwd")
_ST_FWD = ("counts_fwd_all", "counts_multi_fwd_all")
_SB_LANES_AT = ("  cudaError_t err = mk::warp_lanes(\n"
                "      B * ntr, [Wp](int l) { return sb_smem(Wp, l, MULTI); }, "
                "lanes);")
PROBES.update({
    **{"st_lanes_%d" % n: (_ST, "fb_counts.cu", [
        (_CF_LANES_AT, "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n),
        (_SB_LANES_AT, "  cudaError_t err = (*lanes = %d, cudaSuccess);" % n)])
       for n in (8, 16)},
    "st_sync_stage": (_ST, "fb_counts.cu", [
        ("common.cuh",
         "      if (b0 + c < B) cp_async4(dst + row * S + c, s + (size_t)row "
         "* B + c);",
         "      if (b0 + c < B) *reinterpret_cast<uint32_t*>(dst + row * S + "
         "c) = *reinterpret_cast<const uint32_t*>(s + (size_t)row * B + c);"),
        ("      mk::cp_async4(S.s1 + w * K + kb, s1 + at);\n"
         "      if (MULTI) mk::cp_async4(S.fk + w * K + kb, fink + at);",
         "      S.s1[w * K + kb] = s1[at];\n"
         "      if (MULTI) S.fk[w * K + kb] = fink[at];"),
        ("      mk::cp_async4(dst + r, src + (size_t)r * B);\n"
         "    const int kb = threadIdx.x / LPB;\n    if (kb < K) {\n"
         "      const size_t at = (size_t)(d0 + kb) * B + b, tat",
         "      dst[r] = src[(size_t)r * B];\n"
         "    const int kb = threadIdx.x / LPB;\n    if (kb < K) {\n"
         "      const size_t at = (size_t)(d0 + kb) * B + b, tat"),
        ("      mk::cp_async4(S.s1 + w * K + kb, s1 + at);\n"
         "      mk::cp_async4(S.lsf + w * K + kb, lsf + tat);\n"
         "      if (MULTI) {\n"
         "        mk::cp_async4(S.fk + w * K + kb, fink + at);\n"
         "        mk::cp_async4(S.fd + w * K + kb, find + at);\n"
         "        mk::cp_async4(S.lz + w * K + kb, L + tat);",
         "      S.s1[w * K + kb] = s1[at];\n"
         "      S.lsf[w * K + kb] = lsf[tat];\n"
         "      if (MULTI) {\n"
         "        S.fk[w * K + kb] = fink[at];\n"
         "        S.fd[w * K + kb] = find[at];\n"
         "        S.lz[w * K + kb] = L[tat];")]),
    # The forward at 8 lanes a block and at most 128 registers: two blocks
    # an SM, so one block's flush overlaps the other's tile.
    "st_fwd_lanes_8_cap": (_ST_FWD, "fb_counts.cu", [
        (_CF_LANES_AT, "  cudaError_t err = (*lanes = 8, cudaSuccess);"),
        _cf_cap(16)]),
    "st_ring3": (_ST_BWD, "fb_counts.cu", [
        ("constexpr int SB_RING = 2;", "constexpr int SB_RING = 3;")]),
    "st_bwd_nocap": (_ST_BWD, "fb_counts.cu", [
        ("__global__ void __launch_bounds__(32 * LPB, 16 / LPB)\n"
         "    counts_stored_bwd_kernel(",
         "__global__ void __launch_bounds__(32 * LPB)\n"
         "    counts_stored_bwd_kernel(")]),
    # With one part removed (outputs wrong by design): no flush of the
    # output tiles after the first two (both kernels), no count partials
    # (the backward).
    "st_fwd_no_flush": (_ST_FWD, "fb_counts.cu", [
        ("    if (g > 0)\n      cf_flush<LPB, OUT>(out(g - 1), g - 1,",
         "    if (g > 0 && g < 3)\n"
         "      cf_flush<LPB, OUT>(out(g - 1), g - 1,")]),
    "st_bwd_no_flush": (_ST_BWD, "fb_counts.cu", [
        ("    if (u > 0) sb_flush<LPB>(",
         "    if (u > 0 && u < 3) sb_flush<LPB>(")]),
    "st_bwd_no_counts": (_ST_BWD, "fb_counts.cu", [
        ("          tca[s * 5 + u] = __fmaf_rn(fs, q[u], tca[s * 5 + u]);",
         "          (void)fs;"),
        ("        egb[(code * 4 + s - 1) * LPB * Wp] += (fv[s] * nb[s]) * a0n;",
         "        (void)code;")]),
})


# probe_serve's variants of the serving kernels (csrc/fb_serve.cu,
# csrc/fb_circ.cuh): the backwards in S's ring of three buffers or without
# their register caps; the forwards by cp.async only (no TMA), with
# 16-diagonal tiles at 16 lanes a block too, or with 8-diagonal tiles
# everywhere.
_SERVE_BWD = SERVE_KERNELS[:3]
_SERVE_FWD = SERVE_KERNELS[3:]
PROBES.update({
    "serve_bwd_ring3": (_SERVE_BWD, "fb_circ.cuh", [
        ("  return src == SRC_ES ? SV_RING : 2;", "  return SV_RING;")]),
    "serve_bwd_no_cap": (_SERVE_BWD, "fb_serve.cu", [
        ("  return rpt > 1 ? 1 : (src == SRC_EMV ? 4 : 3);",
         "  return 1;")]),
    "serve_post_cp_async": (_SERVE_FWD, "fb_serve.cu", [
        ("bool sp_tma(int Wp, int B) {\n  return B % 4 == 0",
         "bool sp_tma(int Wp, int B) {\n  return false && B % 4 == 0")]),
    "serve_post_kt16": (_SERVE_FWD, "fb_serve.cu", [
        ("  return rpt == 1 && lpb == 8 ? 16 : 8;",
         "  return rpt == 1 ? 16 : 8;")]),
    "serve_post_kt8": (_SERVE_FWD, "fb_serve.cu", [
        ("  return rpt == 1 && lpb == 8 ? 16 : 8;", "  return 8;")]),
})


# probe_ckpt's variants of the checkpoint pair (csrc/fb_ckpt.cu): the
# posterior pass always pipelined (8 lanes a block of 16 warps) or always
# sequential (16 lanes, one warp each), and with one part removed (outputs
# wrong by design): no replay after the first block, no forward, no flush
# or no staging after the first blocks, no block barrier after the first
# two phases; the backward without its checkpoints.
_CKPT_PARTS = {
    "ckpt_post_pipelined": [("    if (!c.pipe && B < 16 * sms) continue;",
                             "    if (!c.pipe) continue;")],
    "ckpt_post_sequential": [("    if (!c.pipe && B < 16 * sms) continue;",
                              "    if (!c.pipe && B < 0) continue;")],
    "ckpt_post_forward_only": [("    if (replays && p < G) {",
                                "    if (replays && p < G && p < 1) {")],
    "ckpt_post_replay_only": [("    if (forwards && p >= LAG) {",
                               "    if (forwards && p >= LAG && p < 0) {")],
    "ckpt_post_no_flush": [
        ("    if (p - LAG - 1 >= 0) flush(p - LAG - 1);",
         "    if (p - LAG - 1 >= 0 && p < 3) flush(p - LAG - 1);")],
    "ckpt_post_no_stage": [("    if (p + 1 < G) stage(p + 1);",
                            "    if (p + 1 < G && p < 2) stage(p + 1);")],
    "ckpt_post_no_barrier": [
        ("    mk::cp_async_wait();\n    __syncthreads();\n    if (p - LAG",
         "    mk::cp_async_wait();\n    if (p < 2) __syncthreads();\n"
         "    if (p - LAG")],
}
PROBES.update({
    **{name: ("circ_ckpt_post", "fb_ckpt.cu", edits)
       for name, edits in _CKPT_PARTS.items()},
    "ckpt_bwd_no_save": ("circ_ckpt_backward", "fb_ckpt.cu", [
        ("    if (saves(u)) save_ckpt(lane, ckbuf(d0 / KB) + w * crows);",
         "    (void)0;"),
        ("    if (u > 0 && saves(u - 1)) flush(first(u - 1) / KB);",
         "    (void)0;"),
        ("  if (saves(tiles - 1)) flush(0);", "  (void)0;")]),
})


# probe_wavefront_multi's variants of nw_multi and mea_multi (K1's and K4's
# kernels with the MULTI flag): nw_multi with 8 warps' worth of lanes a
# block whatever B, with three stage buffers; mea_multi at 16 lanes a
# block whatever B, without TMA; both with one part removed (outputs wrong
# by design: no device memory after the first tiles).
_NW_NO_GLOBAL = _wave_parts(*_WAVE["nw"][1:])["no_global"][1]
PROBES.update({
    "wm_nw_narrow": ("nw_multi", "nw.cu", [
        ("                     mk::fills(B, 16 * per, sms)",
         "                     false")]),
    "wm_nw_stages_3": ("nw_multi", "nw.cu", [
        ("constexpr int NW_STAGES = 2;", "constexpr int NW_STAGES = 3;")]),
    "wm_mea_lanes_16": ("mea_multi", "mea.cu", [
        (_MEA_LANES_AT, "  cudaError_t err = (*lanes = 16, cudaSuccess);")]),
    "wm_mea_no_tma": ("mea_multi", "mea.cu", PROBES["mea_no_tma"][2]),
    "wm_nw_no_global": ("nw_multi", "nw.cu", _NW_NO_GLOBAL),
    "wm_mea_no_global": ("mea_multi", "mea.cu", PROBES["mea_no_global"][2]),
})


def main(argv):
    import torch

    groups = argv[2:] or list(DEFAULT_GROUPS)
    if len(argv) < 2 or any(g not in GROUPS for g in groups):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    this = importlib.import_module(PKG)
    other = load_port(argv[1], "other_port")
    t0 = time.perf_counter()
    for port in (this, other):
        sub(port, "ops._build").load()
    report = {"card": card(), "build_s": time.perf_counter() - t0,
              "other": os.path.abspath(argv[1]), "reps": REPS}
    for group in groups:
        RUNS[group](this, other, torch.device("cuda"), report)
        torch.cuda.empty_cache()
    print(json.dumps(report), flush=True)
    return 0


def run_counts(this, other, cuda, report):
    """Fills `report` with the counts group's rows."""
    import torch

    tc, oc = (sub(p, "ops.fb_counts_cuda") for p in (this, other))
    tb, ob = (sub(p, "ops.bucket_scatter") for p in (this, other))
    fbc, ofbc = (sub(p, "ops.fb_counts") for p in (this, other))
    fb, ofb = (sub(p, "ops.fb") for p in (this, other))
    band = sub(this, "ops.band")
    P = sub(this, "models.hmm")

    def show(name):
        print(json.dumps({name: report[name]}), flush=True)

    # L on a realign flush stream.
    args = flush_stream(this, cuda)
    vals, jm, rg = args
    got, ref = tb.scatter_lanes_cuda(*args), ob.scatter_lanes_cuda(*args)
    plain = tb.scatter_lanes_plain(*args)
    hit = int(((jm >= 0) & (jm < rg)).sum())
    tgt = torch.where((jm >= 0) & (jm < rg), jm, rg).long()
    lib_out = vals.new_zeros((rg + 1, vals.shape[1]))
    report["scatter_lanes"] = {
        "shape": list(vals.shape), "rg": rg,
        "max_abs_err_plain": (got - plain).abs().max().item(),
        "max_abs_err_other": (got - ref).abs().max().item(),
        "repeat_identical": bool(torch.equal(
            got, tb.scatter_lanes_cuda(*args))),
        **ab(lambda: tb.scatter_lanes_cuda(*args),
             lambda: ob.scatter_lanes_cuda(*args)),
        "library_ms": time_ms(lambda: lib_out.scatter_add_(0, tgt, vals)),
        **bound("scatter_lanes", hit, jm.numel() * 4 + rg * vals.shape[1]
                * 4 + hit * 4)}
    del args, vals, jm, got, ref, plain, tgt, lib_out
    show("scatter_lanes")

    # The stored pair on the single-lane EM batches: the EM batch (the
    # pair forced), one trial of it, its first 1024 lanes (the smoke's EM
    # parity run, em32) and 2048 lanes (--updateTheBand's E-step,
    # em_band), and its pairs packed at widths 5, 13 and 29 (Wp 8, 16, 32).
    hmms = models(P, 3)
    tables = fb.tables_stacked(hmms, cuda)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    one = tuple(t[:1].contiguous() for t in tabs)
    batch = em_batch(band)
    dev = fb.device_batch(batch, cuda)
    xb, yb, valid, s1, fk, fd = fbc.kernel_inputs(dev)
    streams = (xb, yb, valid, s1, fk)

    def logz(fd):
        return lambda lsf, term: fbc.logz_from_terminal(lsf, term, fd)

    def lanes(n):
        return tuple(t[..., :n].contiguous() for t in (*streams, fd))

    cells = {"counts_em": (tabs, streams, fd), "counts_em_one_trial": (
        one, streams, fd)}
    for name, n in (("counts_em32", 1024), ("counts_em_band", 2048)):
        *cut, cfd = lanes(n)
        cells[name] = (tabs, tuple(cut), cfd)
    for name, (ctabs, cstreams, cfd) in cells.items():
        report[name] = ab_stored(this, other, ctabs, cstreams, cfd, logz(cfd),
                                 False, cuda)
        show(name)
        torch.cuda.empty_cache()
    del cells
    for width in (5, 13, 29):
        *wstreams, wfd = fbc.kernel_inputs(fb.device_batch(
            em_batch(band, width=width), cuda))
        name = "counts_em_wp%d" % wstreams[0].shape[1]
        report[name] = ab_stored(this, other, tabs, tuple(wstreams), wfd,
                                 logz(wfd), False, cuda)
        show(name)
        del wstreams, wfd
        torch.cuda.empty_cache()

    # Must not move: the checkpoint pair on the EM batch.
    report["counts_fwd_ckpt"] = unmoved(
        tc.counts_fwd_ckpt_cuda, oc.counts_fwd_ckpt_cuda, (*tabs, *streams))
    ck, cs, lsf, term = tc.counts_fwd_ckpt_cuda(*tabs, *streams)
    report["counts_bwd_ckpt"] = unmoved(
        tc.counts_bwd_ckpt_cuda, oc.counts_bwd_ckpt_cuda,
        (*tabs, ck, cs, *streams, fd, fbc.logz_from_terminal(lsf, term, fd)))
    del ck, cs
    show("counts_fwd_ckpt")
    show("counts_bwd_ckpt")
    # The E-step of --em on this batch (3 trials), each pair.
    odev = ofb.device_batch(batch, cuda)
    otables = ofb.tables_stacked(hmms, cuda)
    for pair in ("ckpt", "stored"):
        name = "estep_em" + ("" if pair == "ckpt" else "_stored")
        report[name] = estep(
            lambda: fbc.counts_trials(tables, dev, kernel=pair),
            lambda: ofbc.counts_trials(otables, odev, kernel=pair))
        show(name)
    del dev, odev, batch, streams
    torch.cuda.empty_cache()

    # The multi-lane EM batch and its first trial.
    mb = multi_batch(band)
    mdev = fb.multi_device_batch(mb, cuda)
    *mstreams, mfk, mfd = fbc.multi_kernel_inputs(mdev)
    mstreams = (*mstreams, mfk)

    def mlogz(lsf, term):
        return fb.multi_logz(lsf, term, mdev)[0]

    for name, mtabs in (("counts_em_multi", tabs),
                        ("counts_em_multi_one_trial", one)):
        report[name] = ab_stored(this, other, mtabs, mstreams, mfd, mlogz,
                                 True, cuda)
        show(name)
        torch.cuda.empty_cache()
    report["counts_multi_fwd_ckpt"] = unmoved(
        tc.counts_multi_fwd_ckpt_cuda, oc.counts_multi_fwd_ckpt_cuda,
        (*tabs, *mstreams))
    ck, cs, lsf, term = tc.counts_multi_fwd_ckpt_cuda(*tabs, *mstreams)
    report["counts_multi_bwd_ckpt"] = unmoved(
        tc.counts_multi_bwd_ckpt_cuda, oc.counts_multi_bwd_ckpt_cuda,
        (*tabs, ck, cs, *mstreams, mfd, mlogz(lsf, term)))
    del ck, cs
    show("counts_multi_fwd_ckpt")
    show("counts_multi_bwd_ckpt")
    omdev = ofb.multi_device_batch(mb, cuda)
    for pair in ("ckpt", "stored"):
        name = "estep_em_multi" + ("" if pair == "ckpt" else "_stored")
        report[name] = estep(
            lambda: fbc.counts_multi_trials(tables, mdev, kernel=pair),
            lambda: ofbc.counts_multi_trials(otables, omdev, kernel=pair))
        show(name)
    del mdev, omdev, mb
    torch.cuda.empty_cache()

    # Must not move: the generic pair (non-flat model, one trial) on the
    # generic and em_band batches.
    tg, og = (sub(p, "ops.fb_generic_cuda") for p in (this, other))
    gtabs = generic_pair_tables(this, cuda)
    for name, (gstreams, gfd) in generic_cells(
            this, cuda, ("generic", "em_band")).items():
        fm, lsf, term = tg.fb_generic_fwd_cuda(*gtabs, *gstreams)
        lz = fbc.logz_from_terminal(lsf[None], term[None], gfd)[0]
        report["generic_" + name] = {
            "fwd": unmoved(tg.fb_generic_fwd_cuda, og.fb_generic_fwd_cuda,
                           (*gtabs, *gstreams)),
            "bwd": unmoved(tg.fb_generic_bwd_cuda, og.fb_generic_bwd_cuda,
                           (*gtabs, fm, lsf, *gstreams, gfd, lz))}
        show("generic_" + name)
        del gstreams, gfd, fm
        torch.cuda.empty_cache()


def estep(this_fn, other_fn):
    """Host seconds of one E-step call of each checkout (other, this, this,
    other; EM_REPS calls each after a warm-up), and what 5 and 100 EM
    iterations of it come to."""
    import torch

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EM_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / EM_REPS

    o1, t1, t2, o2 = wall(other_fn), wall(this_fn), wall(this_fn), \
        wall(other_fn)
    s, o = (t1 + t2) / 2, (o1 + o2) / 2
    return {"s": s, "other_s": o, "iterations_5_s": 5 * s,
            "other_iterations_5_s": 5 * o, "iterations_100_s": 100 * s,
            "other_iterations_100_s": 100 * o}


RUNS = {"fused": run_fused, "wavefront": run_wavefront, "probe": run_probe,
        "probe_wavefront": lambda *a: run_probe(
            *a, kernels=("banded_nw", "mea_dl")),
        "probe_fused": lambda *a: run_probe(
            *a, kernels=("sv_backward", "expand_rel")),
        "probe_counts": lambda *a: run_probe(
            *a, kernels=("counts_fwd_ckpt", "counts_multi_fwd_ckpt")),
        "probe_cx": lambda *a: run_probe(*a, kernels=("cx_forward",)),
        "probe_generic": lambda *a: run_probe(
            *a, kernels=("fb_generic_fwd", "fb_generic_bwd")),
        "probe_stored": lambda *a: run_probe(*a, kernels=_ST),
        "probe_rel": lambda *a: run_probe(*a, kernels=_REL),
        "probe_serve": lambda *a: run_probe(*a, kernels=SERVE_KERNELS),
        "probe_ckpt": lambda *a: run_probe(*a, kernels=CKPT_KERNELS),
        "probe_mea": lambda *a: run_probe(*a, kernels=("banded_mea",)),
        "probe_scatter": lambda *a: run_probe(
            *a, kernels=("scatter_lanesum",)),
        "probe_multi": lambda *a: run_probe(*a, kernels=_MULTI),
        "probe_wavefront_multi": lambda *a: run_probe(
            *a, kernels=("nw_multi", "mea_multi")),
        "counts": run_counts, "scatter": run_scatter, "rel": run_rel,
        "serve": run_serve, "multi": run_multi, "fb_multi": run_fb_multi,
        "traceback": run_traceback,
        "probe_traceback": lambda *a: run_probe(
            *a, kernels=("nw_moves", "mea_moves"))}

if __name__ == "__main__":
    sys.exit(main(sys.argv))
