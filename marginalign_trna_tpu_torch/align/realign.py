"""Pair-HMM realignment of a chained SAM file, batched on one device.

Port of marginalign_trna_tpu/align/realign.py (behavioural equivalent of
the reference realignment stage, src/margin/marginAlignLib.py:265-370):
optionally chain, then realign every record's aligned read region against
its reference span with the banded pair-HMM posterior and the AMAP decode
(ops/mea.py), and splice the realigned cigar back between the original
clips.  Jobs are cut at guide anchors, bucketed by size, and each bucket
runs as one batch on the device, by one of three paths:

  fused (default; the JAX package's accelerator default, its compact +
    fused realign route): the host packs only sequences and band offsets;
    the streams expand on the device, the backward runs from them and the
    forward writes the posterior band together with its row and column
    sums (ops/fb_circ.py `posteriors_weights_compact`), which the MEA
    decode reads directly (ops/mea.py `mea_decode_fused`);
  REL (fused=False; the JAX package with MARGINALIGN_REALIGN_FUSED=off
    MARGINALIGN_LAYOUT=rel): the host packs [D1, Wp, B] band arrays, the
    forward-backward writes the posterior band (ops/fb_cuda.py
    `posteriors_specialised`) and the gap weights are built as bands
    (ops/mea.py `mea_decode`);
  circular serving (serve=<mode>, one of ops/fb_circ.py SERVE_MODES; the
    JAX package with MARGINALIGN_LAYOUT=circ MARGINALIGN_REALIGN_FUSED=off
    MARGINALIGN_CIRC_SERVE=<mode>): the REL path with another
    forward-backward: the uploaded band arrays rotate into the circular
    layout on the device, the kernels of that mode write the circular
    posterior band, which rotates back for the MEA decode
    (ops/fb_circ.py `posteriors_serve`).

A model whose gap emissions are not flat (an EM model mid-training, an
un-normalised trial model) takes the REL path whatever `fused` or `serve`
say, as in the JAX package: the fused and circular kernels fold flat gap
emissions into their coefficients, the REL path runs such a model through
the generic forward-backward pair (ops/fb_generic_cuda.py).

With multi=True (the JAX package's MARGINALIGN_MULTI=on, its
align/realign.py:203-293), checked before `fused` and `serve`: when every
job (after anchor splitting) spans at most MULTI_MAX_PROBLEM_STEPS
diagonals and the model's gap emissions are flat (`use_multi_lanes`), all
jobs go into one batch of multi-problem lanes (ops/band.py
`pack_multi_banded_batch`): the forward-backward of ops/fb_multi_cuda.py
`posteriors_multi`, then ops/mea.py `mea_decode_multi`.  Otherwise the
call takes the route it takes without `multi`.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.fasta import get_fasta_dictionary
from ..io.sam import SamFile, SamRecord
from ..models.hmm import PairHmm
from ..ops.band import (
    pack_banded_batch, pack_compact_batch, pack_multi_banded_batch,
    path_from_cigar,
)
from ..ops.fb import (
    FbTables, device_batch, multi_device_batch, tables_from_hmm,
)
from ..ops.fb_circ import (
    check_serve, compact_device_batch, posteriors_serve,
    posteriors_weights_compact,
)
from ..ops.fb_cuda import has_flat_gap_emissions, posteriors_specialised
from ..ops.fb_multi_cuda import posteriors_multi
from ..ops.mea import (
    mea_decode, mea_decode_fused, mea_decode_multi, rowcol_sums_from_flushed,
)
from ..utils.seq import encode
from .chain import chain_sam_file

# Band width = 2 * diagonalExpansion + 1 with the reference's expansion of 10
# (src/margin/marginAlignLib.py:315).
DEFAULT_BAND_WIDTH = 21

# Reference realign-path --splitMatrixBiggerThanThis
# (src/margin/marginAlignLib.py:316); 0 disables splitting.
DEFAULT_SPLIT_SIZE = 3000

# multi=True packs problems several per lane when every job fits this many
# diagonals (marginalign_trna_tpu/align/realign.py MULTI_MAX_PROBLEM_STEPS).
MULTI_MAX_PROBLEM_STEPS = 512


@dataclass
class RealignJob:
    record: SamRecord
    read_region: np.ndarray  # encoded aligned read bases
    ref_region: np.ndarray   # encoded reference span
    path: Tuple[np.ndarray, np.ndarray]


def _jobs_from_sam(
    sam: SamFile, ref_sequences, encode_fn
) -> List[RealignJob]:
    jobs = []
    for rec in sam.mapped():
        read_region = rec.query_alignment_sequence
        ref_seq = ref_sequences[rec.rname]
        ref_region = ref_seq[rec.reference_start : rec.reference_end]
        aligned_ops = [(op, l) for op, l in rec.cigar if op in (0, 1, 2)]
        if not aligned_ops or not read_region or not ref_region:
            continue
        pd, pi = path_from_cigar(aligned_ops)
        jobs.append(
            RealignJob(
                record=rec,
                read_region=encode_fn(read_region),
                ref_region=encode_fn(ref_region),
                path=(pd, pi),
            )
        )
    return jobs


def split_job_at_anchors(
    job: RealignJob, split_size: int
) -> List[RealignJob]:
    """Decompose one alignment problem at guide-path anchor points so that
    no sub-matrix side exceeds split_size; each segment realigns
    independently, pinned through the anchor pair, and the segment results
    concatenate in order.

    Behavioural equivalent of cPecanRealign --splitMatrixBiggerThanThis=n
    [reconstructed from the call sites: n=3000 realign
    (src/margin/marginAlignLib.py:316), 300 EM (src/margin/marginAlign.py:41),
    100 caller / 1 noMargin (src/margin/marginCallerLib.py:50,55)]: the
    reference cuts large DP matrices into independent sub-problems at
    confident anchor points of the guide alignment.  split_size <= 0
    disables splitting (exact full-length DP)."""
    m = len(job.read_region)
    n = len(job.ref_region)
    if split_size <= 0 or max(m, n) <= split_size or min(m, n) < 2:
        return [job]
    pd, pi = job.path
    pj = pd - pi
    D = m + n
    k = -(-D // split_size)
    if k < 2:
        return [job]
    # Cut points ON the guide path (anchors must be actual guide pairs):
    # inside a match run the path is exactly diagonal, so any interior
    # (i, j) is a guide pair; inside an indel run snap to the nearer
    # vertex.  Cutting in d-space bounds every segment's m+n (hence both
    # sides) by ~split_size.
    keep = []
    last_i, last_j = 0, 0
    for c in range(1, k):
        dt = int(round(c * D / k))
        t = int(np.searchsorted(pd, dt, side="right")) - 1
        t = min(max(t, 0), len(pd) - 2)
        dd = int(pd[t + 1] - pd[t])
        di = int(pi[t + 1] - pi[t])
        if di > 0 and dd == 2 * di:
            step = min(max((dt - int(pd[t])) // 2, 0), di)
            ic = int(pi[t]) + step
            jc = int(pj[t]) + step
        elif dt - pd[t] <= pd[t + 1] - dt:
            ic, jc = int(pi[t]), int(pj[t])
        else:
            ic, jc = int(pi[t + 1]), int(pj[t + 1])
        if last_i < ic < m and last_j < jc < n:
            keep.append((ic, jc))
            last_i, last_j = ic, jc
    bounds = [(0, 0)] + keep + [(m, n)]
    if len(bounds) == 2:
        return [job]

    out = []
    for (i0, j0), (i1, j1) in zip(bounds[:-1], bounds[1:]):
        ms, ns = i1 - i0, j1 - j0
        d0, d1 = i0 + j0, i1 + j1
        sel = (pd > d0) & (pd < d1) & (pi >= i0) & (pi <= i1) \
            & (pj >= j0) & (pj <= j1)
        sub_d = np.concatenate([[0], pd[sel] - d0, [ms + ns]])
        sub_i = np.concatenate([[0], pi[sel] - i0, [ms]])
        # Keep strictly-increasing d (band_offsets interpolates vertices).
        uniq = np.concatenate([[True], np.diff(sub_d) > 0])
        out.append(
            RealignJob(
                record=job.record,
                read_region=job.read_region[i0:i1],
                ref_region=job.ref_region[j0:j1],
                path=(sub_d[uniq], sub_i[uniq]),
            )
        )
    return out


def _merge_op_runs(ops: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge adjacent same-op runs (segment concatenation seams)."""
    out: List[Tuple[int, int]] = []
    for op, ln in ops:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


def split_jobs_at_anchors(
    jobs: Sequence[RealignJob], split_size: int
) -> Tuple[List[RealignJob], List[int], List[Tuple[int, int]]]:
    """Explode jobs into anchor segments.  Returns (segments, origin,
    seg_starts) where origin[s] = source job index (segments of one job
    stay contiguous and ordered) and seg_starts[s] = (i0, j0) of the
    segment inside its job's aligned region."""
    segs: List[RealignJob] = []
    origin: List[int] = []
    starts: List[Tuple[int, int]] = []
    for idx, job in enumerate(jobs):
        pieces = split_job_at_anchors(job, split_size)
        i0 = j0 = 0
        for p in pieces:
            segs.append(p)
            origin.append(idx)
            starts.append((i0, j0))
            i0 += len(p.read_region)
            j0 += len(p.ref_region)
    return segs, origin, starts


def _bucket_jobs(
    jobs: Sequence[RealignJob], width: int, max_batch_cells: int
) -> List[List[int]]:
    """Group job indices into batches bounded by padded DP volume, after
    sorting by size so padding waste stays low (the reference's analog is
    the maxAlignmentLengthPerJob chunker, src/margin/utils.py:157-176)."""
    order = sorted(
        range(len(jobs)),
        key=lambda idx: len(jobs[idx].read_region) + len(jobs[idx].ref_region),
    )
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_max_d = 0
    for idx in order:
        d = len(jobs[idx].read_region) + len(jobs[idx].ref_region) + 1
        new_max = max(cur_max_d, d)
        if cur and new_max * (len(cur) + 1) * width > max_batch_cells:
            buckets.append(cur)
            cur, cur_max_d = [], 0
            new_max = d
        cur.append(idx)
        cur_max_d = new_max
    if cur:
        buckets.append(cur)
    return buckets


def use_multi_lanes(jobs: Sequence[RealignJob], tables: FbTables) -> bool:
    """The JAX package's multi-lane policy under MARGINALIGN_MULTI=on
    (its align/realign.py `_use_multi_packing`): every job spans at most
    MULTI_MAX_PROBLEM_STEPS diagonals and the model's gap emissions are
    flat.  A size and model policy; realign and the caller ask it only when
    called with multi=True."""
    if not jobs:
        return False
    if max(len(j.read_region) + len(j.ref_region) + 1
           for j in jobs) > MULTI_MAX_PROBLEM_STEPS:
        return False
    return has_flat_gap_emissions(tables)


def _realign_multi(jobs: Sequence[RealignJob], tables: FbTables,
                   gap_gamma: float, match_gamma: float, device,
                   band_width: int) -> List[List[Tuple[int, int]]]:
    """Multi-lane path: every job in one multi-problem batch -> FB pair ->
    MEA over the lanes -> host tracebacks."""
    mb = pack_multi_banded_batch(
        [j.read_region for j in jobs], [j.ref_region for j in jobs],
        width=band_width, paths=[j.path for j in jobs],
    )
    mdev = multi_device_batch(mb, device)
    _, post = posteriors_multi(tables, mdev)
    return mea_decode_multi(post, mb, mdev, gap_gamma, match_gamma)


def _realign_bucket_fused(jobs: Sequence[RealignJob], tables: FbTables,
                          gap_gamma: float, match_gamma: float, device,
                          band_width: int) -> List[List[Tuple[int, int]]]:
    """Fused path of one bucket: compact batch -> E + S + M -> row / column
    sums (L) -> MEA (D) -> host traceback."""
    comp = pack_compact_batch(
        [j.read_region for j in jobs], [j.ref_region for j in jobs],
        width=band_width, paths=[j.path for j in jobs], quantize=True,
    )
    dev = compact_device_batch(comp, device)
    _, post, flc, flr, tc, tr = posteriors_weights_compact(tables, dev,
                                                           band_width)
    accr, accc = rowcol_sums_from_flushed(comp, dev, flc, flr, tc, tr)
    return mea_decode_fused(post, comp, dev, accr, accc, gap_gamma,
                            match_gamma)


def _realign_bucket_rel(jobs: Sequence[RealignJob], tables: FbTables,
                        gap_gamma: float, match_gamma: float, device,
                        band_width: int, serve: Optional[str] = None
                        ) -> List[List[Tuple[int, int]]]:
    """REL path of one bucket: host band arrays -> forward-backward (K2
    and K3, the generic pair for a model whose gap emissions are not flat,
    or with `serve` the circular serving kernels of that mode) -> weight
    bands -> MEA (K4) -> host traceback."""
    batch = pack_banded_batch(
        [j.read_region for j in jobs], [j.ref_region for j in jobs],
        width=band_width, paths=[j.path for j in jobs], quantize=True,
    )
    dev = device_batch(batch, device)
    if serve is None:
        _, post = posteriors_specialised(tables, dev)
    else:
        _, post = posteriors_serve(tables, batch, dev, serve)
    return mea_decode(post, batch, dev, gap_gamma, match_gamma)


def realigned_ops_for_jobs(
    jobs: Sequence[RealignJob],
    hmm: PairHmm,
    gap_gamma: float,
    match_gamma: float,
    device,
    band_width: int = DEFAULT_BAND_WIDTH,
    # Padded DP cells per device batch.
    max_batch_cells: int = 128_000_000,
    split_size: int = 0,
    fused: bool = True,
    serve: Optional[str] = None,
    multi: bool = False,
) -> List[List[Tuple[int, int]]]:
    """Run FB + MEA for every job on `device`; returns realigned
    aligned-region ops.

    split_size > 0 decomposes each problem at guide-path anchors
    (split_job_at_anchors) and concatenates the per-segment cigars.
    multi=True takes multi-problem lanes where `use_multi_lanes` allows;
    fused=False takes the REL path; serve=<mode> the circular serving
    route in that mode, whatever `fused` says; a model whose gap emissions
    are not flat the REL path (module docstring).  An unknown serve mode
    raises ValueError."""
    check_serve(serve)
    if split_size and split_size > 0:
        segs, origin, _ = split_jobs_at_anchors(jobs, split_size)
        if len(segs) != len(jobs):
            seg_ops = realigned_ops_for_jobs(
                segs, hmm, gap_gamma, match_gamma, device, band_width,
                max_batch_cells, split_size=0, fused=fused, serve=serve,
                multi=multi,
            )
            out: List[List[Tuple[int, int]]] = [[] for _ in jobs]
            for s_idx, j_idx in enumerate(origin):
                out[j_idx].extend(seg_ops[s_idx])
            return [_merge_op_runs(ops) for ops in out]

    tables = tables_from_hmm(hmm, device)
    if multi and use_multi_lanes(jobs, tables):
        return _realign_multi(jobs, tables, gap_gamma, match_gamma, device,
                              band_width)
    # marginalign_trna_tpu/align/realign.py:265-267, 328, 358-395.
    if not has_flat_gap_emissions(tables):
        run_bucket = _realign_bucket_rel
    elif serve is not None:
        run_bucket = partial(_realign_bucket_rel, serve=serve)
    else:
        run_bucket = _realign_bucket_fused if fused else _realign_bucket_rel
    results: List[List[Tuple[int, int]]] = [[] for _ in jobs]
    for bucket in _bucket_jobs(jobs, band_width, max_batch_cells):
        ops_list = run_bucket([jobs[i] for i in bucket], tables, gap_gamma,
                              match_gamma, device, band_width)
        for local_b, job_idx in enumerate(bucket):
            results[job_idx] = ops_list[local_b]
    return results


def splice_realigned_cigar(
    rec: SamRecord, new_ops: List[Tuple[int, int]]
) -> SamRecord:
    """Replace a record's aligned ops with realigned ones, re-adding
    soft/hard clips, with the reference's consistency assertions
    (realignSamFile3TargetFn, src/margin/marginAlignLib.py:320-367)."""
    out = rec.copy()
    ops: List[Tuple[int, int]] = []
    if rec.cigar and rec.cigar[0][0] == 5:
        ops.append(rec.cigar[0])
    if rec.query_alignment_start > 0:
        ops.append((4, rec.query_alignment_start))
    ops.extend(new_ops)
    if rec.query_alignment_end < len(rec.query_sequence):
        ops.append((4, len(rec.query_sequence) - rec.query_alignment_end))
    if len(rec.cigar) > 1 and rec.cigar[-1][0] == 5:
        ops.append(rec.cigar[-1])

    # Read-length consistency.
    assert sum(l for op, l in ops if op in (0, 1, 4)) == sum(
        l for op, l in rec.cigar if op in (0, 1, 4)
    )
    # Reference-span consistency.
    assert (
        sum(l for op, l in ops if op in (0, 2))
        == rec.reference_end - rec.reference_start
    )
    out.cigar = ops
    return out


def realign_sam_file(
    sam_path: str,
    output_sam_path: str,
    read_fastq_path: str,
    reference_fasta_path: str,
    hmm: PairHmm,
    device,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
    no_chain: bool = False,
    band_width: int = DEFAULT_BAND_WIDTH,
    split_size: int = DEFAULT_SPLIT_SIZE,
    fused: bool = True,
    serve: Optional[str] = None,
    multi: bool = False,
) -> None:
    """Chain (optional) + realign a SAM file end to end on `device`
    (fused=False: the REL path; serve=<mode>: circular serving in that
    mode; multi=True: multi-problem lanes where allowed; module
    docstring)."""
    check_serve(serve)
    work_sam = sam_path
    tmp = None
    if not no_chain:
        tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".sam", delete=False
        )
        tmp.close()
        chain_sam_file(
            sam_path, tmp.name, read_fastq_path, reference_fasta_path
        )
        work_sam = tmp.name

    try:
        sam = SamFile.read(work_sam)
        ref_sequences = get_fasta_dictionary(reference_fasta_path)
        jobs = _jobs_from_sam(sam, ref_sequences, encode)
        all_ops = realigned_ops_for_jobs(jobs, hmm, gap_gamma, match_gamma,
                                         device, band_width,
                                         split_size=split_size, fused=fused,
                                         serve=serve, multi=multi)
        realigned = [splice_realigned_cigar(job.record, ops)
                     for job, ops in zip(jobs, all_ops)]
        SamFile(sam.header, realigned).write(output_sam_path)
    finally:
        if tmp is not None:
            os.unlink(tmp.name)
