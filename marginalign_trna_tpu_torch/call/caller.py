"""marginCaller on one torch device: posterior-expectation SNV calling.

Port of marginalign_trna_tpu/call/caller.py (behavioural equivalent of the
reference's src/margin/marginCallerLib.py) on its default accelerator path,
compact streams plus fused expectations: for every reference position,
accumulate the expected count of each read base, weighted by the pair-HMM
posterior match probability (or 1.0 per aligned pair with --noMargin);
then Bayes-invert through the error model's substitution matrix and emit
VCF for the non-reference bases above the posterior threshold.

Per bucket of anchor-split jobs the host packs only sequences and band
offsets (ops/band.py `pack_compact_batch`); on the device the band streams
expand, the backward and the expectation-accumulating forward run, and the
flushed totals scatter into one dense [positions, 4] tensor over all
references (ops/expectations.py).  Only that tensor comes back.

With serve=<mode> (one of ops/fb_circ.py SERVE_MODES; the JAX package
with MARGINALIGN_LAYOUT=circ MARGINALIGN_CALLER_FUSED=off
MARGINALIGN_CIRC_SERVE=<mode>) the buckets take the unfused circular
route instead: band arrays packed on the host and uploaded, the
forward-backward of that mode in the circular layout (ops/fb_circ.py
`posteriors_serve`) and the posterior band summed per position
(ops/expectations.py `band_expectations`).

With multi=True (the JAX package's MARGINALIGN_MULTI=on, its
call/caller.py:104-134), checked before `serve`: when the anchor-split
jobs all fit align/realign.py `use_multi_lanes`, they go into one batch of
multi-problem lanes (ops/band.py `pack_multi_banded_batch`), the
forward-backward of ops/fb_multi_cuda.py `posteriors_multi`, and the
posterior band summed per position over each lane's virtual reference
space (ops/expectations.py `multi_band_expectations`).

A model whose gap emissions are not flat (an un-normalised EM model) cannot
run those kernels; as in the JAX package, its buckets are packed as band
arrays (`pack_banded_batch`), run through the generic forward-backward pair
(ops/fb_generic_cuda.py) and summed per position from the posterior band
(`band_expectations`), whatever `serve` says.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.realign import (
    _bucket_jobs, _jobs_from_sam, split_jobs_at_anchors, use_multi_lanes,
)
from ..io.fasta import get_fasta_dictionary
from ..io.sam import SamFile
from ..io.vcf import vcf_read, vcf_write
from ..models.hmm import PairHmm
from ..ops.band import (
    pack_banded_batch, pack_compact_batch, pack_multi_banded_batch,
)
from ..ops.expectations import (
    band_expectations, band_expectations_cx, multi_band_expectations,
)
from ..ops.fb import device_batch, multi_device_batch, tables_from_hmm
from ..ops.fb_circ import check_serve, compact_device_batch, posteriors_serve
from ..ops.fb_cuda import has_flat_gap_emissions
from ..ops.fb_generic_cuda import posteriors_generic
from ..ops.fb_multi_cuda import posteriors_multi
from ..pipeline import resolve_device
from ..utils.seq import BASES, encode

DEFAULT_THRESHOLD = 0.3  # src/margin/marginCaller.py:28-30
CALLER_BAND_WIDTH = 21   # diagonalExpansion=10 (marginCallerLib.py:54)


@dataclass
class CallerOptions:
    threshold: float = DEFAULT_THRESHOLD
    no_margin: bool = False
    band_width: int = CALLER_BAND_WIDTH
    # Padded DP cells per device batch.
    max_batch_cells: int = 96_000_000
    # Reference caller-path --splitMatrixBiggerThanThis=100
    # (src/margin/marginCallerLib.py:55); 0 disables splitting.
    split_size: int = 100


def _no_margin_expectations(sam: SamFile,
                            expectations: Dict[str, np.ndarray]) -> None:
    """Weight 1.0 per aligned pair of the input alignment
    (marginCallerLib.py:69 with --rescoreOriginalAlignment), added in
    place.  The reference's rescore pass in this mode discards its
    posteriors, so it is not run."""
    for rec in sam.mapped():
        exp = expectations[rec.rname]
        codes = encode(rec.query_sequence)
        qpos, rpos = 0, rec.pos
        qs, rs = [], []
        for op, length in rec.cigar:
            if op in (0, 7, 8):
                qs.append(np.arange(qpos, qpos + length))
                rs.append(np.arange(rpos, rpos + length))
            if op in (0, 7, 8, 1, 4):
                qpos += length
            if op in (0, 7, 8, 2, 3):
                rpos += length
        if not qs:
            continue
        q = np.concatenate(qs)
        r = np.concatenate(rs)
        c = codes[q].astype(np.int64)
        keep = (c < 4) & (r < exp.shape[0])
        np.add.at(exp, (r[keep], c[keep]), 1.0)


def _multi_expectations(jobs, starts: np.ndarray, tables, dev,
                        band_width: int, exp_global: np.ndarray) -> None:
    """Every job in one batch of multi-problem lanes: the multi
    forward-backward pair, then the posterior band summed per position into
    exp_global [total, 4] (job p's reference window starts at starts[p])."""
    mb = pack_multi_banded_batch(
        [j.read_region for j in jobs], [j.ref_region for j in jobs],
        width=band_width, paths=[j.path for j in jobs],
    )
    mdev = multi_device_batch(mb, dev)
    _, post = posteriors_multi(tables, mdev)
    multi_band_expectations(post, mb, mdev, starts, exp_global)


def accumulate_expectations(
    sam: SamFile,
    ref_sequences: Dict[str, str],
    alignment_hmm: Optional[PairHmm],
    options: CallerOptions,
    device="cuda",
    serve: Optional[str] = None,
    multi: bool = False,
) -> Dict[str, np.ndarray]:
    """-> {ref_name: [ref_len, 4] expected base counts}.  The posterior
    pass runs on `device` (the kernels on "cuda", their plain versions on
    "cpu"); multi=True takes multi-problem lanes where align/realign.py
    `use_multi_lanes` allows; serve=<mode> takes the unfused circular route
    in that mode (module docstring), an unknown mode raises ValueError."""
    check_serve(serve)
    expectations = {
        name: np.zeros((len(seq), 4)) for name, seq in ref_sequences.items()
    }
    dev = resolve_device(device)
    if options.no_margin:
        _no_margin_expectations(sam, expectations)
        return expectations

    jobs = _jobs_from_sam(sam, ref_sequences, encode)
    # Anchor splitting (reference --splitMatrixBiggerThanThis): segment
    # offsets shift by the segment's ref start inside its job.
    job_ref_off = [0] * len(jobs)
    if options.split_size and options.split_size > 0:
        jobs, _, seg_starts = split_jobs_at_anchors(jobs, options.split_size)
        job_ref_off = [st[1] for st in seg_starts]
    tables = tables_from_hmm(alignment_hmm, dev)
    # marginalign_trna_tpu/call/caller.py:173-177, 223-244.
    flat_gaps = has_flat_gap_emissions(tables)
    compact = flat_gaps and serve is None

    # Global coordinate space: all references concatenated, so one dense
    # [total, 4] scatter covers every lane whatever reference it aligns to.
    global_off = {}
    total = 0
    for name, seq in ref_sequences.items():
        global_off[name] = total
        total += len(seq)
    exp_global = np.zeros((total, 4))
    if multi and use_multi_lanes(jobs, tables):
        starts = np.array(
            [global_off[j.record.rname] + j.record.reference_start
             + job_ref_off[idx] for idx, j in enumerate(jobs)],
            dtype=np.int64)
        _multi_expectations(jobs, starts, tables, dev, options.band_width,
                            exp_global)
    else:
        for bucket in _bucket_jobs(jobs, options.band_width,
                                   options.max_batch_cells):
            pack = pack_compact_batch if compact else pack_banded_batch
            batch = pack(
                [jobs[i].read_region for i in bucket],
                [jobs[i].ref_region for i in bucket],
                width=options.band_width,
                paths=[jobs[i].path for i in bucket],
                quantize=True,
            )
            offsets = np.zeros(batch.batch, dtype=np.int64)
            for local_b, job_idx in enumerate(bucket):
                rec = jobs[job_idx].record
                offsets[local_b] = (global_off[rec.rname] + rec.reference_start
                                    + job_ref_off[job_idx])
            if compact:
                exp_global += band_expectations_cx(
                    tables, batch, compact_device_batch(batch, dev), offsets,
                    total)
            else:
                bdev = device_batch(batch, dev)
                if flat_gaps:
                    _, post = posteriors_serve(tables, batch, bdev, serve)
                else:
                    _, post = posteriors_generic(tables, bdev)
                exp_global += band_expectations(post, batch, bdev, offsets,
                                                total, len(bucket))
    for name, seq in ref_sequences.items():
        off = global_off[name]
        expectations[name] += exp_global[off : off + len(seq)]
    return expectations


def calc_base_posterior_probs(
    base_observations: np.ndarray,  # [4] normalised expected counts
    ref_base: str,
    error_sub_matrix: np.ndarray,   # [4, 4] P(obs | true)
    evo_sub_matrix: Optional[np.ndarray] = None,  # [4, 4] prior (default null)
) -> np.ndarray:
    """Log-space Bayes with log-sum-exp normalisation
    (reference: calcBasePosteriorProbs, marginCallerLib.py:81-91)."""
    if evo_sub_matrix is None:
        evo_sub_matrix = np.ones((4, 4))
    rb = BASES.find(ref_base.upper())
    prior = evo_sub_matrix[rb] if rb >= 0 else np.ones(4)
    logp = np.log(prior) + (
        np.log(np.maximum(error_sub_matrix, 1e-300)) @ base_observations
    )
    logp -= logp.max()
    p = np.exp(logp)
    return p / p.sum()


def call_variants(
    expectations: Dict[str, np.ndarray],
    ref_sequences: Dict[str, str],
    error_hmm: PairHmm,
    threshold: float,
) -> List[Tuple[str, int, str, float]]:
    """-> [(ref_name, 0-based pos, alt base, posterior prob)]"""
    error_matrix = error_hmm.substitution_matrix()
    calls: List[Tuple[str, int, str, float]] = []
    for ref_name, exp in expectations.items():
        seq = ref_sequences[ref_name]
        covered = np.where(exp.sum(axis=1) > 0)[0]
        for pos in covered:
            total = exp[pos].sum()
            probs = calc_base_posterior_probs(
                exp[pos] / total, seq[pos], error_matrix
            )
            for bi, base in enumerate(BASES):
                if base != seq[pos] and probs[bi] >= threshold:
                    calls.append((ref_name, int(pos), base, float(probs[bi])))
    return calls


def margin_caller(
    sam_path: str,
    reference_fasta_path: str,
    output_vcf_path: str,
    alignment_model: PairHmm,
    error_model: PairHmm,
    options: Optional[CallerOptions] = None,
    device="cuda",
    serve: Optional[str] = None,
    multi: bool = False,
) -> List[Tuple[str, int, str, float]]:
    """Full marginCaller pipeline on `device` (reference:
    marginCallerTargetFn + variantCallSamFileTargetFn,
    marginCallerLib.py:15-222); serve=<mode>: the unfused circular route,
    multi=True: multi-problem lanes where allowed
    (`accumulate_expectations`)."""
    check_serve(serve)
    options = options or CallerOptions()
    sam = SamFile.read(sam_path)
    ref_sequences = get_fasta_dictionary(reference_fasta_path)
    expectations = accumulate_expectations(
        sam, ref_sequences, alignment_model, options, device, serve, multi
    )
    calls = call_variants(
        expectations, ref_sequences, error_model, options.threshold
    )
    vcf_write(reference_fasta_path, ref_sequences, calls, output_vcf_path)
    # Round-trip self-check, like the reference (marginCallerLib.py:219-222).
    vcf_calls = vcf_read(output_vcf_path)
    expected = {(c[0], c[1] + 1, c[2]) for c in calls}
    assert vcf_calls == expected
    return calls
