"""Chaining of fragmentary alignments into one global alignment per read.

Behavioural re-implementation of the reference's chaining stage
(src/margin/marginAlignLib.py:9-199): per (read, reference) bucket, find the
highest-scoring colinear chain of aligned segments, then merge them into a
single segment whose cigar soft-clips the unaligned read prefix/suffix and
represents inter-segment gaps as deletions/insertions.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..io.fasta import get_fasta_dictionary
from ..io.fastq import fastq_read
from ..io.sam import SamFile, SamRecord
from ..utils.coords import (
    first_non_clipped_position_in_read,
    last_non_clipped_position_in_read,
)
from ..utils.seq import reverse_complement


def _default_score(rec: SamRecord) -> int:
    """Number of aligned (M) positions (reference: chainFn score,
    marginAlignLib.py:110-112)."""
    return sum(length for op, length in rec.cigar if op == 0)


def chain_segments(
    segments: List[SamRecord],
    read_seq: str,
    max_gap: int = 200,
    score_fn: Callable[[SamRecord], int] = _default_score,
) -> List[SamRecord]:
    """Highest-scoring colinear chain on one strand
    (reference: chainFn, marginAlignLib.py:110-157).

    Uses the same O(n^2) chaining DP over segments sorted by reference start,
    with the same chain-compatibility conditions (strict ref and read
    ordering, same strand, total gap <= max_gap).
    """
    coords = {
        id(r): (
            r.reference_start,
            first_non_clipped_position_in_read(r, read_seq),
            r.reference_end - 1,
            last_non_clipped_position_in_read(r, read_seq),
        )
        for r in segments
    }
    scores = {id(r): score_fn(r) for r in segments}
    pointers: Dict[int, SamRecord] = {}

    ordered = sorted(segments, key=lambda r: coords[id(r)][0])
    for i, rec in enumerate(ordered):
        r_start, q_start, _, _ = coords[id(rec)]
        base_score = scores[id(rec)]
        for j in range(i):
            prev = ordered[j]
            _, _, r_end2, q_end2 = coords[id(prev)]
            if (
                r_start > r_end2
                and q_start > q_end2
                and rec.is_reverse == prev.is_reverse
                and r_start - r_end2 + q_start - q_end2 <= max_gap
                and base_score + scores[id(prev)] > scores[id(rec)]
            ):
                scores[id(rec)] = base_score + scores[id(prev)]
                pointers[id(rec)] = prev

    best = max(ordered, key=lambda r: scores[id(r)])
    chain = [best]
    while id(chain[-1]) in pointers:
        chain.append(pointers[id(chain[-1])])
    chain.reverse()
    return chain


def merge_chained_segments(
    chain: List[SamRecord], ref_seq: str, read_seq: str
) -> SamRecord:
    """Merge a chain into one global alignment segment
    (reference: mergeChainedAlignedSegments, marginAlignLib.py:9-108).

    The merged cigar: soft-clip for the unaligned read prefix, deletions for
    unaligned reference between segments, insertions for unaligned read
    between segments, the segments' own M/I/D ops (clips stripped), and a
    trailing soft clip.
    """
    first = chain[0]
    merged = SamRecord(
        qname=first.qname,
        flag=16 if first.is_reverse else 0,
        rname=first.rname,
        pos=first.reference_start,
        mapq=first.mapq,
        cigar=[],
        seq=reverse_complement(read_seq) if first.is_reverse else read_seq,
        qual="*",
    )

    cigar: List[Tuple[int, int]] = []
    p_pos = first.reference_start
    # Iterate from the other end of the sequence if reversed.
    p_qpos = -(len(read_seq) - 1) if merged.is_reverse else 0

    for rec in chain:
        assert merged.is_reverse == rec.is_reverse
        # Deletion for preceding unaligned reference positions.
        assert rec.reference_start >= p_pos
        if rec.reference_start > p_pos:
            cigar.append((2, rec.reference_start - p_pos))
            p_pos = rec.reference_start

        # Insertion (or leading soft clip) for preceding unaligned read bases.
        q_pos = first_non_clipped_position_in_read(rec, read_seq)
        assert q_pos >= p_qpos
        if q_pos > p_qpos:
            cigar.append((4 if rec is chain[0] else 1, q_pos - p_qpos))
            p_qpos = q_pos

        for op, length in rec.cigar:
            assert op in (0, 1, 2, 4, 5)
            if op in (0, 1, 2):
                cigar.append((op, length))
            if op in (0, 2):
                p_pos += length
            if op in (0, 1):
                p_qpos += length

    assert p_pos <= len(ref_seq)

    # Trailing soft clip.
    if merged.is_reverse:
        assert p_qpos <= 1
        if p_qpos < 1:
            cigar.append((4, -p_qpos + 1))
    else:
        assert p_qpos <= len(read_seq)
        if p_qpos < len(read_seq):
            cigar.append((4, len(read_seq) - p_qpos))

    merged.cigar = cigar

    # Same consistency assertions as the reference (marginAlignLib.py:94-106).
    for op, _ in merged.cigar:
        assert op in (0, 1, 2, 4)
    assert (
        sum(l for op, l in cigar if op in (0, 2))
        == merged.reference_end - merged.reference_start
    )
    assert 0 <= merged.reference_start < len(ref_seq)
    assert 0 <= merged.reference_end <= len(ref_seq)
    assert 0 <= merged.query_alignment_start < len(read_seq)
    assert 0 <= merged.query_alignment_end <= len(read_seq)
    assert (
        merged.query_alignment_start + sum(l for op, l in cigar if op in (0, 1))
        == merged.query_alignment_end
    )
    return merged


def chain_sam_file(
    sam_path: str,
    output_sam_path: str,
    read_fastq_path: str,
    reference_fasta_path: str,
    max_gap: int = 200,
) -> None:
    """Chain a whole SAM file so each read has one global alignment per
    reference (reference: chainSamFile, marginAlignLib.py:159-199)."""
    sam = SamFile.read(sam_path)
    ref_sequences = get_fasta_dictionary(reference_fasta_path)

    buckets: Dict[str, Dict[str, List[SamRecord]]] = {}
    for rec in sam.mapped():
        buckets.setdefault(rec.qname, {}).setdefault(rec.rname, []).append(rec)

    chained: List[SamRecord] = []
    for read_name, read_seq, _ in fastq_read(read_fastq_path):
        read_name = read_name.split()[0]
        if read_name in buckets:
            for ref_name, segments in buckets[read_name].items():
                ref_seq = ref_sequences[ref_name]
                chained.append(
                    merge_chained_segments(
                        chain_segments(segments, read_seq, max_gap),
                        ref_seq,
                        read_seq,
                    )
                )
            buckets.pop(read_name)
    # All reads in the sam file should be in the input read file.
    assert len(buckets) == 0, "Reads in SAM missing from FASTQ: %s" % list(buckets)

    chained.sort(key=lambda r: (r.rname, r.reference_start, r.reference_end))
    SamFile(sam.header, chained).write(output_sam_path)
