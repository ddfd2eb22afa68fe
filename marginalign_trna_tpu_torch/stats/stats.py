"""Per-read alignment QC statistics (marginStats core).

Behavioural port of the reference's AlignedPair iterator and
ReadAlignmentStats (src/margin/utils.py:193-384), including the global
coordinate conventions (positions relative to the complete original read,
reverse-strand base fetch via complement) and the assertion-dense internal
consistency checks the reference's tests rely on (tests/tests.py:52-60).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..io.fasta import get_fasta_dictionary
from ..io.fastq import get_fastq_dictionary
from ..io.sam import SamFile, SamRecord
from ..utils.coords import first_non_clipped_position_in_read
from ..utils.seq import complement_char

_BASES = set("ACGT")


@dataclass
class AlignedPairInfo:
    ref_pos: int
    read_pos: int  # absolute position in the original read sequence
    is_reversed: bool
    ref_base: str
    read_base: str  # in reference orientation (complemented if reversed)


def aligned_pair_iterator(
    rec: SamRecord, ref_seq: str, read_seq: str
) -> Iterator[AlignedPairInfo]:
    """Aligned pairs in absolute read coordinates
    (reference: AlignedPair.iterator, utils.py:256-287).

    The read offset already accounts for clipping, so query positions are
    taken relative to the *aligned* region (the reference indexes
    query_alignment_sequence by its pair positions, utils.py:274)."""
    read_offset = first_non_clipped_position_in_read(rec, read_seq)
    q_start = rec.query_alignment_start
    aligned_seq = rec.query_alignment_sequence
    assert len(rec.query_sequence) <= len(read_seq)
    for qpos, rpos in rec.aligned_pairs:
        if qpos is None or rpos is None:
            continue
        assert rec.reference_start <= rpos < rec.reference_end
        if rpos >= len(ref_seq):
            continue  # reference masks an off-by-one in BWA SAMs the same way
        q_rel = qpos - q_start
        abs_read_pos = abs(read_offset + q_rel)
        assert 0 <= abs_read_pos < len(read_seq)
        base = read_seq[abs_read_pos]
        if rec.is_reverse:
            base = complement_char(base)
        # Consistency of the absolute-coordinate fetch with the aligned
        # sequence (the reference logs discrepancies; we enforce them).
        assert base.upper() == aligned_seq[q_rel].upper(), (
            rec.qname, qpos, abs_read_pos
        )
        yield AlignedPairInfo(
            ref_pos=rpos,
            read_pos=abs_read_pos,
            is_reversed=rec.is_reverse,
            ref_base=ref_seq[rpos],
            read_base=base,
        )


class ReadAlignmentStats:
    """Match/mismatch/indel statistics for one read alignment
    (reference: utils.py:289-384)."""

    def __init__(
        self,
        read_seq: str,
        ref_seq: str,
        rec: SamRecord,
        global_alignment: bool = False,
    ):
        self.matches = 0
        self.mismatches = 0
        self.ns = 0
        self.total_read_insertions = 0
        self.total_read_insertion_length = 0
        self.total_read_deletions = 0
        self.total_read_deletion_length = 0
        self.read_seq = read_seq
        self.ref_seq = ref_seq

        ins_len, del_len = 0, 0
        prev: Optional[AlignedPairInfo] = None
        last: Optional[AlignedPairInfo] = None
        for ap in aligned_pair_iterator(rec, ref_seq, read_seq):
            ref_u, read_u = ap.ref_base.upper(), ap.read_base.upper()
            if ref_u == read_u and ref_u in _BASES:
                self.matches += 1
            elif ref_u != read_u and ref_u in _BASES and read_u in _BASES:
                self.mismatches += 1
            else:
                self.ns += 1

            ins = self._preceding_insertion(
                ap, prev, global_alignment, len(read_seq)
            )
            if ins > 0:
                self.total_read_insertions += 1
                ins_len += ins
            dele = self._preceding_deletion(ap, prev, global_alignment)
            if dele > 0:
                self.total_read_deletions += 1
                del_len += dele
            prev = ap
            last = ap

        if global_alignment and last is not None:
            # Trailing indels against the sequence ends (utils.py:321-336).
            tail_ref = len(ref_seq) - last.ref_pos - 1
            assert tail_ref >= 0
            if tail_ref > 0:
                self.total_read_deletions += 1
                self.total_read_deletion_length += tail_ref
            if rec.is_reverse:
                if last.read_pos > 0:
                    self.total_read_insertions += 1
                    ins_len += last.read_pos
            else:
                tail = len(read_seq) - last.read_pos - 1
                assert tail >= 0
                if tail > 0:
                    self.total_read_insertions += 1
                    ins_len += tail

        assert ins_len <= len(read_seq)
        assert del_len <= len(ref_seq)
        self.total_read_insertion_length += ins_len
        self.total_read_deletion_length += del_len

    @staticmethod
    def _preceding_insertion(ap, prev, global_alignment, read_len) -> int:
        if prev is None:
            if global_alignment:
                if ap.is_reversed:
                    assert read_len - ap.read_pos - 1 >= 0
                    return read_len - ap.read_pos - 1
                return ap.read_pos
            return 0
        return abs(prev.read_pos - ap.read_pos) - 1

    @staticmethod
    def _preceding_deletion(ap, prev, global_alignment) -> int:
        if prev is None:
            if global_alignment:
                return ap.ref_pos
            return 0
        return abs(prev.ref_pos - ap.ref_pos) - 1

    # ---- metrics (reference: utils.py:343-371) ----

    @staticmethod
    def _ratio(num, den) -> float:
        return float(num) / den if den else float("nan")

    def read_coverage(self) -> float:
        aligned = self.matches + self.mismatches
        return self._ratio(aligned, aligned + self.total_read_insertion_length)

    def reference_coverage(self) -> float:
        aligned = self.matches + self.mismatches
        return self._ratio(aligned, aligned + self.total_read_deletion_length)

    def read_identity(self) -> float:
        return self._ratio(
            self.matches,
            self.matches + self.mismatches + self.total_read_insertion_length,
        )

    def alignment_identity(self) -> float:
        return self._ratio(
            self.matches,
            self.matches + self.mismatches
            + self.total_read_insertion_length
            + self.total_read_deletion_length,
        )

    def mismatches_per_aligned_base(self) -> float:
        return self._ratio(self.mismatches, self.matches + self.mismatches)

    def deletions_per_read_base(self) -> float:
        return self._ratio(
            self.total_read_deletions, self.matches + self.mismatches
        )

    def insertions_per_read_base(self) -> float:
        return self._ratio(
            self.total_read_insertions, self.matches + self.mismatches
        )

    def read_length(self) -> int:
        return len(self.read_seq)

    @staticmethod
    def get_read_alignment_stats(
        sam_path: str,
        read_fastq_path: str,
        reference_fasta_path: str,
        global_alignment: bool = True,
    ) -> List["ReadAlignmentStats"]:
        refs = get_fasta_dictionary(reference_fasta_path)
        reads = get_fastq_dictionary(read_fastq_path)
        sam = SamFile.read(sam_path)
        return [
            ReadAlignmentStats(
                reads[rec.qname], refs[rec.rname], rec, global_alignment
            )
            for rec in sam.mapped()
        ]
