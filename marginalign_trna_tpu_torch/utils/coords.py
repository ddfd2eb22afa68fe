"""Read/reference coordinate conventions: clipping and reverse strand.

Reimplements the reference's coordinate translation semantics exactly
(src/margin/utils.py:12-33): positions are relative to the complete original
read sequence (including hard-clipped bases), and reverse-strand coordinates
are negated so that the reverse-strand coordinate of read position p (0-based,
in original orientation) is -(len(read)-1-p).
"""
from __future__ import annotations

from ..io.sam import SamRecord


def first_non_clipped_position_in_read(rec: SamRecord, read_seq: str) -> int:
    """Coordinate of the first non-clipped read position relative to the
    complete read sequence; negative on the reverse strand
    (reference: getFirstNonClippedPositionInRead, utils.py:12-26)."""
    if rec.cigar and rec.cigar[0][0] == 5:
        read_offset = rec.cigar[0][1]
    else:
        read_offset = 0
    if rec.is_reverse:  # SEQ is reverse complemented
        read_offset = -(len(read_seq) - 1 - read_offset)
    read_offset += rec.query_alignment_start  # removes soft clipping
    return read_offset


def last_non_clipped_position_in_read(rec: SamRecord, read_seq: str) -> int:
    """(reference: getLastNonClippedPositionInRead, utils.py:28-33)"""
    return (
        first_non_clipped_position_in_read(rec, read_seq)
        + rec.query_alignment_end
        - rec.query_alignment_start
        - 1
    )
