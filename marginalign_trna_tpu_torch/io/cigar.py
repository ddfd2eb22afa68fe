"""Exonerate-style cigar codec.

The reference pipeline serializes each SAM record as an exonerate cigar line
(`cigar: qname qstart qend + rname rstart rend + 1 M 10 D 2 ...`) which is the
contract between its stages and cPecanRealign (reference:
getExonerateCigarFormatString, src/margin/utils.py:35-55; cigarRead in
sonLib bioio).  This framework passes structured data between stages, but the
codec is kept for interop, goldens and debugging.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .sam import SamRecord

_OP_TO_CHAR = {0: "M", 1: "I", 2: "D"}
_CHAR_TO_OP = {"M": 0, "I": 1, "D": 2}


@dataclass
class ExonerateCigar:
    query_name: str
    query_start: int
    query_end: int
    query_strand: str
    ref_name: str
    ref_start: int
    ref_end: int
    ref_strand: str
    score: int
    ops: List[Tuple[int, int]]  # (op, length) with op in {0:M, 1:I, 2:D}

    def to_string(self) -> str:
        opstr = " ".join(
            "%s %d" % (_OP_TO_CHAR[op], length) for op, length in self.ops
        )
        return "cigar: %s %d %d %s %s %d %d %s %d %s" % (
            self.query_name, self.query_start, self.query_end,
            self.query_strand, self.ref_name, self.ref_start, self.ref_end,
            self.ref_strand, self.score, opstr,
        )

    @staticmethod
    def from_string(line: str) -> "ExonerateCigar":
        fields = line.strip().split()
        assert fields[0] == "cigar:", "Not an exonerate cigar line: %r" % line
        ops = []
        rest = fields[10:]
        assert len(rest) % 2 == 0
        for i in range(0, len(rest), 2):
            ops.append((_CHAR_TO_OP[rest[i]], int(rest[i + 1])))
        return ExonerateCigar(
            query_name=fields[1],
            query_start=int(fields[2]),
            query_end=int(fields[3]),
            query_strand=fields[4],
            ref_name=fields[5],
            ref_start=int(fields[6]),
            ref_end=int(fields[7]),
            ref_strand=fields[8],
            score=int(fields[9]),
            ops=ops,
        )


def from_sam_record(rec: SamRecord, score: int = 1) -> ExonerateCigar:
    """Build the exonerate cigar describing a SAM record, with query
    coordinates relative to query_sequence (soft clips included in the
    coordinate system but not the ops), exactly like the reference
    (src/margin/utils.py:35-55)."""
    ops = [(op, length) for op, length in rec.cigar if op in (0, 1, 2)]
    return ExonerateCigar(
        query_name=rec.qname,
        query_start=rec.query_alignment_start,
        query_end=rec.query_alignment_end,
        query_strand="+",
        ref_name=rec.rname,
        ref_start=rec.reference_start,
        ref_end=rec.reference_end,
        ref_strand="+",
        score=score,
        ops=ops,
    )
