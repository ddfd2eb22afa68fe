"""Minimal SAM reader/writer and record model.

The reference uses pysam; this framework has a self-contained text-SAM codec
exposing exactly the record surface the pipeline needs (reference call sites:
src/margin/marginAlignLib.py, src/margin/utils.py).  CIGAR op codes follow the
SAM spec / pysam numbering: 0=M 1=I 2=D 3=N 4=S 5=H 6=P 7== 8=X.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

CIGAR_OPS = "MIDNSHP=X"
_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# Ops that consume query / reference sequence.
QUERY_OPS = frozenset((0, 1, 4, 7, 8))
REF_OPS = frozenset((0, 2, 3, 7, 8))


def parse_cigar(cigar_string: str) -> List[Tuple[int, int]]:
    """Parse a SAM CIGAR string into a list of (op, length) tuples."""
    if cigar_string in ("*", ""):
        return []
    ops = []
    num = 0
    for ch in cigar_string:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((_OP_CODE[ch], num))
            num = 0
    return ops


def format_cigar(cigar: Sequence[Tuple[int, int]]) -> str:
    if not cigar:
        return "*"
    return "".join("%d%s" % (length, CIGAR_OPS[op]) for op, length in cigar)


@dataclass
class SamRecord:
    """One alignment line.  ``pos`` is the 0-based reference start
    (SAM text stores it 1-based)."""

    qname: str
    flag: int
    rname: str  # "*" if unmapped
    pos: int  # 0-based reference start; -1 if unmapped
    mapq: int
    cigar: List[Tuple[int, int]]
    rnext: str = "*"
    pnext: int = -1
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: List[str] = field(default_factory=list)

    # ---- pysam-alike derived properties used by the pipeline ----

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @is_reverse.setter
    def is_reverse(self, value: bool) -> None:
        self.flag = (self.flag | 16) if value else (self.flag & ~16)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4) or self.rname == "*"

    @property
    def query_sequence(self) -> str:
        """SEQ as stored: includes soft-clipped, excludes hard-clipped bases."""
        return self.seq

    @property
    def reference_start(self) -> int:
        return self.pos

    @property
    def reference_end(self) -> int:
        """Exclusive end on the reference, derived from the CIGAR."""
        return self.pos + sum(l for op, l in self.cigar if op in REF_OPS)

    @property
    def query_alignment_start(self) -> int:
        """First aligned (non-soft-clipped) index into query_sequence."""
        qstart = 0
        for op, length in self.cigar:
            if op == 4:
                qstart += length
            elif op != 5:
                break
        return qstart

    @property
    def query_alignment_end(self) -> int:
        """Exclusive end of the aligned part of query_sequence."""
        qend = sum(l for op, l in self.cigar if op in QUERY_OPS)
        for op, length in reversed(self.cigar):
            if op == 4:
                qend -= length
            elif op != 5:
                break
        return qend

    @property
    def query_alignment_sequence(self) -> str:
        return self.seq[self.query_alignment_start : self.query_alignment_end]

    @property
    def query_length(self) -> int:
        return len(self.seq) if self.seq != "*" else 0

    @property
    def aligned_pairs(self) -> List[Tuple[Optional[int], Optional[int]]]:
        """(query_pos, ref_pos) pairs over M/I/D/S ops, pysam-style: query
        positions index query_sequence (soft clips included, ref side None);
        deletions have query side None."""
        pairs: List[Tuple[Optional[int], Optional[int]]] = []
        qpos, rpos = 0, self.pos
        for op, length in self.cigar:
            if op in (0, 7, 8):
                for _ in range(length):
                    pairs.append((qpos, rpos))
                    qpos += 1
                    rpos += 1
            elif op in (1, 4):
                for _ in range(length):
                    pairs.append((qpos, None))
                    qpos += 1
            elif op in (2, 3):
                for _ in range(length):
                    pairs.append((None, rpos))
                    rpos += 1
            # 5 (H) and 6 (P) consume nothing here
        return pairs

    def copy(self) -> "SamRecord":
        return SamRecord(
            self.qname, self.flag, self.rname, self.pos, self.mapq,
            list(self.cigar), self.rnext, self.pnext, self.tlen, self.seq,
            self.qual, list(self.tags),
        )

    # ---- text codec ----

    @staticmethod
    def from_line(line: str) -> "SamRecord":
        f = line.rstrip("\n").split("\t")
        return SamRecord(
            qname=f[0],
            flag=int(f[1]),
            rname=f[2],
            pos=int(f[3]) - 1,
            mapq=int(f[4]),
            cigar=parse_cigar(f[5]),
            rnext=f[6],
            pnext=int(f[7]) - 1,
            tlen=int(f[8]),
            seq=f[9],
            qual=f[10],
            tags=f[11:],
        )

    def to_line(self) -> str:
        return "\t".join(
            [
                self.qname,
                str(self.flag),
                self.rname,
                str(self.pos + 1),
                str(self.mapq),
                format_cigar(self.cigar),
                self.rnext,
                str(self.pnext + 1),
                str(self.tlen),
                self.seq,
                self.qual,
            ]
            + list(self.tags)
        )


class SamFile:
    """Parsed SAM file: header lines + records."""

    def __init__(self, header: List[str], records: List[SamRecord]):
        self.header = header
        self.records = records

    @staticmethod
    def read(path: str) -> "SamFile":
        header, records = [], []
        with open(path) as fh:
            for line in fh:
                if line.startswith("@"):
                    header.append(line.rstrip("\n"))
                elif line.strip():
                    records.append(SamRecord.from_line(line))
        return SamFile(header, records)

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            for line in self.header:
                fh.write(line + "\n")
            for rec in self.records:
                fh.write(rec.to_line() + "\n")

    def mapped(self) -> Iterator[SamRecord]:
        """Iterate records with a reference alignment
        (reference: samIterator, src/margin/utils.py:106-112)."""
        for rec in self.records:
            if rec.rname != "*":
                yield rec

    def reference_lengths(self) -> Dict[str, int]:
        out = {}
        for line in self.header:
            if line.startswith("@SQ"):
                name, length = None, None
                for fieldstr in line.split("\t")[1:]:
                    if fieldstr.startswith("SN:"):
                        name = fieldstr[3:]
                    elif fieldstr.startswith("LN:"):
                        length = int(fieldstr[3:])
                if name is not None:
                    out[name] = length
        return out


def make_header(ref_names_and_lengths: Sequence[Tuple[str, int]]) -> List[str]:
    """@SQ-first header like the reference's LAST mapper builds by hand
    (src/margin/mappers/last.py:11-14)."""
    return ["@SQ\tSN:%s\tLN:%d" % (n, l) for n, l in ref_names_and_lengths]


def combine_sam_files(base_path: str, extra_paths: List[str], out_path: str) -> None:
    """Concatenate records from several SAMs under the base header
    (reference: combineSamFiles, src/margin/utils.py:114-125)."""
    base = SamFile.read(base_path)
    records = list(base.records)
    for p in extra_paths:
        records.extend(SamFile.read(p).records)
    SamFile(base.header, records).write(out_path)
