"""Minimal BAM writer + BAI indexer (self-contained, no pysam/htslib).

Covers what the pipeline needs: samToBamFile (reference:
src/margin/utils.py:57-66), coordinate-sorted BAM and a .bai index for the
assembly-hub builder (reference: scripts/createAssemblyHub.py:65-66 uses
pysam.sort/index).  Formats per the SAM/BAM spec (htslib BGZF + BAI
binning).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

from .sam import SamFile, SamRecord

_SEQ_NIBBLE = {
    "=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
    "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13, "B": 14, "N": 15,
}
_CIGAR_OP = "MIDNSHP=X"

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    bsize = len(data) + 25 + 1  # header(12) + extra(6) + data + crc(4) + isize(4) - 1
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6
        + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
    )
    return header + data + struct.pack(
        "<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload) & 0xFFFFFFFF
    )


class BgzfWriter:
    """BGZF writer tracking virtual file offsets (needed for BAI)."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._coffset = 0  # compressed offset of the block being filled

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= 60000:
            self._flush_block(self._buf[:60000])
            self._buf = self._buf[60000:]

    def _flush_block(self, payload) -> None:
        block = _bgzf_block(bytes(payload))
        self._fh.write(block)
        self._coffset += len(block)

    def close(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._fh.write(_BGZF_EOF)
        self._fh.close()


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_record(rec: SamRecord, ref_ids: Dict[str, int]) -> bytes:
    ref_id = ref_ids.get(rec.rname, -1)
    next_ref = ref_ids.get(rec.rnext, ref_id if rec.rnext == "=" else -1)
    name = rec.qname.encode() + b"\x00"
    cigar = b"".join(
        struct.pack("<I", (length << 4) | op) for op, length in rec.cigar
    )
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    packed = bytearray()
    for i in range(0, l_seq - 1, 2):
        packed.append(
            (_SEQ_NIBBLE.get(seq[i].upper(), 15) << 4)
            | _SEQ_NIBBLE.get(seq[i + 1].upper(), 15)
        )
    if l_seq % 2:
        packed.append(_SEQ_NIBBLE.get(seq[-1].upper(), 15) << 4)
    if rec.qual != "*" and len(rec.qual) == l_seq:
        qual = bytes((ord(q) - 33) & 0xFF for q in rec.qual)
    else:
        qual = b"\xff" * l_seq
    end = max(rec.reference_end, rec.pos + 1)
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        rec.pos,
        len(name),
        rec.mapq,
        _reg2bin(rec.pos, end) if ref_id >= 0 else 4680,
        len(rec.cigar),
        rec.flag,
        l_seq,
        next_ref,
        rec.pnext,
        rec.tlen,
    ) + name + cigar + bytes(packed) + qual
    # Tags omitted: optional fields are not consumed by any downstream tool
    # in this pipeline.
    return struct.pack("<i", len(body)) + body


def write_bam(
    sam: SamFile,
    bam_path: str,
    sort: bool = False,
) -> List[Tuple[int, int, int, int]]:
    """Write a BAM file; returns per-record (ref_id, pos, end, voffset) for
    indexing.  With sort=True, records are coordinate-sorted first."""
    names_lengths = list(sam.reference_lengths().items())
    ref_ids = {name: i for i, (name, _) in enumerate(names_lengths)}

    header_text = "\n".join(sam.header) + ("\n" if sam.header else "")
    records = list(sam.records)
    if sort:
        records.sort(
            key=lambda r: (ref_ids.get(r.rname, len(ref_ids)), r.pos)
        )

    w = BgzfWriter(bam_path)
    w.write(b"BAM\x01")
    text = header_text.encode()
    w.write(struct.pack("<i", len(text)) + text)
    w.write(struct.pack("<i", len(names_lengths)))
    for name, length in names_lengths:
        nm = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nm)) + nm + struct.pack("<i", length))

    placements = []
    for rec in records:
        voff = w.virtual_offset
        w.write(_encode_record(rec, ref_ids))
        placements.append(
            (ref_ids.get(rec.rname, -1), rec.pos, max(rec.reference_end, rec.pos + 1), voff)
        )
    end_voff = w.virtual_offset
    w.close()
    placements.append((-2, 0, 0, end_voff))  # sentinel: EOF virtual offset
    return placements


def write_bai(
    placements: List[Tuple[int, int, int, int]],
    n_refs: int,
    bai_path: str,
) -> None:
    """Write a BAI index from write_bam's placement list (sorted input)."""
    # chunks per (ref, bin); linear index per ref (16kb windows).
    per_ref_bins: List[Dict[int, List[Tuple[int, int]]]] = [
        {} for _ in range(n_refs)
    ]
    per_ref_linear: List[Dict[int, int]] = [{} for _ in range(n_refs)]

    entries = placements[:-1]
    eof_voff = placements[-1][3]
    for idx, (ref_id, pos, end, voff) in enumerate(entries):
        if ref_id < 0:
            continue
        next_voff = (
            entries[idx + 1][3] if idx + 1 < len(entries) else eof_voff
        )
        b = _reg2bin(pos, end)
        per_ref_bins[ref_id].setdefault(b, []).append((voff, next_voff))
        for win in range(pos >> 14, ((end - 1) >> 14) + 1):
            lin = per_ref_linear[ref_id]
            if win not in lin or voff < lin[win]:
                lin[win] = voff
    with open(bai_path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_refs))
        for ref_id in range(n_refs):
            bins = per_ref_bins[ref_id]
            fh.write(struct.pack("<i", len(bins)))
            for b, chunks in bins.items():
                # Merge adjacent chunks.
                merged: List[Tuple[int, int]] = []
                for beg, end_ in chunks:
                    if merged and merged[-1][1] == beg:
                        merged[-1] = (merged[-1][0], end_)
                    else:
                        merged.append((beg, end_))
                fh.write(struct.pack("<Ii", b, len(merged)))
                for beg, end_ in merged:
                    fh.write(struct.pack("<QQ", beg, end_))
            lin = per_ref_linear[ref_id]
            n_win = (max(lin) + 1) if lin else 0
            fh.write(struct.pack("<i", n_win))
            last = 0
            for win in range(n_win):
                if win in lin:
                    last = lin[win]
                fh.write(struct.pack("<Q", last))


def sam_to_bam_file(
    sam_path: str, bam_path: str, sort: bool = False, index: bool = False
) -> None:
    """samToBamFile equivalent (reference: src/margin/utils.py:57-66), with
    optional sorting and .bai indexing (pysam.sort/index equivalents)."""
    sam = SamFile.read(sam_path)
    placements = write_bam(sam, bam_path, sort=sort)
    if index:
        assert sort, "BAI requires a coordinate-sorted BAM"
        write_bai(placements, len(sam.reference_lengths()), bam_path + ".bai")
