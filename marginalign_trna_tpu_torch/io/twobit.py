"""UCSC .2bit writer (pure Python faToTwoBit equivalent).

The reference ships a (missing) faToTwoBit binary for its assembly-hub
builder (scripts/createAssemblyHub.py:78, .MISSING_LARGE_BLOBS); this
implements the .2bit format directly.  Spec: 16-byte header, sequence index,
then per sequence: dnaSize, N blocks, mask blocks, reserved word, packed
2-bit bases (T=0, C=1, A=2, G=3).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

_CODE = {"T": 0, "C": 1, "A": 2, "G": 3}
SIGNATURE = 0x1A412743
VERSION = 0


def _blocks(mask: List[bool]) -> Tuple[List[int], List[int]]:
    starts, sizes = [], []
    i = 0
    n = len(mask)
    while i < n:
        if mask[i]:
            j = i
            while j < n and mask[j]:
                j += 1
            starts.append(i)
            sizes.append(j - i)
            i = j
        else:
            i += 1
    return starts, sizes


def write_2bit(sequences: Dict[str, str], path: str) -> None:
    names = list(sequences.keys())
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IIII", SIGNATURE, VERSION, len(names), 0))
        # Index: name + offset placeholder.
        index_positions = {}
        for name in names:
            nm = name.encode()
            fh.write(struct.pack("<B", len(nm)) + nm)
            index_positions[name] = fh.tell()
            fh.write(struct.pack("<I", 0))
        # Sequence records.
        offsets = {}
        for name in names:
            seq = sequences[name]
            offsets[name] = fh.tell()
            n_mask = [c.upper() == "N" or c.upper() not in _CODE for c in seq]
            soft_mask = [c.islower() for c in seq]
            n_starts, n_sizes = _blocks(n_mask)
            m_starts, m_sizes = _blocks(soft_mask)
            fh.write(struct.pack("<I", len(seq)))
            fh.write(struct.pack("<I", len(n_starts)))
            for v in n_starts:
                fh.write(struct.pack("<I", v))
            for v in n_sizes:
                fh.write(struct.pack("<I", v))
            fh.write(struct.pack("<I", len(m_starts)))
            for v in m_starts:
                fh.write(struct.pack("<I", v))
            for v in m_sizes:
                fh.write(struct.pack("<I", v))
            fh.write(struct.pack("<I", 0))  # reserved
            packed = bytearray((len(seq) + 3) // 4)
            for i, c in enumerate(seq):
                code = _CODE.get(c.upper(), 0)  # N packs as T per spec
                packed[i // 4] |= code << (2 * (3 - i % 4))
            fh.write(bytes(packed))
        # Fill in offsets.
        for name in names:
            fh.seek(index_positions[name])
            fh.write(struct.pack("<I", offsets[name]))


def read_2bit_names_and_sizes(path: str) -> Dict[str, int]:
    """Small reader used by tests: {name: dnaSize}."""
    with open(path, "rb") as fh:
        sig, ver, count, _ = struct.unpack("<IIII", fh.read(16))
        assert sig == SIGNATURE, "not a 2bit file"
        entries = []
        for _ in range(count):
            (nlen,) = struct.unpack("<B", fh.read(1))
            name = fh.read(nlen).decode()
            (off,) = struct.unpack("<I", fh.read(4))
            entries.append((name, off))
        out = {}
        for name, off in entries:
            fh.seek(off)
            (size,) = struct.unpack("<I", fh.read(4))
            out[name] = size
        return out
