"""Sequence encoding utilities.

Encoding convention used throughout the framework: A=0, C=1, G=2, T=3, and any
other IUPAC/wildcard character (N, R, Y, ...) = 4.  Code 4 is treated as an
ambiguous base whose emission probability is the average over the four real
bases, mirroring the reference's handling of wildcards (which simply skips
them when accumulating expectations, marginCallerLib.py:68).
"""
from __future__ import annotations

import numpy as np

BASES = "ACGT"
N_CODE = 4

# byte -> code lookup covering upper and lower case.
_ENC = np.full(256, N_CODE, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i

_COMPLEMENT = {
    "A": "T", "T": "A", "G": "C", "C": "G",
    "a": "t", "t": "a", "g": "c", "c": "g",
}

_COMP_TABLE = bytes(
    ord(_COMPLEMENT.get(chr(c), chr(c))) for c in range(256)
)


def encode(seq: str) -> np.ndarray:
    """Encode a DNA string into int8 codes (A=0,C=1,G=2,T=3, other=4)."""
    return _ENC[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.int8)].tobytes().decode("ascii")


def reverse_complement(seq: str) -> str:
    """Reverse complement, preserving case; non-ACGT characters unchanged.

    Mirrors the reference's reverseComplement (scripts/bioio.py:208-216).
    """
    return seq.encode("ascii").translate(_COMP_TABLE)[::-1].decode("ascii")


def complement_char(c: str) -> str:
    return _COMPLEMENT.get(c, c)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (4/N maps to itself)."""
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int8)
    return comp[np.asarray(codes, dtype=np.int8)][::-1]
