"""FASTQ reading/writing.

Same behavioural surface as the reference's bioio fastqRead/fastqWrite
(scripts/bioio.py:109-156), including quality-length validation, plus the
name-uniquifying helpers (src/margin/utils.py:91-104).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple


def fastq_read(path_or_handle) -> Iterator[Tuple[str, str, str]]:
    """Yield (name, sequence, qualities-string) triples."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        handle = open(path_or_handle, "r")
        own = True
    else:
        handle = path_or_handle
        own = False
    try:
        while True:
            header = handle.readline()
            if not header:
                break
            header = header.rstrip("\n")
            if not header:
                continue
            assert header.startswith("@"), "Bad fastq header: %r" % header
            seq = handle.readline().rstrip("\n")
            plus = handle.readline().rstrip("\n")
            assert plus.startswith("+"), "Bad fastq separator: %r" % plus
            quals = handle.readline().rstrip("\n")
            assert len(quals) == len(seq), (
                "Fastq quality length mismatch for %s" % header
            )
            yield header[1:], seq, quals
    finally:
        if own:
            handle.close()


def fastq_write(handle, name: str, seq: str, quals: str) -> None:
    assert len(seq) == len(quals)
    handle.write("@%s\n%s\n+\n%s\n" % (name, seq, quals))


def get_fastq_dictionary(path: str) -> Dict[str, str]:
    """First word of header -> sequence, asserting uniqueness
    (reference: src/margin/utils.py:184-191)."""
    out: Dict[str, str] = {}
    for name, seq, _ in fastq_read(path):
        key = name.split()[0]
        assert key not in out, "Duplicate fastq sequence name: %s" % key
        out[key] = seq
    return out


def make_fastq_names_unique(input_path: str, output_path: str) -> str:
    """Append 'i' to duplicated first-word names
    (reference: src/margin/utils.py:91-104)."""
    names = set()
    with open(output_path, "w") as fh:
        for name, seq, quals in fastq_read(input_path):
            name = name.split()[0]
            while name in names:
                name += "i"
            names.add(name)
            fastq_write(fh, name, seq, quals)
    return output_path
