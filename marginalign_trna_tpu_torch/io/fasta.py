"""FASTA reading/writing.

Provides the same surface the reference uses from sonLib's bioio
(fastaRead/fastaWrite, scripts/bioio.py:71-107) plus dictionary loaders with
uniqueness assertions (src/margin/utils.py:68-75).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, TextIO, Tuple


def fasta_read(path_or_handle) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) pairs.  Name is the full header line sans '>'."""
    handle, own = _as_handle(path_or_handle, "r")
    try:
        name = None
        chunks = []
        for line in handle:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:]
                chunks = []
            elif line:
                chunks.append(line.strip())
        if name is not None:
            yield name, "".join(chunks)
    finally:
        if own:
            handle.close()


def fasta_write(handle_or_path, name: str, seq: str, mode: str = "a") -> None:
    handle, own = _as_handle(handle_or_path, mode)
    try:
        assert "\n" not in name
        handle.write(">%s\n" % name)
        # 100-column wrapping like the reference bioio writer.
        for i in range(0, len(seq), 100):
            handle.write(seq[i : i + 100] + "\n")
    finally:
        if own:
            handle.close()


def write_fasta_file(path: str, records: Iterable[Tuple[str, str]]) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fasta_write(fh, name, seq)


def get_fasta_dictionary(path: str) -> Dict[str, str]:
    """First word of each header -> sequence; asserts name uniqueness
    (reference: src/margin/utils.py:68-75)."""
    out: Dict[str, str] = {}
    for name, seq in fasta_read(path):
        key = name.split()[0]
        assert key not in out, "Duplicate fasta sequence name: %s" % key
        out[key] = seq
    return out


def make_fasta_names_unique(input_path: str, output_path: str) -> str:
    """Append 'i' to duplicated first-word names
    (reference: makeFastaSequenceNamesUnique, src/margin/utils.py:77-89)."""
    names = set()
    with open(output_path, "w") as fh:
        for name, seq in fasta_read(input_path):
            while name in names:
                name += "i"
            names.add(name)
            fasta_write(fh, name, seq)
    return output_path


def _as_handle(path_or_handle, mode: str) -> Tuple[TextIO, bool]:
    if isinstance(path_or_handle, (str, os.PathLike)):
        return open(path_or_handle, mode), True
    return path_or_handle, False
