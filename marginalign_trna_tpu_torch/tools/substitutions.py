"""Observed substitution-count matrices from a SAM file.

Behavioural port of scripts/substitutions.py (SubstitutionMatrix, :9-56):
a 5x5 (ACGTN) count matrix over aligned pairs, with XML and TSV outputs and
an optional matplotlib level plot standing in for the reference's R lattice
plot (scripts/substitution_plot.R).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from ..io.fasta import get_fasta_dictionary
from ..io.fastq import get_fastq_dictionary
from ..io.sam import SamFile
from ..stats.stats import aligned_pair_iterator

ORDER = "ACGTN"


class SubstitutionMatrix:
    """5x5 nucleotide substitution counts (ref x read), N = wildcard."""

    def __init__(self):
        self.matrix = np.zeros((5, 5), dtype=np.float64)

    @staticmethod
    def _index(base: str) -> int:
        base = base.upper()
        return ORDER.find(base) if base in "ACGT" else 4

    def add_aligned_pair(self, ref_base: str, read_base: str) -> None:
        self.matrix[self._index(ref_base), self._index(read_base)] += 1

    def get_count(self, ref_base: str, read_base: str) -> float:
        return float(self.matrix[self._index(ref_base), self._index(read_base)])

    def get_freqs(self, ref_base: str, bases: str = ORDER) -> np.ndarray:
        row = np.array([self.get_count(ref_base, b) for b in bases])
        total = row.sum()
        return row / total if total else row

    def identity(self) -> float:
        matches = sum(self.get_count(b, b) for b in "ACGT")
        mismatches = sum(
            self.get_count(r, q) for r in "ACGT" for q in "ACGT" if r != q
        )
        return matches / (matches + mismatches) if matches + mismatches else float("nan")

    def to_xml(self) -> ET.Element:
        def identity(m, mm):
            return str(m / (m + mm)) if m + mm else "NaN"

        matches = sum(self.get_count(b, b) for b in "ACGT")
        mismatches = sum(
            self.get_count(r, q) for r in "ACGT" for q in "ACGT" if r != q
        )
        node = ET.Element(
            "substitutions",
            {
                "matches": str(matches),
                "mismatches": str(mismatches),
                "identity": identity(matches, mismatches),
            },
        )
        for ref_base in ORDER:
            m = self.get_count(ref_base, ref_base)
            mm = sum(
                self.get_count(ref_base, q) for q in "ACGT" if q != ref_base
            )
            base_node = ET.SubElement(
                node, ref_base,
                {"matches": str(m), "mismatches": str(mm),
                 "identity": identity(m, mm)},
            )
            for read_base in ORDER:
                ET.SubElement(
                    base_node, read_base,
                    {"count": str(self.get_count(ref_base, read_base))},
                )
        return node

    def write_tsv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("ref\\read\t" + "\t".join(ORDER) + "\n")
            for i, r in enumerate(ORDER):
                fh.write(r + "\t" + "\t".join(
                    str(self.matrix[i, j]) for j in range(5)) + "\n")


def substitution_matrix_from_sam(
    sam_path: str, read_fastq_path: str, reference_fasta_path: str
) -> SubstitutionMatrix:
    refs = get_fasta_dictionary(reference_fasta_path)
    reads = get_fastq_dictionary(read_fastq_path)
    sam = SamFile.read(sam_path)
    matrix = SubstitutionMatrix()
    for rec in sam.mapped():
        for ap in aligned_pair_iterator(rec, refs[rec.rname], reads[rec.qname]):
            matrix.add_aligned_pair(ap.ref_base, ap.read_base)
    return matrix


def plot_substitution_matrix(matrix: SubstitutionMatrix, path: str) -> bool:
    """Level plot of per-ref-base read frequencies; returns False if
    matplotlib is unavailable (plots are optional, like the reference's R)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    freqs = np.stack([matrix.get_freqs(r) for r in ORDER])
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(freqs, cmap="viridis", vmin=0, vmax=1)
    ax.set_xticks(range(5), list(ORDER))
    ax.set_yticks(range(5), list(ORDER))
    ax.set_xlabel("read base")
    ax.set_ylabel("reference base")
    fig.colorbar(im, ax=ax, label="frequency")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
