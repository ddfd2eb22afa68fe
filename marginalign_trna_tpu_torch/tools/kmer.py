"""K-mer frequency comparison between a reference and a read set.

Behavioural port of scripts/kmerAnalysis.py: count k-mers (default 5) in the
reference FASTA and read FASTQ, write a per-kmer table with fractions and
log fold change.
"""
from __future__ import annotations

import itertools
from collections import Counter
from math import log
from typing import Counter as CounterT, Tuple

from ..io.fasta import fasta_read
from ..io.fastq import fastq_read


def count_kmers(
    kmer_size: int, reference_fasta_path: str, read_fastq_path: str
) -> Tuple[CounterT, CounterT]:
    ref_kmers: CounterT = Counter()
    read_kmers: CounterT = Counter()
    for _, seq in fasta_read(reference_fasta_path):
        for i in range(kmer_size, len(seq) + 1):
            s = seq[i - kmer_size : i]
            if "N" not in s.upper():
                ref_kmers[s.upper()] += 1
    for _, seq, _ in fastq_read(read_fastq_path):
        for i in range(kmer_size, len(seq) + 1):
            s = seq[i - kmer_size : i]
            if "N" not in s.upper():
                read_kmers[s.upper()] += 1
    return ref_kmers, read_kmers


def write_kmer_table(
    ref_kmers: CounterT,
    read_kmers: CounterT,
    output_path: str,
    kmer_size: int = 5,
) -> None:
    ref_size = sum(ref_kmers.values()) or 1
    read_size = sum(read_kmers.values()) or 1
    with open(output_path, "w") as fh:
        fh.write(
            "kmer\trefCount\trefFraction\treadCount\treadFraction\t"
            "logFoldChange\n"
        )
        for tup in itertools.product("ATGC", repeat=kmer_size):
            kmer = "".join(tup)
            ref_frac = ref_kmers[kmer] / ref_size
            read_frac = read_kmers[kmer] / read_size
            if ref_frac == 0:
                fold = "-Inf"
            elif read_frac == 0:
                fold = "Inf"
            else:
                fold = -log(read_frac / ref_frac)
            fh.write("\t".join(map(str, [
                kmer, ref_kmers[kmer], ref_frac, read_kmers[kmer],
                read_frac, fold,
            ])) + "\n")
