"""CLI entry points for the auxiliary tools (reference: scripts/)."""
from __future__ import annotations

import argparse
import os
import sys
import xml.dom.minidom
import xml.etree.ElementTree as ET


def uniquify_fastq_main(argv=None) -> int:
    """scripts/uniquifyFastq equivalent."""
    from ..io.fastq import make_fastq_names_unique

    p = argparse.ArgumentParser(
        prog="uniquifyFastq",
        description="Rename duplicated FASTQ read names by appending 'i'.",
    )
    p.add_argument("inputFastqFile")
    p.add_argument("outputFastqFile")
    args = p.parse_args(argv)
    make_fastq_names_unique(args.inputFastqFile, args.outputFastqFile)
    return 0


def mutate_reference_main(argv=None) -> int:
    """scripts/mutateReference equivalent: SNP-mutate a reference fasta and
    write the mutation list (name pos originalBase altBase)."""
    from ..io.fasta import get_fasta_dictionary, write_fasta_file
    from ..utils.mutate import mutate_sequences

    p = argparse.ArgumentParser(prog="mutateReference")
    p.add_argument("inputFastaFile")
    p.add_argument("outputFastaFile")
    p.add_argument("outputMutationsFile")
    p.add_argument("--snpRate", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    sequences = get_fasta_dictionary(args.inputFastaFile)
    mutated, mutations = mutate_sequences(sequences, args.snpRate, args.seed)
    write_fasta_file(args.outputFastaFile, mutated.items())
    with open(args.outputMutationsFile, "w") as fh:
        for name, pos, ref, alt in mutations:
            fh.write("%s\t%d\t%s\t%s\n" % (name, pos, ref, alt))
    return 0


def substitutions_main(argv=None) -> int:
    """scripts/substitutions equivalent: substitution matrix XML/TSV/plot."""
    from .substitutions import (
        plot_substitution_matrix, substitution_matrix_from_sam,
    )

    p = argparse.ArgumentParser(prog="substitutions")
    p.add_argument("samFile")
    p.add_argument("readFastqFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputDir")
    args = p.parse_args(argv)
    os.makedirs(args.outputDir, exist_ok=True)

    matrix = substitution_matrix_from_sam(
        args.samFile, args.readFastqFile, args.referenceFastaFile
    )
    xml_str = xml.dom.minidom.parseString(
        ET.tostring(matrix.to_xml())
    ).toprettyxml()
    with open(os.path.join(args.outputDir, "substitutions.xml"), "w") as fh:
        fh.write(xml_str)
    matrix.write_tsv(os.path.join(args.outputDir, "substitutions.tsv"))
    if plot_substitution_matrix(
        matrix, os.path.join(args.outputDir, "substitutions.png")
    ):
        print("wrote substitutions.png", file=sys.stderr)
    print("identity: %s" % matrix.identity())
    return 0


def kmer_analysis_main(argv=None) -> int:
    """scripts/kmerAnalysis.py equivalent."""
    from .kmer import count_kmers, write_kmer_table

    p = argparse.ArgumentParser(prog="kmerAnalysis")
    p.add_argument("referenceFastaFile")
    p.add_argument("readFastqFile")
    p.add_argument("outputPrefix")
    p.add_argument("--kmerSize", type=int, default=5)
    args = p.parse_args(argv)

    ref_kmers, read_kmers = count_kmers(
        args.kmerSize, args.referenceFastaFile, args.readFastqFile
    )
    if ref_kmers and read_kmers:
        write_kmer_table(
            ref_kmers, read_kmers,
            args.outputPrefix + "_all_bases_kmer_counts.txt",
            args.kmerSize,
        )
    return 0


def create_assembly_hub_main(argv=None) -> int:
    """scripts/createAssemblyHub equivalent (self-contained BAM/2bit)."""
    from .assembly_hub import create_assembly_hub

    p = argparse.ArgumentParser(prog="createAssemblyHub")
    p.add_argument("samFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputDir")
    p.add_argument("--hubTag", default="hub")
    p.add_argument("--email", default="nobody@example.org")
    args = p.parse_args(argv)
    path = create_assembly_hub(
        args.samFile, args.referenceFastaFile, args.outputDir, args.hubTag,
        args.email,
    )
    print(path)
    return 0
