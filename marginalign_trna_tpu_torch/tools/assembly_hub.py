"""UCSC assembly hub builder.

Behavioural equivalent of scripts/createAssemblyHub.py: sorted+indexed BAM,
2bit reference, and hub.txt/genomes.txt/trackDb.txt.  Fully self-contained:
BAM/BAI via io/bam.py, 2bit via io/twobit.py (the reference needed pysam and
a missing faToTwoBit binary).
"""
from __future__ import annotations

import os
import shutil

from ..io.bam import sam_to_bam_file
from ..io.fasta import fasta_read
from ..io.twobit import write_2bit


def create_assembly_hub(
    sam_path: str,
    reference_fasta_path: str,
    output_dir: str,
    hub_tag: str = "hub",
    email: str = "nobody@example.org",
) -> str:
    """Build the hub directory; returns its path."""
    parent = os.path.join(output_dir, hub_tag)
    header = os.path.basename(reference_fasta_path).rsplit(".fa", 1)[0]
    ref_dir = os.path.join(parent, header)
    bam_dir = os.path.join(ref_dir, "bamFiles")
    os.makedirs(bam_dir, exist_ok=True)

    # Sorted, indexed BAM.
    base = os.path.basename(sam_path).rsplit(".sam", 1)[0]
    sorted_bam = os.path.join(bam_dir, base + ".sorted.bam")
    sam_to_bam_file(sam_path, sorted_bam, sort=True, index=True)

    # Reference copy + 2bit.
    shutil.copy(reference_fasta_path, ref_dir)
    sequences = {
        name.split()[0]: seq for name, seq in fasta_read(reference_fasta_path)
    }
    two_bit = os.path.join(ref_dir, header + ".2bit")
    write_2bit(sequences, two_bit)

    with open(os.path.join(parent, "genomes.txt"), "w") as fh:
        for name, seq in sequences.items():
            fh.write("genome %s\n" % name)
            fh.write("trackDb %s/trackDb.txt\n" % header)
            fh.write("groups groups.txt\n")
            fh.write("description %s %s\n" % (header, name))
            fh.write("twoBitPath %s/%s.2bit\n" % (header, header))
            fh.write("organism %s\n" % name)
            fh.write("defaultPos %s:1-%d\n" % (name, len(seq)))
            fh.write("\n")

    with open(os.path.join(parent, "hub.txt"), "w") as fh:
        fh.write("hub %s\n" % hub_tag)
        fh.write("shortLabel %s\n" % hub_tag)
        fh.write("longLabel %s\n" % hub_tag)
        fh.write("genomesFile genomes.txt\n")
        fh.write("email %s\n" % email)

    with open(os.path.join(parent, "groups.txt"), "w") as fh:
        fh.write("name map\nlabel Mapping\npriority 2\ndefaultIsClosed 0\n")

    with open(os.path.join(ref_dir, "trackDb.txt"), "w") as fh:
        fh.write("track %s\n" % base)
        fh.write("longLabel %s\n" % base)
        fh.write("shortLabel %s\n" % base)
        fh.write("priority 1\n")
        fh.write("visibility pack\n")
        fh.write("colorByStrand 150,100,30 230,170,40\n")
        fh.write("color 150,100,30\n")
        fh.write("altColor 230,170,40\n")
        fh.write("bigDataUrl bamFiles/%s\n" % os.path.basename(sorted_bam))
        fh.write("type bam\n")
        fh.write("group map\n")
    return parent
