"""VCF writing/reading with the reference's exact byte layout.

The reference hand-writes VCFv4.2 (vcfWrite, src/margin/marginCallerLib.py:113-169)
and reads it back with PyVCF (vcfRead, :106-111).  Both directions are
self-contained here.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Set, Tuple


def vcf_write(
    reference_fasta_file: str,
    ref_sequences: Dict[str, str],
    variant_calls: Sequence[Tuple[str, int, str, float]],
    output_vcf_file: str,
) -> None:
    """variant_calls: (refSeqName, refPosition [0-based], altBase, posterior).

    Emits one line per called reference position with comma-joined ALT bases
    and their posteriors in INFO, matching the reference writer.
    """
    calls_hash: Dict[str, Dict[int, List[Tuple[str, float]]]] = {
        name: {} for name in ref_sequences
    }
    for ref_name, ref_pos, base, prob in variant_calls:
        calls_hash[ref_name].setdefault(ref_pos, []).append((base, prob))

    with open(output_vcf_file, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(
            "##fileDate="
            + str(datetime.datetime.now().date()).replace("-", "")
            + "\n"
        )
        fh.write("##source=marginCaller\n")
        fh.write("##reference=" + reference_fasta_file + "\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for ref_name in ref_sequences:
            per_pos = calls_hash[ref_name]
            for ref_pos, ref_base in enumerate(ref_sequences[ref_name]):
                if ref_pos not in per_pos:
                    continue
                alts = ",".join(b for b, _ in per_pos[ref_pos])
                info = ",".join(str(p) for _, p in per_pos[ref_pos])
                fh.write(
                    "%s\t%d\t.\t%s\t%s\t.\tPASS\t%s\n"
                    % (ref_name, ref_pos + 1, ref_base, alts, info)
                )


def vcf_read(vcf_file: str) -> Set[Tuple[str, int, str]]:
    """Return {(chrom, 1-based pos, ALT base)}, like the reference vcfRead."""
    calls: Set[Tuple[str, int, str]] = set()
    with open(vcf_file) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, _, _, alt = fields[:5]
            if alt == ".":
                continue
            for a in alt.split(","):
                calls.add((chrom, int(pos), a.upper()))
    return calls
