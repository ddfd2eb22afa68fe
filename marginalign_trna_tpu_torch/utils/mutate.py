"""Reference mutation simulation (test-data generation).

Port of the reference's mutateSequence/mutateSequences
(src/margin/utils.py:388-412): SNP-mutate a fraction of sites, preserving
case, returning the mutation list as (name, pos, originalBase, altBase).
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

BASES = ("A", "C", "G", "T")


def mutate_sequence(
    sequence: str, snp_rate: float, rng: random.Random
) -> Tuple[str, List[Tuple[int, str, str]]]:
    mutations = []
    out = list(sequence)
    for i, base in enumerate(sequence):
        if rng.random() < snp_rate:
            alt = rng.choice(sorted(set(BASES) - {base.upper()}))
            alt = alt if base.upper() == base else alt.lower()
            mutations.append((i, base, alt))
            out[i] = alt
    return "".join(out), mutations


def mutate_sequences(
    sequences: Dict[str, str], snp_rate: float, seed: int = 0
) -> Tuple[Dict[str, str], List[Tuple[str, int, str, str]]]:
    rng = random.Random(seed)
    mutated = {}
    all_mutations: List[Tuple[str, int, str, str]] = []
    for name, seq in sequences.items():
        mseq, muts = mutate_sequence(seq, snp_rate, rng)
        mutated[name] = mseq
        all_mutations.extend((name, pos, ref, alt) for pos, ref, alt in muts)
    return mutated, all_mutations
