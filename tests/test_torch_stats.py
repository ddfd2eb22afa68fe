"""The port's marginStats and modifyHmm commands (stats/stats.py and
models/hmm.py, host copies of the JAX package's) against the JAX package's
commands, on a synthetic SAM made from a numpy seed and on the in-repo
models: the same report and the same model file, byte for byte."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu import cli as jcli
from marginalign_trna_tpu_torch import cli

BASES = np.array(list("ACGT"))
MODELS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "marginalign_trna_tpu_torch", "models")


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _write_corpus(tmp, seed=6):
    """Two references; per reference four reads copied from it with 5%
    substitutions, a 4-base deletion, a 3-base insertion and soft clips,
    every other one on the reverse strand (the FASTQ holds the read as
    sequenced, the SAM its reference-strand sequence).  Returns (sam,
    fastq, fasta)."""
    rng = np.random.default_rng(seed)
    header = ["@HD\tVN:1.3\tSO:unsorted"]
    fasta, records, fastq = [], [], []
    for name, length in (("chrA", 300), ("chrB", 240)):
        ref = rng.integers(0, 4, size=length)
        fasta.append(">%s\n%s\n" % (name, "".join(BASES[ref])))
        header.append("@SQ\tSN:%s\tLN:%d" % (name, length))
        for r in range(4):
            start = int(rng.integers(0, 30))
            span = int(rng.integers(length - 90, length - start))
            window = ref[start:start + span].copy()
            noise = rng.random(span) < 0.05
            window[noise] = rng.integers(0, 4, size=int(noise.sum()))
            a, b, c = span // 3, span // 3 + 4, 2 * span // 3
            clip5, clip3 = int(rng.integers(0, 6)), int(rng.integers(0, 6))
            read = np.concatenate([
                rng.integers(0, 4, clip5), window[:a], window[b:c],
                rng.integers(0, 4, 3), window[c:], rng.integers(0, 4, clip3)])
            cigar = "%dM4D%dM3I%dM" % (a, c - b, span - c)
            cigar = ("%dS" % clip5 if clip5 else "") + cigar + (
                "%dS" % clip3 if clip3 else "")
            seq = "".join(BASES[read])
            flag = 16 * (r % 2)
            qname = "%s_%d" % (name, r)
            records.append("%s\t%d\t%s\t%d\t60\t%s\t*\t0\t0\t%s\t%s" % (
                qname, flag, name, start + 1, cigar, seq, "I" * len(seq)))
            raw = _revcomp(seq) if flag else seq
            fastq.append("@%s\n%s\n+\n%s\n" % (qname, raw, "I" * len(raw)))
    sam, fq, fa = tmp / "in.sam", tmp / "reads.fq", tmp / "ref.fa"
    sam.write_text("\n".join(header + records) + "\n")
    fq.write_text("".join(fastq))
    fa.write_text("".join(fasta))
    return str(sam), str(fq), str(fa)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("stats"))


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX package's commands would open a compilation cache under
    HOME; these runs compile nothing."""
    monkeypatch.setenv("MARGINALIGN_COMPILE_CACHE", "0")


ALL_STATS = ["--readIdentity", "--alignmentIdentity", "--readCoverage",
             "--mismatchesPerAlignedBase", "--deletionsPerReadBase",
             "--insertionsPerReadBase", "--readLength"]


@pytest.mark.parametrize("flags", [
    ALL_STATS,
    ALL_STATS + ["--localAlignment"],
    ["--readIdentity", "--printValuePerReadAlignment"],
    ["--alignmentIdentity", "--printValuePerReadAlignment", "--noStats",
     "--localAlignment"],
])
def test_margin_stats_matches_jax(corpus, capsys, no_jax_cache, flags):
    sam, fq, fa = corpus
    assert cli.main(["marginStats", sam, fq, fa] + flags) == 0
    got = capsys.readouterr().out
    assert jcli.margin_stats_main([sam, fq, fa] + flags) == 0
    want = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) >= (1 if "--noStats" in flags else 4)


@pytest.mark.parametrize("model", ["last_hmm_0.txt", "last_hmm_20.txt",
                                   "last_hmm_40.txt"])
@pytest.mark.parametrize("flags", [
    ["--setFlatIndelEmissions"],
    ["--gcContent", "0.4"],
    ["--substitutionRate", "0.1"],
    ["--setFlatIndelEmissions", "--gcContent", "0.35",
     "--substitutionRate", "0.05"],
])
def test_modify_hmm_matches_jax(tmp_path, model, flags):
    src = os.path.join(MODELS, model)
    got, want = str(tmp_path / "port.hmm"), str(tmp_path / "jax.hmm")
    assert cli.main(["modifyHmm", src, got] + flags) == 0
    assert jcli.modify_hmm_main([src, want] + flags) == 0
    with open(got) as a, open(want) as b, open(src) as c:
        text = a.read()
        assert text == b.read()
        assert text != c.read()
