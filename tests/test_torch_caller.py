"""marginCaller: the PyTorch port on the CPU (plain versions of its
kernels) vs the JAX package on its compact + fused path (Pallas in
interpret mode), on a synthetic two-reference SAM with planted SNVs."""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.call import caller as jcaller
from marginalign_trna_tpu.io.fasta import get_fasta_dictionary as jfasta
from marginalign_trna_tpu.io.sam import SamFile as JSamFile
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu_torch import cli
from marginalign_trna_tpu_torch.call import caller as tcaller
from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
from marginalign_trna_tpu_torch.io.sam import SamFile
from marginalign_trna_tpu_torch.io.vcf import vcf_read
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

BASES = np.array(list("ACGT"))


def _write_corpus(tmp, seed=4):
    """Two references (260 and 220 bases) with an SNV every 23 bases; five
    reads per reference copied from the unmutated sequence with 2%
    substitutions, a 3-base deletion, a 2-base insertion and soft clips,
    aligned (cigar) against the mutated one.  Returns (sam, fasta,
    planted {(name, 1-based pos, true base)})."""
    rng = np.random.default_rng(seed)
    header = ["@HD\tVN:1.3\tSO:unsorted"]
    fasta, records, planted = [], [], set()
    for name, length in (("chrA", 260), ("chrB", 220)):
        orig = rng.integers(0, 4, size=length)
        mutated = orig.copy()
        for p in range(15, length - 15, 23):
            mutated[p] = (orig[p] + int(rng.integers(1, 4))) % 4
            planted.add((name, p + 1, BASES[orig[p]]))
        fasta.append(">%s\n%s\n" % (name, "".join(BASES[mutated])))
        header.append("@SQ\tSN:%s\tLN:%d" % (name, length))
        for r in range(5):
            start = int(rng.integers(0, 25))
            span = int(rng.integers(length - 60, length - start))
            window = orig[start:start + span].copy()
            noise = rng.random(span) < 0.02
            window[noise] = rng.integers(0, 4, size=int(noise.sum()))
            a, b = span // 3, span // 3 + 3
            c = 2 * span // 3
            read = np.concatenate([
                rng.integers(0, 4, 4), window[:a], window[b:c],
                rng.integers(0, 4, 2), window[c:], rng.integers(0, 4, 3)])
            cigar = "4S%dM3D%dM2I%dM3S" % (a, c - b, span - c)
            seq = "".join(BASES[read])
            records.append("%s_%d\t0\t%s\t%d\t60\t%s\t*\t0\t0\t%s\t%s" % (
                name, r, name, start + 1, cigar, seq, "I" * len(seq)))
    sam, fa = tmp / "in.sam", tmp / "ref.fa"
    sam.write_text("\n".join(header + records) + "\n")
    fa.write_text("".join(fasta))
    return str(sam), str(fa), planted


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("caller"))


@pytest.fixture
def pallas(monkeypatch):
    """The JAX package's accelerator default on the CPU: Pallas kernels in
    interpret mode, compact streams and fused expectations."""
    monkeypatch.setenv("MARGINALIGN_KERNEL", "pallas")


@pytest.mark.parametrize("split_size", [0, 100])
def test_accumulate_expectations_match_jax(corpus, pallas, split_size):
    sam_path, fa, _ = corpus
    opts = dict(split_size=split_size)
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam_path), jfasta(fa),
        JPairHmm.load(DEFAULT_MODEL), jcaller.CallerOptions(**opts))
    got = tcaller.accumulate_expectations(
        SamFile.read(sam_path), get_fasta_dictionary(fa),
        PairHmm.load(DEFAULT_MODEL), tcaller.CallerOptions(**opts),
        device="cpu")
    assert list(got) == list(want)
    err = max(np.abs(got[k] - want[k]).max() for k in got)
    print("max abs difference of the expectations: %g" % err)
    assert err <= 2e-3
    for k in got:
        assert got[k].sum() > 0.9 * (got[k].shape[0] * 5 - 300)


def test_no_margin_expectations_exact(corpus):
    sam_path, fa, _ = corpus
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam_path), jfasta(fa), None,
        jcaller.CallerOptions(no_margin=True))
    got = tcaller.accumulate_expectations(
        SamFile.read(sam_path), get_fasta_dictionary(fa), None,
        tcaller.CallerOptions(no_margin=True), device="cpu")
    assert list(got) == list(want)
    for k in got:
        assert np.array_equal(got[k], want[k])


def test_margin_caller_calls_match_jax(corpus, pallas, tmp_path):
    sam_path, fa, planted = corpus
    jhmm = JPairHmm.load(DEFAULT_MODEL)
    want = jcaller.margin_caller(sam_path, fa, str(tmp_path / "jax.vcf"),
                                 jhmm, jhmm)
    hmm = PairHmm.load(DEFAULT_MODEL)
    out = str(tmp_path / "port.vcf")
    got = tcaller.margin_caller(sam_path, fa, out, hmm, hmm, device="cpu")
    assert {c[:3] for c in got} == {c[:3] for c in want}
    assert np.allclose([c[3] for c in got], [c[3] for c in want],
                       atol=1e-3)
    found = vcf_read(out)
    assert len(found & planted) >= 0.9 * len(planted)
    assert len(found & planted) >= 0.9 * len(found)


def test_substitution_matrix_matches_jax():
    got = PairHmm.load(DEFAULT_MODEL).substitution_matrix()
    want = JPairHmm.load(DEFAULT_MODEL).substitution_matrix()
    assert np.array_equal(got, want)


def test_caller_cli_cpu(corpus, tmp_path):
    sam_path, fa, planted = corpus
    out = tmp_path / "cli.vcf"
    assert cli.main(["marginCaller", sam_path, fa, str(out), "--device",
                     "cpu", "--threshold", "0.3",
                     "--splitMatrixBiggerThanThis", "100",
                     "--maxThreads", "4"]) == 0
    found = vcf_read(str(out))
    assert len(found & planted) >= 0.9 * len(planted)
    nm = tmp_path / "nomargin.vcf"
    assert cli.main(["marginCaller", sam_path, fa, str(nm), "--noMargin",
                     "--device", "cpu"]) == 0
    assert vcf_read(str(nm))


def test_caller_cli_refuses_without_cuda(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sam_path, fa, _ = corpus
    out = tmp_path / "o.vcf"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["marginCaller", sam_path, fa, str(out)])
    assert not out.exists()


def test_non_flat_gap_model_raises_naming_b15(corpus):
    """Named for the refusal it once checked; a model whose gap rows are
    not flat now runs: its buckets are packed as band arrays, run through
    the generic forward-backward pair (rows 8-9) and summed per position
    from the posterior band, as the JAX package routes such a model.  Here
    the JAX side takes its XLA engine (the CPU default); tests/
    test_torch_generic_paths.py holds the same path against its Pallas
    route.  Expectations within 2e-3, identical call sets."""
    sam_path, fa, _ = corpus
    hmm = PairHmm.load(DEFAULT_MODEL)
    hmm.emissions[1] = np.random.default_rng(0).random(
        hmm.emissions[1].shape)
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam_path), jfasta(fa),
        JPairHmm(hmm.transitions, hmm.emissions), jcaller.CallerOptions())
    refs = get_fasta_dictionary(fa)
    got = tcaller.accumulate_expectations(
        SamFile.read(sam_path), refs, hmm, tcaller.CallerOptions(),
        device="cpu")
    assert list(got) == list(want)
    err = max(np.abs(got[k] - want[k]).max() for k in got)
    print("non-flat model: max abs difference of the expectations: %g" % err)
    assert err <= 2e-3
    assert all(got[k].sum() > 0 for k in got)
    error = PairHmm.load(DEFAULT_MODEL)
    calls = [{c[:3] for c in caller.call_variants(exp, refs, error, 0.3)}
             for caller, exp in ((tcaller, got), (jcaller, want))]
    assert calls[0] == calls[1]
