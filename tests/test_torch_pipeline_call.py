"""pipeline.call and pipeline.align_and_call of the port on the CPU (plain
versions of its kernels) against the JAX package's, on a synthetic
two-reference corpus made from a numpy seed: reads simulated from the
original references, aligned and called against copies with an SNV every
37 bases.  With EM the trained model is the caller's two models in both
packages (the reference's EM -> call flow)."""
import numpy as np
import pytest

from marginalign_trna_tpu import pipeline as jpipeline
from marginalign_trna_tpu.align.em import EmOptions as JEmOptions
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu_torch import pipeline as tpipeline
from marginalign_trna_tpu_torch.align.em import EmOptions
from marginalign_trna_tpu_torch.io.sam import SamFile
from marginalign_trna_tpu_torch.models.hmm import PairHmm

BASES = np.array(list("ACGT"))


def _write_corpus(tmp, n_reads=12, seed=9):
    """Two references of 520 and 460 bases; reads of 300-420 bases from the
    unmutated sequences with 4% substitutions and 2% indels, every third
    one reverse-complemented; the FASTA holds the mutated copies.
    Returns (fastq, fasta, planted {(name, 1-based pos)})."""
    rng = np.random.default_rng(seed)
    fasta, lines, planted, origs = [], [], set(), []
    for name, length in (("chrA", 520), ("chrB", 460)):
        orig = rng.integers(0, 4, size=length)
        mutated = orig.copy()
        for p in range(20, length - 20, 37):
            mutated[p] = (orig[p] + int(rng.integers(1, 4))) % 4
            planted.add((name, p + 1))
        fasta.append(">%s\n%s\n" % (name, "".join(BASES[mutated])))
        origs.append(orig)
    for idx in range(n_reads):
        ref = origs[idx % 2]
        length = int(rng.integers(300, 420))
        start = int(rng.integers(0, len(ref) - length))
        read = ref[start:start + length].copy()
        subs = rng.random(len(read)) < 0.04
        read[subs] = rng.integers(0, 4, size=int(subs.sum()))
        read = read[rng.random(len(read)) >= 0.01]
        ins = np.flatnonzero(rng.random(len(read)) < 0.01)
        read = np.insert(read, ins + 1, rng.integers(0, 4, size=len(ins)))
        if idx % 3 == 1:
            read = (3 - read)[::-1]
        seq = "".join(BASES[read])
        lines.append("@r%d\n%s\n+\n%s\n" % (idx, seq, "I" * len(seq)))
    fq, fa = tmp / "reads.fq", tmp / "ref.fa"
    fq.write_text("".join(lines))
    fa.write_text("".join(fasta))
    return str(fq), str(fa), planted


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tmp_path_factory.mktemp("pipeline_call"), *_write_corpus(
        tmp_path_factory.mktemp("corpus"))


def _same_calls(got, want, planted):
    """Identical call sets (reference, position, base), probabilities
    within 1e-3 (the caller's float32 expectations differ from the JAX
    package's by a few 1e-5); most planted SNVs called."""
    assert [c[:3] for c in got] == [c[:3] for c in want]
    assert np.allclose([c[3] for c in got], [c[3] for c in want],
                       atol=1e-3)
    hit = {(c[0], c[1] + 1) for c in got} & planted
    assert len(hit) >= 0.6 * len(planted), (len(hit), len(planted))


def test_call_matches_jax(corpus):
    """pipeline.call with the shipped default models, on the JAX
    package's realigned SAM."""
    tmp, fq, fa, planted = corpus
    sam = str(tmp / "jax_aligned.sam")
    jpipeline.align(fq, fa, sam)
    want = jpipeline.call(sam, fa, str(tmp / "jax.vcf"))
    got = tpipeline.call(sam, fa, str(tmp / "port.vcf"), device="cpu")
    _same_calls(got, want, planted)
    with open(tmp / "port.vcf") as a, open(tmp / "jax.vcf") as b:
        # The last column is the call's probability (compared above).
        assert ([ln.rsplit("\t", 1)[0] for ln in a.read().splitlines()]
                == [ln.rsplit("\t", 1)[0] for ln in b.read().splitlines()])


def test_align_and_call_matches_jax(corpus):
    """FASTQ -> SAM -> VCF with the shipped default models: the records
    placed as the JAX package places them and the same calls."""
    tmp, fq, fa, planted = corpus
    want = jpipeline.align_and_call(fq, fa, str(tmp / "jax_ac.sam"),
                                    str(tmp / "jax_ac.vcf"))
    got = tpipeline.align_and_call(fq, fa, str(tmp / "port_ac.sam"),
                                   str(tmp / "port_ac.vcf"), device="cpu")
    recs = SamFile.read(str(tmp / "port_ac.sam")).records
    jrecs = SamFile.read(str(tmp / "jax_ac.sam")).records
    assert [(r.qname, r.flag, r.rname, r.pos) for r in recs] == \
        [(r.qname, r.flag, r.rname, r.pos) for r in jrecs]
    assert len(recs) >= 10
    _same_calls(got, want, planted)


def test_align_and_call_em_matches_jax(corpus):
    """With EM (2 lockstep trials, 2 iterations, trial 0 from the shipped
    model) both packages train the same model (parameters within 1e-3),
    call with it as both models, and make the same calls; the port's align
    still returns its stage seconds."""
    tmp, fq, fa, planted = corpus
    opts = dict(trials=2, iterations=2, use_default_model_as_start=True)
    jmodel, tmodel = str(tmp / "jax_em.hmm"), str(tmp / "port_em.hmm")
    want = jpipeline.align_and_call(
        fq, fa, str(tmp / "jax_em.sam"), str(tmp / "jax_em.vcf"),
        jpipeline.AlignOptions(em=True, em_options=JEmOptions(**opts),
                               output_model_path=jmodel))
    got = tpipeline.align_and_call(
        fq, fa, str(tmp / "port_em.sam"), str(tmp / "port_em.vcf"),
        tpipeline.AlignOptions(em=True, em_options=EmOptions(**opts),
                               output_model_path=tmodel), device="cpu")
    a, b = PairHmm.load(tmodel), JPairHmm.load(jmodel)
    assert np.allclose(a.transitions, b.transitions, atol=1e-3)
    assert np.allclose(a.emissions, b.emissions, atol=1e-3)
    assert not np.allclose(a.transitions, PairHmm.load(
        tpipeline.DEFAULT_MODEL).transitions, atol=1e-6)
    _same_calls(got, want, planted)
    stages = tpipeline.align(
        fq, fa, str(tmp / "port_em2.sam"),
        tpipeline.AlignOptions(em=True, em_options=EmOptions(**opts)),
        device="cpu")
    assert set(stages) == {"guide_s", "chain_s", "em_s", "realign_s"}
