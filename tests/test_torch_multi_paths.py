"""Multi-problem lanes through the port's entry points (multi=True) on the
CPU, through the plain versions of nw_multi, fb_multi_forward,
fb_multi_backward and mea_multi, against the JAX package with
MARGINALIGN_MULTI=on (its Pallas multi kernels in interpret mode) on a
synthetic direct-tRNA corpus: the guide (`map_reads`), the realignment
(`realign_sam_file`) and marginCaller (`accumulate_expectations` /
`margin_caller`); and the routing policy: the guide always takes multi
lanes, realignment and the caller only for flat-gap models whose jobs all
fit MULTI_MAX_PROBLEM_STEPS.  marginAlign --em over multi lanes is tested in
tests/test_torch_em_multi_paths.py."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.align import guide as jguide
from marginalign_trna_tpu.align import realign as jrealign
from marginalign_trna_tpu.call import caller as jcaller
from marginalign_trna_tpu.io.fasta import get_fasta_dictionary as jfasta
from marginalign_trna_tpu.io.sam import SamFile as JSamFile
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu_torch.align import guide as tguide
from marginalign_trna_tpu_torch.align import realign as trealign
from marginalign_trna_tpu_torch.call import caller as tcaller
from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
from marginalign_trna_tpu_torch.io.sam import SamFile
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops.band import path_from_cigar
from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

BASES = np.array(list("ACGT"))
JAX_MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "marginalign_trna_tpu", "models", "last_hmm_20.txt")


def _trna_read(rng, ref):
    """A read of 60-150 nt from a 70-90 nt reference in the shape of
    benchmarks/trna.py: a fragment of the reference when shorter than it,
    else the whole reference with the surplus inserted at one place; ~12%
    substitutions and a few 1-2 base indels."""
    length = int(rng.integers(60, 151))
    if length <= len(ref):
        start = int(rng.integers(0, len(ref) - length + 1))
        y = ref[start:start + length].copy()
    else:
        start = 0
        pos = int(rng.integers(0, len(ref)))
        y = np.concatenate([ref[:pos],
                            rng.integers(0, 4, length - len(ref)),
                            ref[pos:]])
    subs = rng.random(len(y)) < 0.12
    y[subs] = (y[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    for _ in range(int(rng.integers(0, 3))):
        at = int(rng.integers(5, len(y) - 5))
        n = int(rng.integers(1, 3))
        y = (np.delete(y, range(at, at + n)) if rng.random() < 0.5
             else np.insert(y, at, rng.integers(0, 4, n)))
    return y, start


def write_trna_corpus(tmp, n_reads=24, n_refs=4, seed=3):
    """Reads (both strands) and references of a synthetic tRNA corpus;
    returns (fastq, fasta, truth {read: (ref, reverse)})."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, int(rng.integers(70, 91)))
            for _ in range(n_refs)]
    fa = os.path.join(tmp, "trna.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(refs):
            fh.write(">tRNA%d\n%s\n" % (i, "".join(BASES[r])))
    fq = os.path.join(tmp, "trna.fq")
    truth = {}
    with open(fq, "w") as fh:
        for k in range(n_reads):
            ri = k % n_refs
            y, _ = _trna_read(rng, refs[ri])
            reverse = k % 2 == 1
            if reverse:
                y = (3 - y)[::-1]
            seq = "".join(BASES[y])
            fh.write("@t%d\n%s\n+\n%s\n" % (k, seq, "I" * len(seq)))
            truth["t%d" % k] = ("tRNA%d" % ri, reverse)
    return fq, fa, truth


def _records(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("@")]


def _mutated(tmp, fa, seed=9):
    """A copy of the references with an SNV every 11 bases."""
    rng = np.random.default_rng(seed)
    refs = get_fasta_dictionary(fa)
    out = os.path.join(tmp, "trna_mut.fa")
    with open(out, "w") as fh:
        for name, seq in refs.items():
            s = list(seq)
            for p in range(6, len(s) - 6, 11):
                s[p] = "ACGT"[("ACGT".index(s[p]) + int(rng.integers(1, 4)))
                              % 4]
            fh.write(">%s\n%s\n" % (name, "".join(s)))
    return out


def _recording(mp, module, name, into):
    """module.name, recording each call's result in the list `into`."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        into.append(fn(*args, **kwargs))
        return into[-1]

    mp.setattr(module, name, call)


def mea_objective(ops, post, gap_gamma=0.5):
    """The MEA objective of aligned ops [(op, len)] over a problem's dense
    posterior [m, n] (band.unpack_problem): the posterior of every matched
    pair, gap_gamma * clip(1 - row / column sum) of every skipped read /
    reference position."""
    g_read = gap_gamma * np.clip(1.0 - post.sum(axis=1), 0.0, 1.0)
    g_ref = gap_gamma * np.clip(1.0 - post.sum(axis=0), 0.0, 1.0)
    i = j = 0
    total = 0.0
    for op, ln in ops:
        for _ in range(ln):
            if op == 0:
                total += float(post[i, j])
                i, j = i + 1, j + 1
            elif op == 1:
                total += float(g_read[i])
                i += 1
            else:
                total += float(g_ref[j])
                j += 1
    return total


def _aligned_ops(cigar):
    """The M / I / D runs of a SAM cigar string as [(op, len)]."""
    import re

    code = {"M": 0, "I": 1, "D": 2}
    return [(code[op], int(n)) for n, op in re.findall(r"(\d+)([MIDS])",
                                                       cigar) if op in code]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus through the JAX package's guide and realignment with
    MARGINALIGN_MULTI=on (its realignment's packing and posterior band
    kept), and through the port's with multi=True."""
    tmp = str(tmp_path_factory.mktemp("trna"))
    fq, fa, truth = write_trna_corpus(tmp)
    hmm = PairHmm.load(DEFAULT_MODEL)
    out = {"fq": fq, "fa": fa, "truth": truth, "tmp": tmp, "jax_mb": [],
           "jax_post": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MARGINALIGN_MULTI", "on")
        out["jax_guide"] = os.path.join(tmp, "jax_guide.sam")
        jguide.map_reads(fq, fa, out["jax_guide"])
        out["jax_realigned"] = os.path.join(tmp, "jax_realigned.sam")
        _recording(mp, jband, "pack_multi_banded_batch", out["jax_mb"])
        _recording(mp, fp, "posteriors_pallas_multi", out["jax_post"])
        jrealign.realign_sam_file(out["jax_guide"], out["jax_realigned"], fq,
                                  fa, JPairHmm.load(JAX_MODEL))
    out["guide"] = os.path.join(tmp, "guide.sam")
    tguide.map_reads(fq, fa, out["guide"], None, "cpu", multi=True)
    out["realigned"] = os.path.join(tmp, "realigned.sam")
    trealign.realign_sam_file(out["jax_guide"], out["realigned"], fq, fa,
                              hmm, "cpu", multi=True)
    return out


def test_map_reads_multi_matches_jax(corpus):
    """map_reads(multi=True) writes the JAX package's multi-lane guide SAM,
    and places every read it maps on its reference and strand (the
    13-mer seeds of the "last" preset miss a few reads at 12%
    substitutions, in both packages: 21 of 24 map here)."""
    got = _records(corpus["guide"])
    assert got == _records(corpus["jax_guide"])
    assert len(got) >= 0.75 * len(corpus["truth"])
    for line in got:
        f = line.split("\t")
        assert (f[2], bool(int(f[1]) & 16)) == corpus["truth"][f[0]]


def test_realign_sam_file_multi_matches_jax(corpus):
    """realign_sam_file(multi=True) on the JAX guide SAM gives the JAX
    package's multi-lane cigars, record for record, or MEA near-ties of
    them: the objective under the JAX package's posteriors within 1e-5
    (relative) of its own cigar's.  Both packages' multi-lane posteriors
    carry float32 noise that grows with a problem's place in its lane (the
    lane's log-scale sums reach ~-1000: one ulp is ~1e-4); here they are
    6.1e-5 apart, and 2 of 21 records flip, both exact ties (gap 0)."""
    got = [line.split("\t") for line in _records(corpus["realigned"])]
    want = [line.split("\t") for line in _records(corpus["jax_realigned"])]
    assert [f[:5] for f in got] == [f[:5] for f in want]
    assert len(corpus["jax_mb"]) == len(corpus["jax_post"]) == 1
    mb = corpus["jax_mb"][0]
    post = np.asarray(corpus["jax_post"][0][1])
    assert len(mb.problems) == len(got)
    flips, worst = [], 0.0
    for p, (g, w) in enumerate(zip(got, want)):
        if g[5] == w[5]:
            continue
        dense = jband.unpack_problem(post, mb, p)
        best = mea_objective(_aligned_ops(w[5]), dense)
        gap = (best - mea_objective(_aligned_ops(g[5]), dense)) / best
        flips.append((g[0], gap))
        worst = max(worst, gap)
    print("records whose cigar differs from the JAX package's (relative "
          "objective gap): %s" % flips)
    assert len(flips) <= 0.15 * len(got)
    assert worst <= 1e-5


def test_margin_caller_multi_matches_jax(corpus, monkeypatch):
    """accumulate_expectations(multi=True) on the realigned SAM against a
    mutated reference (split 100: every segment in multi lanes): within
    2e-4 of the JAX package's multi-lane caller, and margin_caller(
    multi=True) makes the same calls.  Measured 1.27e-4: the two packages'
    multi-lane posteriors are 6.1e-5 apart (torch's and XLA's float32 log
    and exp round differently in the lane-long log-scale sums, whose ulp
    is ~1e-4 at the end of a 1024-step lane), and the JAX package's own
    multi-lane posterior is 2.1e-4 from its single-lane one on this corpus,
    so the 1e-4 first asked for is below the float32 noise of the
    route."""
    mut = _mutated(corpus["tmp"], corpus["fa"])
    sam = corpus["realigned"]
    monkeypatch.setenv("MARGINALIGN_MULTI", "on")
    jhmm = JPairHmm.load(JAX_MODEL)
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam), jfasta(mut), jhmm, jcaller.CallerOptions())
    hmm = PairHmm.load(DEFAULT_MODEL)
    multi = _counting(monkeypatch, tcaller, "_multi_expectations")
    got = tcaller.accumulate_expectations(
        SamFile.read(sam), get_fasta_dictionary(mut), hmm,
        tcaller.CallerOptions(), device="cpu", multi=True)
    assert multi
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print("multi caller expectations vs the JAX package's: %.3g" % err)
    assert sum(float(v.sum()) for v in got.values()) > 100.0
    assert err <= 2e-4
    vcf = os.path.join(corpus["tmp"], "multi.vcf")
    calls = tcaller.margin_caller(sam, mut, vcf, hmm, hmm, device="cpu",
                                  multi=True)
    jcalls = jcaller.margin_caller(sam, mut, vcf + ".jax", jhmm, jhmm)
    assert calls
    assert {c[:3] for c in calls} == {c[:3] for c in jcalls}


# ------------------------------------------------------------------ routing


def _counting(monkeypatch, module, name):
    """Count the calls of module.name; returns the list they append to."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _jobs(rng, lengths):
    """Realign jobs of reads with 10% substitutions against references of
    the given lengths, each along its diagonal."""
    jobs = []
    for n in lengths:
        ref = rng.integers(0, 4, n).astype(np.int8)
        read = ref.copy()
        hit = rng.random(n) < 0.1
        read[hit] = rng.integers(0, 4, int(hit.sum()))
        jobs.append(trealign.RealignJob(None, read, ref,
                                        path_from_cigar([(0, n)])))
    return jobs


def _non_flat_model():
    hmm = PairHmm.load(DEFAULT_MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    return hmm


@pytest.mark.parametrize("case", ["long_job", "non_flat", "short_flat"])
def test_multi_routing_policy(monkeypatch, case):
    """multi=True takes multi lanes in realignment only for flat-gap models
    whose jobs all span at most MULTI_MAX_PROBLEM_STEPS diagonals (one of
    257 + 256 + 1 = 514 is too long); otherwise the call runs the route it
    runs without multi, with the same result."""
    rng = np.random.default_rng(12)
    lengths = [257, 60] if case == "long_job" else [60, 40, 70]
    jobs = _jobs(rng, lengths)
    hmm = _non_flat_model() if case == "non_flat" else PairHmm.load(
        DEFAULT_MODEL)
    multi = _counting(monkeypatch, trealign, "_realign_multi")
    got = trealign.realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, "cpu",
                                          multi=True)
    assert bool(multi) == (case == "short_flat")
    if case != "short_flat":
        assert got == trealign.realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0,
                                                      "cpu")
    assert trealign.use_multi_lanes(jobs, trealign.tables_from_hmm(hmm)) \
        == (case == "short_flat")


def test_caller_multi_routing_policy(monkeypatch, tmp_path):
    """The caller asks the same policy after anchor splitting: with split 0
    a record longer than 512 diagonals keeps it off multi lanes; split 100
    brings every segment under the limit."""
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 300)
    fa = tmp_path / "ref.fa"
    fa.write_text(">r\n%s\n" % "".join(BASES[ref]))
    read = ref[10:290].copy()
    read[rng.random(len(read)) < 0.05] = 2
    sam = tmp_path / "in.sam"
    sam.write_text("@SQ\tSN:r\tLN:300\nq\t0\tr\t11\t60\t280M\t*\t0\t0\t%s\t%s\n"
                   % ("".join(BASES[read]), "I" * len(read)))
    hmm = PairHmm.load(DEFAULT_MODEL)
    multi = _counting(monkeypatch, tcaller, "_multi_expectations")
    refs = get_fasta_dictionary(str(fa))
    for split, used in ((0, False), (100, True)):
        opts = tcaller.CallerOptions(split_size=split)
        got = tcaller.accumulate_expectations(SamFile.read(str(sam)), refs,
                                              hmm, opts, "cpu", multi=True)
        assert bool(multi) == used
        multi.clear()
        plain = tcaller.accumulate_expectations(SamFile.read(str(sam)), refs,
                                                hmm, opts, "cpu")
        assert np.abs(got["r"] - plain["r"]).max() <= 1e-4


def test_guide_multi_always_packs(monkeypatch, tmp_path):
    """The guide takes multi lanes with multi=True whatever the problems'
    sizes (a 400-nt read), as the JAX package's guide does."""
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 4, 420)
    fa = tmp_path / "ref.fa"
    fa.write_text(">r\n%s\n" % "".join(BASES[ref]))
    read = ref[5:405].copy()
    read[rng.random(len(read)) < 0.05] = 1
    fq = tmp_path / "r.fq"
    fq.write_text("@q\n%s\n+\n%s\n" % ("".join(BASES[read]),
                                       "I" * len(read)))
    multi = _counting(monkeypatch, tguide, "banded_nw_multi")
    single = _counting(monkeypatch, tguide, "banded_nw")
    out = tmp_path / "o.sam"
    tguide.map_reads(str(fq), str(fa), str(out), None, "cpu", multi=True)
    assert multi and not single
    assert len(_records(str(out))) == 1
