"""The unfused circular serving route through the port's entry points
(`serve=<mode>`): realignment (`realigned_ops_for_jobs`) and marginCaller
(`accumulate_expectations`) on the CPU, through the plain versions of the
serving kernels, against the JAX package with MARGINALIGN_KERNEL=pallas,
MARGINALIGN_LAYOUT=circ, MARGINALIGN_MULTI=off, the fused consumer off
(MARGINALIGN_REALIGN_FUSED=off or MARGINALIGN_CALLER_FUSED=off) and
MARGINALIGN_CIRC_SERVE=<mode> (`posteriors_pallas_circ` in interpret
mode); the refusal of an unknown mode; and a model whose gap emissions are
not flat, which still takes the generic pair."""
import numpy as np
import pytest

from marginalign_trna_tpu.align import realign as jrealign
from marginalign_trna_tpu.call import caller as jcaller
from marginalign_trna_tpu.io.fasta import get_fasta_dictionary as jfasta
from marginalign_trna_tpu.io.sam import SamFile as JSamFile
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu_torch.align import realign as trealign
from marginalign_trna_tpu_torch.call import caller as tcaller
from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
from marginalign_trna_tpu_torch.io.sam import SamFile
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import fb_circ, fb_cuda
from marginalign_trna_tpu_torch.ops.band import path_from_cigar
from marginalign_trna_tpu_torch.ops.fb import tables_from_hmm
from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

BASES = np.array(list("ACGT"))
FAST_COMPILE = {"xla_disable_hlo_passes": "fusion"}


def _serve_env(monkeypatch, mode, fused_off):
    """The JAX package's unfused circular route in `mode`.  Its serving
    pair compiles without XLA's fusion pass, as in
    tests/test_torch_em_counts.py (the "ckpt" pair takes ~65 s to compile
    with it on this CPU, ~16 s without)."""
    for key, val in (("MARGINALIGN_KERNEL", "pallas"),
                     ("MARGINALIGN_LAYOUT", "circ"),
                     ("MARGINALIGN_MULTI", "off"),
                     (fused_off, "off"),
                     ("MARGINALIGN_CIRC_SERVE", mode)):
        monkeypatch.setenv(key, val)
    jitted = fp._posteriors_circ_static

    def fast_compiled(st, cdev, mode="lean"):
        return jitted.lower(st, cdev, mode=mode).compile(
            compiler_options=FAST_COMPILE)(cdev)

    monkeypatch.setattr(fp, "_posteriors_circ_static", fast_compiled)


def _counting(monkeypatch, module, name):
    """Count the calls of module.name (the port's modules look it up
    there); returns the list the calls append to."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _jobs(rng, n_jobs=8):
    """(read, ref, ops): noisy reads (10% substitutions, 4% deletions, 4%
    insertions) of 120-260 bases, each aligned to its window by its true
    cigar (tests/test_torch_realign_compact.py's jobs)."""
    out = []
    for _ in range(n_jobs):
        ref = rng.integers(0, 4, size=int(rng.integers(120, 260)))
        read, cigar = [], []
        for base in ref:
            u = rng.random()
            if u < 0.04:
                cigar.append(2)
                continue
            read.append(base if rng.random() >= 0.1
                        else int(rng.integers(0, 4)))
            cigar.append(0)
            if u > 0.96:
                read.append(int(rng.integers(0, 4)))
                cigar.append(1)
        ops = []
        for op in cigar:
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + 1)
            else:
                ops.append((op, 1))
        out.append((np.asarray(read, np.int8), ref.astype(np.int8), ops))
    return out


def _job_lists(data):
    jjobs, tjobs = [], []
    for read, ref, ops in data:
        path = path_from_cigar(ops)
        jjobs.append(jrealign.RealignJob(None, read, ref, path))
        tjobs.append(trealign.RealignJob(None, read, ref, path))
    return jjobs, tjobs


def _non_flat_model():
    """The shipped model with its first gap state's emissions perturbed and
    renormalised (not flat)."""
    hmm = PairHmm.load(DEFAULT_MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    return hmm


@pytest.mark.parametrize("mode", ["sv", "ckpt"])
def test_realigned_ops_serve_match_jax(monkeypatch, mode):
    """realigned_ops_for_jobs(serve=mode) on the CPU vs the JAX package's
    unfused circular realign in that mode: identical cigars, or at most
    one MEA tie flip (tests/test_torch_realign_compact.py's bound); the
    port went through posteriors_serve on every bucket."""
    _serve_env(monkeypatch, mode, "MARGINALIGN_REALIGN_FUSED")
    data = _jobs(np.random.default_rng(21))
    jjobs, tjobs = _job_lists(data)
    calls = _counting(monkeypatch, trealign, "posteriors_serve")
    want = jrealign.realigned_ops_for_jobs(jjobs, JPairHmm.load(DEFAULT_MODEL),
                                           0.5, 0.0)
    got = trealign.realigned_ops_for_jobs(tjobs, PairHmm.load(DEFAULT_MODEL),
                                          0.5, 0.0, "cpu", serve=mode)
    assert calls
    for ops, (read, ref, _) in zip(got, data):
        assert sum(ln for op, ln in ops if op != 2) == len(read)
        assert sum(ln for op, ln in ops if op != 1) == len(ref)
    flips = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
    print("serve=%s: jobs whose cigar differs from the JAX package's: %s"
          % (mode, flips))
    assert len(flips) <= 1, flips


def _write_caller_corpus(tmp):
    """Two references (260 and 220 bases) with an SNV every 23 bases; four
    reads per reference copied from the unmutated sequence with 2%
    substitutions, a 3-base deletion and soft clips, aligned (cigar)
    against the mutated one.  Returns (sam, fasta)."""
    rng = np.random.default_rng(4)
    header = ["@HD\tVN:1.3\tSO:unsorted"]
    fasta, records = [], []
    for name, length in (("chrA", 260), ("chrB", 220)):
        orig = rng.integers(0, 4, size=length)
        mutated = orig.copy()
        for p in range(15, length - 15, 23):
            mutated[p] = (orig[p] + int(rng.integers(1, 4))) % 4
        fasta.append(">%s\n%s\n" % (name, "".join(BASES[mutated])))
        header.append("@SQ\tSN:%s\tLN:%d" % (name, length))
        for r in range(4):
            start = int(rng.integers(0, 25))
            span = int(rng.integers(length - 60, length - start))
            window = orig[start:start + span].copy()
            noise = rng.random(span) < 0.02
            window[noise] = rng.integers(0, 4, size=int(noise.sum()))
            a = span // 2
            read = np.concatenate([rng.integers(0, 4, 4), window[:a],
                                   window[a + 3:], rng.integers(0, 4, 3)])
            seq = "".join(BASES[read])
            records.append("%s_%d\t0\t%s\t%d\t60\t4S%dM3D%dM3S\t*\t0\t0\t%s\t%s"
                           % (name, r, name, start + 1, a, span - a - 3, seq,
                              "I" * len(seq)))
    sam, fa = tmp / "in.sam", tmp / "ref.fa"
    sam.write_text("\n".join(header + records) + "\n")
    fa.write_text("".join(fasta))
    return str(sam), str(fa)


@pytest.mark.parametrize("mode", ["em", "lean", "emw"])
def test_accumulate_expectations_serve_match_jax(monkeypatch, tmp_path,
                                                 mode):
    """accumulate_expectations(serve=mode) on the CPU (band arrays, the
    serving kernels' plain versions, the band rotated back, then
    band_expectations) vs the JAX package's unfused circular caller
    (`band_expectations_circ`) in that mode: identical calls,
    expectations within 1e-5 of the port's own fused caller and within
    1e-4 of the JAX package's.  On this corpus the port's posteriors are
    up to 2.3e-5 from the JAX package's in every route (torch's and XLA's
    float32 log and exp round differently in the log-scale sums): its
    fused caller is 3.1e-5 from the JAX package's fused caller (XLA's
    default compile), while the JAX package's own two routes agree to
    4.8e-7, so 1e-5 against the JAX package is out of reach of either
    port route."""
    _serve_env(monkeypatch, mode, "MARGINALIGN_CALLER_FUSED")
    sam, fa = _write_caller_corpus(tmp_path)
    calls = _counting(monkeypatch, tcaller, "posteriors_serve")
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam), jfasta(fa), JPairHmm.load(DEFAULT_MODEL),
        jcaller.CallerOptions())
    refs = get_fasta_dictionary(fa)
    hmm = PairHmm.load(DEFAULT_MODEL)
    got = tcaller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, tcaller.CallerOptions(), device="cpu",
        serve=mode)
    assert calls
    fused = tcaller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, tcaller.CallerOptions(), device="cpu")
    err = max(float(np.abs(got[k] - want[k]).max()) for k in refs)
    ferr = max(float(np.abs(got[k] - fused[k]).max()) for k in refs)
    calls = [{c[:3] for c in mod.call_variants(exp, refs, hmm, 0.3)}
             for mod, exp in ((tcaller, got), (jcaller, want))]
    print("serve=%s caller: expectations max abs difference %g from the JAX "
          "package's, %g from the fused route; %d calls"
          % (mode, err, ferr, len(calls[0])))
    assert err <= 1e-4
    assert ferr <= 1e-5
    assert calls[0] == calls[1] and calls[0]
    assert sum(float(got[k].sum()) for k in refs) > 0.9 * 8 * 160


def test_unknown_serve_mode_raises(tmp_path):
    """Every entry point with a serve keyword refuses an unknown mode."""
    sam, fa = _write_caller_corpus(tmp_path)
    hmm = PairHmm.load(DEFAULT_MODEL)
    _, tjobs = _job_lists(_jobs(np.random.default_rng(1), 1))
    refs = get_fasta_dictionary(fa)
    calls = [
        lambda: trealign.realigned_ops_for_jobs(tjobs, hmm, 0.5, 0.0, "cpu",
                                                serve="fused"),
        lambda: trealign.realign_sam_file(sam, str(tmp_path / "o.sam"),
                                          None, fa, hmm, "cpu", no_chain=True,
                                          serve="fused"),
        lambda: tcaller.accumulate_expectations(
            SamFile.read(sam), refs, hmm, tcaller.CallerOptions(),
            device="cpu", serve="SV"),
        lambda: tcaller.margin_caller(sam, fa, str(tmp_path / "o.vcf"), hmm,
                                      hmm, device="cpu", serve="rel"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="serve"):
            call()
    assert fb_circ.SERVE_MODES == ("sv", "em", "lean", "emw", "ckpt")


def test_non_flat_model_with_serve_takes_generic_pair(monkeypatch, tmp_path):
    """A model whose gap emissions are not flat takes the generic pair
    whatever `serve` says, in realignment and in the caller: the same ops
    and expectations as without serve, and no serving kernel runs."""
    hmm = _non_flat_model()
    assert not fb_cuda.has_flat_gap_emissions(tables_from_hmm(hmm))
    _, tjobs = _job_lists(_jobs(np.random.default_rng(5), 4))
    sam, fa = _write_caller_corpus(tmp_path)
    refs = get_fasta_dictionary(fa)
    generic = (_counting(monkeypatch, fb_cuda, "posteriors_generic"),
               _counting(monkeypatch, tcaller, "posteriors_generic"))
    circ = (_counting(monkeypatch, trealign, "posteriors_serve"),
            _counting(monkeypatch, tcaller, "posteriors_serve"))
    got = trealign.realigned_ops_for_jobs(tjobs, hmm, 0.5, 0.0, "cpu",
                                          serve="sv")
    assert generic[0]
    want = trealign.realigned_ops_for_jobs(tjobs, hmm, 0.5, 0.0, "cpu")
    assert got == want
    exp = tcaller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, tcaller.CallerOptions(), device="cpu",
        serve="ckpt")
    assert generic[1]
    base = tcaller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, tcaller.CallerOptions(), device="cpu")
    for k in refs:
        assert np.array_equal(exp[k], base[k])
    assert not circ[0] and not circ[1]
