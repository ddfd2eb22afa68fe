"""The paths that models with non-flat gap emissions take through the port
(the generic forward-backward pair, rows 8-9, on the CPU through its plain
versions) vs the JAX package: realignment with such a model
(`realigned_ops_for_jobs`: the REL path whatever `fused` says), marginCaller
with it (`accumulate_expectations`: band arrays, the generic pair,
`band_expectations`), both against the JAX package with
MARGINALIGN_KERNEL=pallas (the generic branch of
`posteriors_pallas_specialised` in interpret mode); and EM with
update_band_every=1 (--updateTheBand), lockstep and serial, against the JAX
package's `train_em` (its XLA engine on the CPU), plus a lockstep resume."""
import os

import numpy as np
import pytest
import torch

from marginalign_trna_tpu.align import em as jem
from marginalign_trna_tpu.align import realign as jrealign
from marginalign_trna_tpu.call import caller as jcaller
from marginalign_trna_tpu.io.fasta import get_fasta_dictionary as jfasta
from marginalign_trna_tpu.io.sam import SamFile as JSamFile
from marginalign_trna_tpu.io.sam import SamRecord as JaxRecord
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu_torch.align import em
from marginalign_trna_tpu_torch.align import realign as trealign
from marginalign_trna_tpu_torch.align.checkpoint import EmLockstepCheckpoint
from marginalign_trna_tpu_torch.call import caller as tcaller
from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
from marginalign_trna_tpu_torch.io.sam import SamFile, SamRecord
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import fb_cuda
from marginalign_trna_tpu_torch.ops.band import (
    pack_banded_batch, path_from_cigar,
)
from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_hmm
from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

WIDTH = 21


@pytest.fixture
def pallas(monkeypatch):
    """The JAX package's accelerator default on the CPU: Pallas kernels in
    interpret mode."""
    monkeypatch.setenv("MARGINALIGN_KERNEL", "pallas")


def _non_flat_model():
    """The shipped model with its first gap state's emissions perturbed and
    renormalised (as an un-normalised trial model, not flat)."""
    hmm = PairHmm.load(DEFAULT_MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    assert not fb_cuda.has_flat_gap_emissions(tables_from_hmm(hmm))
    return hmm


def _jax_model(hmm):
    return JPairHmm(hmm.transitions.copy(), hmm.emissions.copy())


def _noisy_jobs(rng, n_jobs=6):
    """(read, ref, ops) of noisy reads (10% substitutions, 4% deletions,
    4% insertions) of 50-100 bases, each aligned to its window by its true
    cigar."""
    out = []
    for _ in range(n_jobs):
        ref = rng.integers(0, 4, size=int(rng.integers(50, 100)))
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


def _mea_objective(ops, read, ref, path, hmm, gap_gamma=0.5):
    """The MEA objective of one job's ops under the port's generic
    posteriors of that job alone (float64 on the host): the posterior of
    every matched pair plus gap_gamma * (1 - row or column mass) of every
    skipped read or reference base."""
    batch = pack_banded_batch([read], [ref], width=WIDTH, paths=[path])
    dev = device_batch(batch, "cpu")
    _, post = fb_cuda.posteriors_specialised(tables_from_hmm(hmm), dev)
    post = post.numpy()[:, :, 0].astype(np.float64)
    lo = batch.lo[:, 0].astype(np.int64)
    D1, Wp = post.shape
    i = lo[:, None] + np.arange(Wp)[None, :]
    j = np.arange(D1)[:, None] - i
    ok = batch.valid[:, :, 0] & (i >= 1) & (j >= 1)
    rows = np.bincount(i[ok] - 1, post[ok], minlength=len(read))
    cols = np.bincount(j[ok] - 1, post[ok], minlength=len(ref))
    a = b = 0
    total = 0.0
    for op, ln in ops:
        for _ in range(ln):
            if op == 0:
                a, b = a + 1, b + 1
                total += post[a + b, a - lo[a + b]]
            elif op == 1:
                a += 1
                total += gap_gamma * min(max(1.0 - rows[a - 1], 0.0), 1.0)
            else:
                b += 1
                total += gap_gamma * min(max(1.0 - cols[b - 1], 0.0), 1.0)
    return total


def test_realigned_ops_non_flat_match_jax(pallas, monkeypatch):
    """realigned_ops_for_jobs with a non-flat model on the CPU (asked for
    the fused path, it takes the REL path and the generic pair) vs the JAX
    package's REL generic route: identical cigars, or MEA near-ties
    (objectives within 1e-5 relative under the port's posteriors)."""
    hmm = _non_flat_model()
    data = _noisy_jobs(np.random.default_rng(31))
    jjobs, tjobs = [], []
    for read, ref, ops in data:
        path = path_from_cigar(ops)
        jjobs.append(jrealign.RealignJob(None, read, ref, path))
        tjobs.append(trealign.RealignJob(None, read, ref, path))
    calls = []
    generic = fb_cuda.posteriors_generic

    def counted(*args):
        calls.append(1)
        return generic(*args)

    monkeypatch.setattr(fb_cuda, "posteriors_generic", counted)
    want = jrealign.realigned_ops_for_jobs(jjobs, _jax_model(hmm), 0.5, 0.0)
    got = trealign.realigned_ops_for_jobs(tjobs, hmm, 0.5, 0.0, "cpu",
                                          fused=True)
    assert calls, "the generic pair did not run"
    worst, flips = 0.0, []
    for k, (g, w) in enumerate(zip(got, want)):
        read, ref, _ = data[k]
        assert sum(ln for op, ln in g if op != 2) == len(read)
        assert sum(ln for op, ln in g if op != 1) == len(ref)
        if g != w:
            flips.append(k)
            fg = _mea_objective(g, read, ref, tjobs[k].path, hmm)
            fw = _mea_objective(w, read, ref, tjobs[k].path, hmm)
            worst = max(worst, abs(fg - fw) / max(abs(fg), 1.0))
    print("non-flat realign: cigars differing from the JAX package's %s, "
          "worst objective difference %.3g (relative)" % (flips, worst))
    assert len(flips) <= 1 and worst <= 1e-5


def _write_caller_corpus(tmp):
    """One 240-base reference with an SNV every 30 bases; six reads copied
    from the unmutated sequence with 2% substitutions, a 3-base deletion
    and soft clips, aligned (cigar) against the mutated one.  Returns (sam,
    fasta, planted {(name, 0-based position, true base)})."""
    rng = np.random.default_rng(9)
    bases = np.array(list("ACGT"))
    orig = rng.integers(0, 4, size=240)
    mutated = orig.copy()
    planted = set()
    for p in range(20, 220, 30):
        mutated[p] = (orig[p] + int(rng.integers(1, 4))) % 4
        planted.add(("chr", p, str(bases[orig[p]])))
    records = []
    for r in range(6):
        start = int(rng.integers(0, 15))
        span = int(rng.integers(190, 240 - start))
        window = orig[start:start + span].copy()
        noise = rng.random(span) < 0.02
        window[noise] = rng.integers(0, 4, size=int(noise.sum()))
        a = span // 2
        read = np.concatenate([rng.integers(0, 4, 3), window[:a],
                               window[a + 3:], rng.integers(0, 4, 2)])
        seq = "".join(bases[read])
        records.append("r%d\t0\tchr\t%d\t60\t3S%dM3D%dM2S\t*\t0\t0\t%s\t%s"
                       % (r, start + 1, a, span - a - 3, seq, "I" * len(seq)))
    sam, fa = tmp / "in.sam", tmp / "ref.fa"
    sam.write_text("@HD\tVN:1.3\n@SQ\tSN:chr\tLN:240\n"
                   + "\n".join(records) + "\n")
    fa.write_text(">chr\n%s\n" % "".join(bases[mutated]))
    return str(sam), str(fa), planted


def test_accumulate_expectations_non_flat_match_jax(pallas, tmp_path):
    """marginCaller's expectations with a non-flat model (band arrays, the
    generic pair, band_expectations) vs the JAX package's REL generic route:
    within 2e-3, identical call sets."""
    sam, fa, planted = _write_caller_corpus(tmp_path)
    hmm = _non_flat_model()
    want = jcaller.accumulate_expectations(
        JSamFile.read(sam), jfasta(fa), _jax_model(hmm),
        jcaller.CallerOptions())
    refs = get_fasta_dictionary(fa)
    got = tcaller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, tcaller.CallerOptions(), device="cpu")
    err = float(np.abs(got["chr"] - want["chr"]).max())
    error = PairHmm.load(DEFAULT_MODEL)
    calls = [{c[:3] for c in mod.call_variants(exp, refs, error, 0.3)}
             for mod, exp in ((tcaller, got), (jcaller, want))]
    print("non-flat caller: expectations max abs difference %g; %d calls, "
          "%d of %d planted SNVs" % (err, len(calls[0]),
                                     len(calls[0] & planted), len(planted)))
    assert err <= 2e-3
    assert calls[0] == calls[1]
    assert len(calls[0] & planted) >= 0.9 * len(planted)
    assert got["chr"].sum() > 0.9 * 6 * 190


def test_band_expectations_match_jax():
    """band_expectations (lane-local run boundaries, then one add per lane
    position into the global sums) vs the JAX package's, which sums dense
    [rg, B] per-lane runs, on a random posterior band: a moving band, N
    bases in the reads, padded lanes, overlapping reference windows; within
    1e-4, and the padded lanes add nothing."""
    from marginalign_trna_tpu.ops import expectations as jexp
    from marginalign_trna_tpu.ops.band import (
        pack_banded_batch as jpack_banded_batch,
    )
    from marginalign_trna_tpu_torch.ops import expectations as texp

    rng = np.random.default_rng(23)
    reads = [rng.integers(0, 5, size=m).astype(np.int8)
             for m in (40, 80, 64, 17)]
    refs = [rng.integers(0, 4, size=n).astype(np.int8)
            for n in (52, 70, 64, 30)]
    paths = [None, path_from_cigar([(0, 40), (2, 10), (0, 30)]), None, None]
    kw = dict(width=WIDTH, paths=paths, pad_batch_to=6)
    jbatch = jpack_banded_batch(reads, refs, **kw)
    batch = pack_banded_batch(reads, refs, **kw)
    post = rng.random(batch.valid.shape).astype(np.float32) * batch.valid
    post[:, :, 4:] = rng.random(post[:, :, 4:].shape)
    offsets = np.array([0, 30, 120, 5, 0, 0], np.int64)
    total = 200
    want = jexp.band_expectations(post, jbatch, offsets, total, n_real=4)
    got = texp.band_expectations(torch.from_numpy(post), batch,
                                 device_batch(batch, "cpu"), offsets, total,
                                 4)
    err = float(np.abs(got - want).max())
    print("band_expectations: max abs difference from the JAX package's %g"
          % err)
    assert got.shape == (total, 4)
    assert err <= 1e-4
    assert got.sum() > 0


def _em_jobs(seed, job_cls, rec_cls, n=4, length=200):
    """n pairs of `length` bases, a 6-base deletion in the middle along the
    guide path and 10% substitutions (tests/test_torch_em.py's jobs)."""
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(n):
        ref = rng.integers(0, 4, size=length).astype(np.int8)
        cut = length // 2 + 7 * idx
        read = np.concatenate([ref[:cut], ref[cut + 6:]])
        hit = rng.random(len(read)) < 0.1
        read[hit] = rng.integers(0, 4, size=int(hit.sum()))
        ops = [(0, cut), (2, 6), (0, length - cut - 6)]
        rec = rec_cls(qname="r%d" % idx, flag=0, rname="ref", pos=0,
                      mapq=255, cigar=ops, seq="A" * len(read))
        out.append(job_cls(record=rec, read_region=read, ref_region=ref,
                           path=path_from_cigar(ops)))
    return out


# Trial 0 starts from the shipped model: the band then follows a usable
# aligner.  A random start's first models align with gaps everywhere, and
# their MEA decodes are exact ties (all-gap paths of equal objective) that
# the JAX package's own XLA and Pallas routes already break differently.
EM_START = dict(use_default_model_as_start=True, tolerance=0.0,
                split_size=0, update_band_every=1)


@pytest.mark.parametrize("trials", [2, 1])
def test_train_em_update_band_matches_jax(trials):
    """update_band_every=1: lockstep (trials=2, one band from the best
    trial's model) and serial (trials=1, trial-local bands) training, the
    same likelihood histories (rtol 1e-4) and trained parameters (atol
    1e-3) as the JAX package's train_em."""
    kw = dict(trials=trials, iterations=3, seed=5, **EM_START)
    hmm = PairHmm.load(DEFAULT_MODEL)
    want = jem.train_em(_em_jobs(1, jrealign.RealignJob, JaxRecord),
                        jem.EmOptions(**kw), input_hmm=_jax_model(hmm))
    got = em.train_em(_em_jobs(1, trealign.RealignJob, SamRecord),
                      em.EmOptions(**kw), input_hmm=hmm, device="cpu")
    assert len(got.likelihood_history) == 3
    hist = np.abs(np.subtract(got.likelihood_history,
                              want.likelihood_history))
    perr = max(np.abs(got.hmm.transitions - want.hmm.transitions).max(),
               np.abs(got.hmm.emissions - want.hmm.emissions).max())
    print("train_em update_band_every=1 trials=%d: histories max rel err "
          "%.3g, parameters max abs err %.3g"
          % (trials, (hist / np.abs(want.likelihood_history)).max(), perr))
    assert np.allclose(got.likelihood_history, want.likelihood_history,
                       rtol=1e-4, atol=0)
    assert perr <= 1e-3


def test_lockstep_resume_with_band_updates(tmp_path):
    """A lockstep run with update_band_every=1 cut during its third
    iteration resumes from its checkpoint (the band re-derived from the
    restored best model) to the uninterrupted run's model and histories."""
    jobs = _em_jobs(3, trealign.RealignJob, SamRecord, n=3, length=120)
    opts = em.EmOptions(trials=2, iterations=4, seed=2, **EM_START)
    hmm = PairHmm.load(DEFAULT_MODEL)
    full = em.train_em(jobs, opts, input_hmm=hmm, device="cpu")
    ckpt = str(tmp_path / "em.ckpt")

    class _Boom(Exception):
        pass

    calls = {"n": 0}

    def crashing_log(_msg):
        calls["n"] += 1
        if calls["n"] == 2 * 2 + 1:   # first log line of iteration 2
            raise _Boom()

    with pytest.raises(_Boom):
        em.train_em(jobs, opts, input_hmm=hmm, log_fn=crashing_log,
                    checkpoint_path=ckpt, device="cpu")
    assert EmLockstepCheckpoint.try_load(ckpt).iteration == 2
    resumed = em.train_em(jobs, opts, input_hmm=hmm, checkpoint_path=ckpt,
                          device="cpu")
    assert np.allclose(resumed.hmm.transitions, full.hmm.transitions,
                       atol=1e-6)
    assert np.allclose(resumed.hmm.emissions, full.hmm.emissions, atol=1e-6)
    assert np.allclose(resumed.likelihood_history,
                       full.likelihood_history, rtol=1e-7)
    assert os.path.exists(ckpt)
