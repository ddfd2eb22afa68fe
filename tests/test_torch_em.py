"""EM training in the port (align/em.py over ops/fb_counts.py's plain
versions) vs the JAX package's `train_em` on the CPU (its XLA engine), on
synthetic jobs made from a numpy seed: likelihood histories within rtol
1e-4 and trained parameters within atol 1e-3, lockstep and serial trials,
with and without anchor splitting; resume from a checkpoint; the kernel
policy; band re-derivation runs; the refusal of what is not ported.
About 20 s on one CPU core."""
import os

import jax
import numpy as np
import pytest

from marginalign_trna_tpu.align import em as jem
from marginalign_trna_tpu.align.realign import RealignJob as JaxJob
from marginalign_trna_tpu.io.sam import SamRecord as JaxRecord
from marginalign_trna_tpu.ops import fb as jfb
from marginalign_trna_tpu.ops.band import path_from_cigar
from marginalign_trna_tpu_torch.align import em
from marginalign_trna_tpu_torch.align.checkpoint import EmLockstepCheckpoint
from marginalign_trna_tpu_torch.align.realign import RealignJob
from marginalign_trna_tpu_torch.io.sam import SamRecord
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops.fb import (
    tables_from_jax, tables_stacked,
)
from marginalign_trna_tpu_torch.ops.fb_counts import use_ckpt

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")


def _jobs(seed, job_cls, rec_cls, n=5, length=420):
    """n pairs of `length` bases, a 6-base deletion in the middle along the
    guide path and 10% substitutions; the same pairs for either package's
    job and record classes."""
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


@pytest.mark.parametrize("trials,split_size", [
    (2, 0), (2, 300), (1, 0), (1, 300),
])
def test_train_em_matches_jax(trials, split_size):
    """Lockstep (trials=2) and serial (trials=1) training, whole pairs and
    300-base anchor segments: the same likelihood histories (rtol 1e-4)
    and trained parameters (atol 1e-3) as the JAX package's train_em."""
    kw = dict(trials=trials, iterations=3, tolerance=0.0,
              split_size=split_size, seed=5)
    want = jem.train_em(_jobs(1, JaxJob, JaxRecord), jem.EmOptions(**kw))
    got = em.train_em(_jobs(1, RealignJob, SamRecord), em.EmOptions(**kw),
                      device="cpu")
    assert len(got.likelihood_history) == 3
    hist = np.abs(np.subtract(got.likelihood_history,
                              want.likelihood_history))
    print("train_em trials=%d split=%d: histories max rel err %.3g, "
          "parameters max abs err %.3g" % (
              trials, split_size,
              (hist / np.abs(want.likelihood_history)).max(),
              max(np.abs(got.hmm.transitions - want.hmm.transitions).max(),
                  np.abs(got.hmm.emissions - want.hmm.emissions).max())))
    assert np.allclose(got.likelihood_history, want.likelihood_history,
                       rtol=1e-4, atol=0)
    assert np.allclose(got.likelihood, want.likelihood, rtol=1e-4)
    assert np.allclose(got.hmm.transitions, want.hmm.transitions, atol=1e-3)
    assert np.allclose(got.hmm.emissions, want.hmm.emissions, atol=1e-3)


def test_expectation_step_matches_jax_on_shipped_model():
    """One E-step of the shipped model (flat gaps) over the split jobs:
    counts within rtol/atol 1e-3, log-likelihood within rtol 1e-4."""
    from marginalign_trna_tpu.align.realign import split_jobs_at_anchors
    from marginalign_trna_tpu_torch.align.realign import (
        split_jobs_at_anchors as split,
    )

    hmm = PairHmm.load(MODEL)
    jsegs, _, _ = split_jobs_at_anchors(_jobs(2, JaxJob, JaxRecord), 300)
    segs, _, _ = split(_jobs(2, RealignJob, SamRecord), 300)
    from marginalign_trna_tpu.models.hmm import PairHmm as JaxHmm

    want = jem.expectation_step(jem.prepare_em_batches(jsegs),
                                JaxHmm.load(MODEL))
    got = em.expectation_step(em.prepare_em_batches(segs, device="cpu"),
                              hmm)
    for g, w in zip(got[:3], want[:3]):
        assert np.allclose(g, w, rtol=1e-3, atol=1e-3)
    assert np.isclose(got[3], want[3], rtol=1e-4)


def test_stacked_tables_equal_jax():
    hmms = [PairHmm.random(seed=3), PairHmm.load(MODEL)]
    for h in hmms:
        h.apply_model_type_constraints()
    from marginalign_trna_tpu.models.hmm import PairHmm as JaxHmm

    jt = jem.make_tables_stacked([JaxHmm(h.transitions, h.emissions)
                                  for h in hmms])
    mine = tables_stacked(hmms)
    theirs = tables_from_jax(jax.device_get(jt))
    for name in ("T", "Ematch", "Egap", "pi"):
        assert np.array_equal(getattr(mine, name).numpy(),
                              getattr(theirs, name).numpy()), name
    assert isinstance(jt, jfb.FbTables)


@pytest.mark.parametrize("trials", [2, 1])
def test_resume_matches_uninterrupted(tmp_path, trials):
    """A run cut during its third iteration resumes from its checkpoint
    (the lockstep format for trials=2, the serial one for trials=1) to the
    uninterrupted run's model and histories (tests/test_em.py's resume
    test, on the port)."""
    jobs = _jobs(3, RealignJob, SamRecord, n=4, length=160)
    opts = em.EmOptions(trials=trials, iterations=5, tolerance=0.0, seed=2,
                        split_size=0)
    full = em.train_em(jobs, opts, device="cpu")
    ckpt = str(tmp_path / "em.ckpt")

    class _Boom(Exception):
        pass

    calls = {"n": 0}

    def crashing_log(_msg):
        calls["n"] += 1
        if calls["n"] == 2 * trials + 1:   # first log line of iteration 2
            raise _Boom()

    with pytest.raises(_Boom):
        em.train_em(jobs, opts, log_fn=crashing_log, checkpoint_path=ckpt,
                    device="cpu")
    if trials > 1:
        ck = EmLockstepCheckpoint.try_load(ckpt)
        assert ck is not None and ck.iteration == 2
    resumed = em.train_em(jobs, opts, checkpoint_path=ckpt, device="cpu")
    assert np.allclose(resumed.hmm.transitions, full.hmm.transitions,
                       atol=1e-6)
    assert np.allclose(resumed.hmm.emissions, full.hmm.emissions, atol=1e-6)
    assert np.allclose(resumed.likelihood_history[-3:],
                       full.likelihood_history[-3:], rtol=1e-7)


def test_unported_options_refused():
    """Re-deriving the band (update_band_every=1, --updateTheBand) trains;
    multi-problem lanes (multi=True), once refused, now pack the jobs into
    E-step batches of multi-problem lanes, every job a problem of them."""
    jobs = _jobs(4, RealignJob, SamRecord, n=2, length=60)
    res = em.train_em(jobs, em.EmOptions(update_band_every=1, iterations=2,
                                         trials=2, tolerance=0.0,
                                         split_size=0), device="cpu")
    assert len(res.likelihood_history) == 2
    assert np.isfinite(res.likelihood_history).all()
    batches = em.prepare_em_batches(jobs, device="cpu", multi=True)
    assert [kind for kind, _, _ in batches] == ["multi"]
    assert sum(n for _, _, n in batches) == len(jobs)
    assert batches[0][1].p_lane.numel() == len(jobs)


def test_kernel_policy_matches_jax(monkeypatch):
    """use_ckpt picks the JAX package's family: the stored pair while
    (5 + 1) float32 bands per padded cell and trial fit the budget."""
    from marginalign_trna_tpu.ops.fb_pallas_counts import _use_ckpt

    # The last four are multi-problem lane shapes (lanes of 1024 diagonals,
    # D1 raised to fit a longer problem, the lane count a power of two).
    shapes = [((1024, 24, 4096), 3), ((1024, 24, 4096), 1),
              ((1021, 24, 2048), 3), ((128, 24, 64), 1),
              ((1024, 24, 2048), 3), ((1024, 24, 8192), 1),
              ((1131, 24, 4096), 3), ((1024, 16, 16), 2)]
    for shape, ntr in shapes:
        assert use_ckpt(shape, ntr) == _use_ckpt(shape, ntr)
    assert use_ckpt((1024, 24, 4096), 3)            # the default 3-trial run
    assert not use_ckpt((1024, 24, 4096), 1)
    assert not use_ckpt((1024, 24, 4096), 3, kernel="stored")
    assert use_ckpt((128, 24, 64), 1, kernel="ckpt")
    assert not use_ckpt((1024, 24, 4096), 3, budget_mb=8192)
    monkeypatch.setenv("MARGINALIGN_EM_STORED_BUDGET_MB", "8192")
    assert _use_ckpt((1024, 24, 4096), 3) == use_ckpt(
        (1024, 24, 4096), 3, budget_mb=8192)
    with pytest.raises(ValueError):
        use_ckpt((128, 24, 64), 1, kernel="fast")
