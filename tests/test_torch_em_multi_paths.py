"""Baum-Welch EM over multi-problem lanes end to end on the CPU: the
port's train_em(multi=True), serial and lockstep, and pipeline.align(
em=True, multi=True) (guide, chain, EM, realignment, all in multi-problem
lanes through the plain versions of their kernels) against the JAX
package's train_em and pipeline.align with MARGINALIGN_MULTI=on.  The JAX
package's jitted multi counts functions are swapped for copies compiled
without XLA's fusion pass (FAST_COMPILE, tests/test_torch_em_counts.py):
with it, each compile takes minutes on the CPU.  Training histories
rtol 1e-5, trained parameters atol 1e-4.  And the E-step batches of
train_em(multi=True) through band updates and a lockstep resume."""
import os

import jax
import numpy as np
import pytest

from marginalign_trna_tpu import pipeline as jpipeline
from marginalign_trna_tpu.align import em as jem
from marginalign_trna_tpu.align.realign import RealignJob as JaxJob
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu_torch import pipeline
from marginalign_trna_tpu_torch.align import em
from marginalign_trna_tpu_torch.align.realign import RealignJob
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from test_torch_em_counts import FAST_COMPILE
from test_torch_multi_paths import (
    _aligned_ops, _records, _recording, mea_objective, write_trna_corpus,
)


def _train_jobs(job_cls, n=7, seed=11):
    """n tRNA-sized pairs (40-90 bases, 12% substitutions, a 3-base
    deletion along the guide path) for either package's job class."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        length = int(rng.integers(40, 91))
        ref = rng.integers(0, 4, size=length).astype(np.int8)
        cut = length // 2 + k
        read = np.concatenate([ref[:cut], ref[cut + 3:]])
        hit = rng.random(len(read)) < 0.12
        read[hit] = rng.integers(0, 4, size=int(hit.sum()))
        ops = [(0, cut), (2, 3), (0, length - cut - 3)]
        out.append(job_cls(record=None, read_region=read, ref_region=ref,
                           path=jband.path_from_cigar(ops)))
    return out


def _fast_jax_counts(monkeypatch):
    """Swap the JAX package's jitted multi counts functions for copies
    compiled with FAST_COMPILE (one executable per argument shape)."""
    def fast(jitted):
        cache = {}

        def call(*args):
            key = tuple((np.shape(x), str(np.asarray(x).dtype))
                        for x in jax.tree_util.tree_leaves(args))
            if key not in cache:
                cache[key] = jitted.lower(*args).compile(
                    compiler_options=FAST_COMPILE)
            return cache[key](*args)
        return call

    for name in ("_counts_pallas_multi_jit", "_counts_ckpt_multi_jit",
                 "_counts_pallas_multi_trials_jit",
                 "_counts_ckpt_multi_trials_jit"):
        monkeypatch.setattr(jc, name, fast(getattr(jc, name)))


@pytest.mark.parametrize("trials", [1, 2])
def test_train_em_multi_matches_jax(monkeypatch, trials):
    """train_em(multi=True), serial (trials=1) and lockstep (trials=2),
    against the JAX package's train_em with MARGINALIGN_MULTI=on: the same
    likelihood histories (rtol 1e-5) and trained parameters (atol 1e-4);
    every E-step batch of multi-problem lanes, P the job count."""
    kw = dict(trials=trials, iterations=3, tolerance=0.0, split_size=0,
              seed=5)
    _fast_jax_counts(monkeypatch)
    monkeypatch.setenv("MARGINALIGN_MULTI", "on")
    want = jem.train_em(_train_jobs(JaxJob), jem.EmOptions(**kw))
    monkeypatch.delenv("MARGINALIGN_MULTI")
    batches = []
    _recording(monkeypatch, em, "prepare_em_batches", batches)
    got = em.train_em(_train_jobs(RealignJob), em.EmOptions(**kw),
                      device="cpu", multi=True)
    assert [[(kind, n) for kind, _, n in b] for b in batches] == [
        [("multi", 7)]]
    hist = np.abs(np.subtract(got.likelihood_history,
                              want.likelihood_history))
    perr = max(np.abs(got.hmm.transitions - want.hmm.transitions).max(),
               np.abs(got.hmm.emissions - want.hmm.emissions).max())
    print("train_em multi trials=%d: histories max rel err %.3g, "
          "parameters max abs err %.3g"
          % (trials, (hist / np.abs(want.likelihood_history)).max(), perr))
    assert len(got.likelihood_history) == 3
    assert np.allclose(got.likelihood_history, want.likelihood_history,
                       rtol=1e-5, atol=0)
    assert perr <= 1e-4


def test_align_em_multi_matches_jax(tmp_path, monkeypatch):
    """pipeline.align(em=True, multi=True) on a 24-read synthetic tRNA
    corpus (2 iterations, 2 lockstep trials) against the JAX package's
    pipeline.align with MARGINALIGN_MULTI=on, trial 0 from the shipped
    model (a random start's first models align with gaps everywhere, and
    their MEA decodes are exact ties): the trained model within
    1e-4, the same guide placements, and every realigned cigar the JAX
    package's or an MEA near-tie of it (objective within 1e-5 relative
    under the JAX package's multi-lane posteriors; see
    tests/test_torch_multi_paths.py for why a few flip)."""
    tmp = str(tmp_path)
    fq, fa, truth = write_trna_corpus(tmp)
    emo = dict(iterations=2, trials=2, tolerance=0.0, seed=1,
               use_default_model_as_start=True)
    _fast_jax_counts(monkeypatch)
    mbs, posts = [], []
    with monkeypatch.context() as mp:
        mp.setenv("MARGINALIGN_MULTI", "on")
        _recording(mp, jband, "pack_multi_banded_batch", mbs)
        _recording(mp, fp, "posteriors_pallas_multi", posts)
        jsam = os.path.join(tmp, "jax.sam")
        want = jpipeline.align(fq, fa, jsam, jpipeline.AlignOptions(
            em=True, em_options=jem.EmOptions(**emo)))
    sam = os.path.join(tmp, "port.sam")
    model = os.path.join(tmp, "port.hmm")
    stages = pipeline.align(fq, fa, sam, pipeline.AlignOptions(
        em=True, output_model_path=model,
        em_options=em.EmOptions(**emo)), device="cpu", multi=True)
    assert {"guide_s", "chain_s", "em_s", "realign_s"} <= set(stages)
    got = PairHmm.load(model)
    perr = max(np.abs(got.transitions - want.transitions).max(),
               np.abs(got.emissions - want.emissions).max())
    assert perr <= 1e-4
    g = [line.split("\t") for line in _records(sam)]
    w = [line.split("\t") for line in _records(jsam)]
    assert [f[:5] for f in g] == [f[:5] for f in w]
    assert len(g) >= 0.75 * len(truth)
    mb, post = mbs[-1], np.asarray(posts[-1][1])
    assert len(posts) == 1 and len(mb.problems) == len(g)
    flips, worst = 0, 0.0
    for p, (a, b) in enumerate(zip(g, w)):
        if a[5] == b[5]:
            continue
        flips += 1
        dense = jband.unpack_problem(post, mb, p)
        best = mea_objective(_aligned_ops(b[5]), dense)
        worst = max(worst, (best - mea_objective(_aligned_ops(a[5]), dense))
                    / best)
    print("align em multi: trained model max abs err %.3g; %d of %d cigars "
          "differ, worst objective gap %.3g" % (perr, flips, len(g), worst))
    assert flips <= 0.15 * len(g)
    assert worst <= 1e-5


def test_band_updates_keep_multi_lanes(tmp_path, monkeypatch):
    """With update_band_every=1 and multi=True every E-step batch is of
    multi-problem lanes: the first, the one after each band update, and
    the one after a lockstep resume re-derives the band."""
    batches = []
    _recording(monkeypatch, em, "prepare_em_batches", batches)
    jobs = _train_jobs(RealignJob, n=6, seed=13)
    ck = str(tmp_path / "em.ckpt")
    opts = em.EmOptions(update_band_every=1, iterations=2, trials=2,
                        tolerance=0.0, split_size=0)
    em.train_em(jobs, opts, device="cpu", checkpoint_path=ck, multi=True)
    assert len(batches) == 3       # the first batches, then two updates
    opts.iterations = 3            # resume: band re-derived, one more step
    res = em.train_em(jobs, opts, device="cpu", checkpoint_path=ck,
                      multi=True)
    assert len(batches) == 3 + 3   # first, resume, one update
    assert len(res.likelihood_history) == 3
    for b in batches:
        assert [(kind, n) for kind, _, n in b] == [("multi", 6)]
