"""Port flat-gap forward-backward (plain PyTorch version of the fb_backward
+ fb_forward CUDA kernels) vs the JAX package: the specialised Pallas
kernels (interpret mode), the XLA scan engine and the unbanded oracle."""
import os

import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import fb as jfb
from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.fb_pallas import posteriors_pallas_specialised
from marginalign_trna_tpu.ops.oracle import forward_backward_full
from marginalign_trna_tpu_torch.ops import fb_cuda
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, tables_from_hmm, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_generic_cuda import posteriors_generic

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu", "models", "last_hmm_20.txt")


def _batch(rng):
    """Width-21 band: a 10-base deletion along its guide path, a mutated
    copy with an insertion and an N, two short random pairs, padded lanes."""
    x = rng.integers(0, 4, size=80).astype(np.int8)
    y = np.concatenate([x[:40], x[50:]])
    z = np.concatenate([x[:30], rng.integers(0, 4, 4).astype(np.int8),
                        x[30:70]])
    z[rng.random(len(z)) < 0.1] = 1
    z[12] = 4
    reads = [y, z, rng.integers(0, 4, 9).astype(np.int8),
             rng.integers(0, 4, 15).astype(np.int8)]
    refs = [x, x[:70], rng.integers(0, 4, 12).astype(np.int8),
            rng.integers(0, 4, 13).astype(np.int8)]
    paths = [path_from_cigar([(0, 40), (2, 10), (0, 30)]),
             path_from_cigar([(0, 30), (1, 4), (0, 40)]), None, None]
    batch = pack_banded_batch(reads, refs, width=21, paths=paths,
                              pad_batch_to=8)
    return batch, reads, refs


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    hmm = PairHmm.load(MODEL)
    batch, reads, refs = _batch(rng)
    jtables = jfb.make_tables(hmm)
    tables = tables_from_jax(jax.device_get(jtables))
    logZ, post = fb_cuda.posteriors_pre_plain(tables,
                                              device_batch(batch, "cpu"))
    return (hmm, batch, jtables, tables, logZ.numpy(), post.numpy(),
            reads, refs)


def test_tables_from_jax_equal_tables_from_hmm(case):
    hmm, _, _, tables = case[:4]
    mine = tables_from_hmm(hmm)
    for name in ("T", "Ematch", "Egap", "pi"):
        assert torch.equal(getattr(mine, name), getattr(tables, name))


def test_fb_plain_matches_pallas_specialised(case):
    _, batch, jtables, _, logZ, post = case[:6]
    jlogZ, jpost = posteriors_pallas_specialised(
        jtables, jfb.device_batch(batch))
    n = int((batch.m + batch.n > 0).sum())
    assert np.allclose(logZ[:n], np.asarray(jlogZ)[:n], rtol=1e-4, atol=1e-4)
    assert np.allclose(post, np.asarray(jpost), atol=2e-4)


def test_fb_plain_matches_xla_engine(case):
    _, batch, jtables, _, logZ, post = case[:6]
    ref = jfb.forward_backward(jtables, jfb.device_batch(batch),
                               want_posteriors=True)
    n = int((batch.m + batch.n > 0).sum())
    assert np.allclose(logZ[:n], np.asarray(ref.logZ)[:n], rtol=1e-4,
                       atol=1e-4)
    ok = batch.valid
    assert np.allclose(post[ok], np.asarray(ref.posteriors)[ok], atol=2e-4)


def test_fb_plain_matches_oracle(case):
    """Lanes 2 and 3 are short enough for the band to cover the whole DP
    matrix, so the banded posteriors equal the unbanded oracle's."""
    hmm, batch, _, _, logZ, post, reads, refs = case
    for b in (2, 3):
        m, n = int(batch.m[b]), int(batch.n[b])
        assert not batch.lo[:, b].any()
        ref = forward_backward_full(hmm, refs[b], reads[b])
        assert np.allclose(logZ[b], ref.logZ, rtol=1e-4, atol=1e-4)
        got = np.array([[post[i + j, i, b] for j in range(1, n + 1)]
                        for i in range(1, m + 1)])
        assert np.allclose(got, ref.post_match, atol=2e-4)


def test_posteriors_pre_dispatch_on_cpu_is_the_plain_version(case):
    _, batch, _, tables, logZ, post = case[:6]
    got_logZ, got_post = fb_cuda.posteriors_pre(tables,
                                                device_batch(batch, "cpu"))
    assert np.array_equal(got_logZ.numpy(), logZ)
    assert np.array_equal(got_post.numpy(), post)


def test_non_flat_gap_model_is_refused(case):
    """posteriors_pre is the flat-gap pair's entry (K2/K3) and refuses a
    model whose gap rows are not flat; posteriors_specialised routes that
    model to the generic pair and returns what posteriors_generic does."""
    hmm = case[0].copy()
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    tables = tables_from_hmm(hmm)
    dev = device_batch(case[1], "cpu")
    assert fb_cuda.has_flat_gap_emissions(tables_from_hmm(case[0]))
    assert not fb_cuda.has_flat_gap_emissions(tables)
    with pytest.raises(ValueError, match="generic pair"):
        fb_cuda.posteriors_pre(tables, dev)
    logZ, post = fb_cuda.posteriors_specialised(tables, dev)
    want_logZ, want_post = posteriors_generic(tables, dev)
    assert torch.equal(logZ, want_logZ) and torch.equal(post, want_post)
    assert post.shape == case[5].shape
