"""The E-step counts kernels with the lockstep trials axis: the port's plain
versions through ops/fb_counts.py `counts_trials` vs the JAX package's
`_counts_pallas_trials_jit` and `_counts_ckpt_trials_jit` in interpret
mode (rows 26 and 29 of PERF.md's kernel table), two trials sharing one
batch: a random fiveStateAsymmetric start (non-flat gap emissions) and the
shipped model with perturbed transitions.  Tolerances and compile options
as in tests/test_torch_em_counts.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marginalign_trna_tpu.align.em import make_tables_stacked
from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu_torch.ops import fb_counts
from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_jax

from test_torch_em_counts import compare, em_batch, em_model, interpret

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(12)
    shipped = PairHmm.load(MODEL)
    T = shipped.transitions * (0.8 + 0.4 * rng.random((5, 5)))
    shipped.transitions = T / T.sum(axis=1, keepdims=True)
    jtables = make_tables_stacked([em_model(), shipped])
    batch = em_batch()
    return batch, jtables, tables_from_jax(jax.device_get(jtables))


def test_counts_trials_stored_matches_pallas(case):
    """Row 26: `_counts_pallas_trials_jit` vs
    counts_trials(kernel="stored")."""
    batch, jtables, tables = case
    dev = jax_device_batch(batch)
    want = interpret(jc._counts_pallas_trials_jit, jtables, dev)
    got = fb_counts.counts_trials(tables, device_batch(batch, "cpu"),
                                  kernel="stored")
    assert got.logZ.shape == (2, batch.xb.shape[2])
    err = compare(got, want, batch,
                  jc.match_counts_from_posteriors_trials(want.posteriors,
                                                         dev))
    print("row 26 max abs err", err)


def test_counts_trials_ckpt_matches_pallas(case):
    """Row 29: `_counts_ckpt_trials_jit` vs counts_trials(kernel="ckpt")."""
    batch, jtables, tables = case
    want = interpret(jc._counts_ckpt_trials_jit, jtables,
                     jax_device_batch(batch))
    got = fb_counts.counts_trials(tables, device_batch(batch, "cpu"),
                                  kernel="ckpt")
    err = compare(got, want, batch, want.emit_match)
    print("row 29 max abs err", err)
    # The trials axis is independent: trial 1 alone gives its row.
    one = fb_counts.counts(tables_from_jax(jax.device_get(jc.FbTables(
        *(jnp.asarray(a)[1] for a in jtables)))), device_batch(batch, "cpu"),
        kernel="ckpt")
    assert np.array_equal(one.logZ.numpy(), got.logZ[1].numpy())
    assert np.allclose(one.trans_counts.numpy(), got.trans_counts[1].numpy(),
                       rtol=1e-6)
