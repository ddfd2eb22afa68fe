"""The generic forward-backward pair (rows 8 and 9 of PERF.md's kernel
table): the port's plain versions of fb_generic_fwd + fb_generic_bwd
(ops/fb_generic_cuda.py) vs the JAX package's `_run_forward` /
`_run_backward` in both of their variants, the model as run-time tables
(`posteriors_pallas`: `_fwd_kernel_dynamic`, `_bwd_kernel_dynamic`) and
baked in (the generic branch of `posteriors_pallas_specialised`:
`_make_fwd_kernel_static`, `_make_bwd_kernel_static`), in interpret mode,
on two models whose gap emissions are not flat; and, on the shipped flat
model, against the flat-gap pair's plain versions (K2/K3).  Tolerances
(tests/test_pallas.py): logZ rtol/atol 1e-4, posterior atol 2e-4.  The JAX
functions compile without XLA's fusion pass, as in
tests/test_torch_em_counts.py."""
import os

import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm as JaxHmm
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.align.em import _m_step
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import fb_counts, fb_cuda
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, tables_from_hmm, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_generic_cuda import (
    fb_generic_fwd_plain, posteriors_generic,
)

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")
FAST_COMPILE = {"xla_disable_hlo_passes": "fusion"}


def interpret(jitted, *args):
    """jitted(*args) (static arguments first), compiled with
    FAST_COMPILE; the compiled function takes the other arguments."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)


def _batch(width=21, lanes=8):
    """Width-21 band (Wp 24) unless `width` says otherwise: an 8-base
    deletion and a 6-base insertion along their guide paths (the band
    moves), an unguided noisy pair with an N, two short ragged pairs and
    padding lanes up to `lanes`; D1 = 173 is not a multiple of 8."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, size=90).astype(np.int8)
    y = np.concatenate([x[:40], x[48:]])
    y[rng.random(len(y)) < 0.1] = 3
    x2 = rng.integers(0, 4, size=70).astype(np.int8)
    y2 = np.concatenate([x2[:30], rng.integers(0, 4, 6).astype(np.int8),
                         x2[30:]])
    x3 = rng.integers(0, 4, size=50).astype(np.int8)
    y3 = x3[2:49].copy()
    y3[rng.random(len(y3)) < 0.15] = 1
    y3[7] = 4
    reads = [y, y2, y3, rng.integers(0, 4, 9).astype(np.int8),
             rng.integers(0, 4, 3).astype(np.int8)]
    refs = [x, x2, x3, rng.integers(0, 4, 12).astype(np.int8),
            rng.integers(0, 4, 5).astype(np.int8)]
    paths = [path_from_cigar([(0, 40), (2, 8), (0, 42)]),
             path_from_cigar([(0, 30), (1, 6), (0, 40)]), None, None, None]
    batch = pack_banded_batch(reads, refs, width=width, paths=paths,
                              pad_batch_to=lanes)
    assert batch.xb.shape[0] % 8 != 0
    return batch


def _perturbed_shipped():
    """The shipped model with its first gap state's emissions perturbed and
    renormalised."""
    hmm = PairHmm.load(MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    return hmm


def _random_after_m_step(batch):
    """A random fiveStateAsymmetric start after one M-step on the batch's
    expected counts: the per-base gap marginals the M-step writes."""
    hmm = PairHmm.random(seed=3)
    hmm.apply_model_type_constraints()
    _, tc, em, eg = fb_counts.fb_counts(tables_from_hmm(hmm),
                                        device_batch(batch, "cpu"))
    hmm = _m_step(hmm, tc.numpy().astype(np.float64),
                  em.numpy().astype(np.float64),
                  eg.numpy().astype(np.float64), True)
    hmm.apply_model_type_constraints()
    return hmm


MODELS = ("perturbed_shipped", "random_after_m_step")


@pytest.fixture(scope="module")
def case():
    """Per model: the JAX tables, the port's tables (the same floats) and
    the port's generic posteriors; plus the batch, its JAX device batch and
    the dynamic-table JAX functions compiled once."""
    batch = _batch()
    jdev = jax_device_batch(batch)
    out = {"batch": batch, "jdev": jdev}
    for name, hmm in (("perturbed_shipped", _perturbed_shipped()),
                      ("random_after_m_step", _random_after_m_step(batch))):
        jtables = make_tables(JaxHmm(hmm.transitions, hmm.emissions))
        tables = tables_from_jax(jax.device_get(jtables))
        assert not fb_cuda.has_flat_gap_emissions(tables)
        logZ, post = posteriors_generic(tables, device_batch(batch, "cpu"))
        out[name] = (jtables, tables, logZ.numpy(), post.numpy())
    jt = out[MODELS[0]][0]
    out["posteriors_pallas"] = interpret(fp._posteriors_pallas_jit, jt, jdev)
    out["run_forward"] = interpret(
        jax.jit(lambda t, b: fp._run_forward(t, b, None)), jt, jdev)
    return out


def _compare(batch, logZ, post, jlogZ, jpost, what):
    live = (batch.m + batch.n) > 0
    jlogZ, jpost = np.asarray(jlogZ), np.asarray(jpost)
    assert post.shape == jpost.shape
    lerr = float(np.abs(logZ - jlogZ)[live].max())
    perr = float(np.abs(post - jpost).max())
    print("%s: logZ max abs err %.3g, posterior max abs err %.3g"
          % (what, lerr, perr))
    assert np.allclose(logZ[live], jlogZ[live], rtol=1e-4, atol=1e-4)
    assert perr <= 2e-4
    assert np.isfinite(post).all() and post.min() >= 0.0
    assert 0.0 < post.max() <= 1.0 + 1e-5


@pytest.mark.parametrize("model", MODELS)
def test_generic_plain_matches_posteriors_pallas(case, model):
    """The dynamic-table variant (`posteriors_pallas`)."""
    jtables, _, logZ, post = case[model]
    jlogZ, jpost = case["posteriors_pallas"](jtables, case["jdev"])
    _compare(case["batch"], logZ, post, jlogZ, jpost,
             "posteriors_pallas, %s" % model)


@pytest.mark.parametrize("width,lanes", [(5, 8), (29, 8), (21, 13)])
def test_generic_plain_matches_posteriors_pallas_band_shapes(width, lanes):
    """The dynamic-table variant on the perturbed shipped model at Wp 8
    (width 5) and Wp 32 (width 29), the band widths the kernels take at
    their ends, and over 13 lanes, no multiple of the kernels' 8 or 16
    lanes a block."""
    batch = _batch(width, lanes)
    assert batch.xb.shape[1:] == ({5: 8, 29: 32, 21: 24}[width], lanes)
    hmm = _perturbed_shipped()
    jtables = make_tables(JaxHmm(hmm.transitions, hmm.emissions))
    tables = tables_from_jax(jax.device_get(jtables))
    logZ, post = posteriors_generic(tables, device_batch(batch, "cpu"))
    jdev = jax_device_batch(batch)
    jlogZ, jpost = interpret(fp._posteriors_pallas_jit, jtables, jdev)(
        jtables, jdev)
    _compare(batch, logZ.numpy(), post.numpy(), jlogZ, jpost,
             "posteriors_pallas, width %d, %d lanes" % (width, lanes))


@pytest.mark.parametrize("model", MODELS)
def test_generic_plain_matches_specialised_generic_branch(case, model):
    """The baked-table variant: `posteriors_pallas_specialised` takes its
    generic branch for these models."""
    jtables, _, logZ, post = case[model]
    st = fp.static_tables(jtables)
    assert fp._flat_gap_consts(st) is None
    jlogZ, jpost = interpret(fp._posteriors_pallas_static, st,
                             case["jdev"])(case["jdev"])
    _compare(case["batch"], logZ, post, jlogZ, jpost,
             "posteriors_pallas_specialised, %s" % model)


@pytest.mark.parametrize("model", MODELS)
def test_generic_forward_matches_run_forward(case, model):
    """fb_generic_fwd's plain version vs `_run_forward`: the scaled match
    plane F_match and the log-scales lsf over all D1K diagonals, and the
    terminal sums through logZ = log(term[final_d]) + lsf[final_d]."""
    batch = case["batch"]
    jtables, tables = case[model][:2]
    want = case["run_forward"](jtables, case["jdev"])
    xb, yb, valid, s1, fk, fd = fb_counts.kernel_inputs(
        device_batch(batch, "cpu"))
    fm, lsf, term = fb_generic_fwd_plain(tables.T, tables.Ematch,
                                         tables.Egap, xb, yb, valid, s1, fk)
    jfm, jlsf = np.asarray(want.F_match), np.asarray(want.lsf)
    assert fm.shape == jfm.shape and lsf.shape == jlsf.shape
    ferr = float(np.abs(fm.numpy() - jfm).max())
    lerr = float(np.abs(lsf.numpy() - jlsf).max())
    print("_run_forward, %s: F_match max abs err %.3g, lsf %.3g"
          % (model, ferr, lerr))
    assert np.allclose(fm.numpy(), jfm, rtol=1e-4, atol=1e-6)
    assert np.allclose(lsf.numpy(), jlsf, rtol=1e-5, atol=1e-4)
    logZ = fb_counts.logz_from_terminal(lsf[None], term[None], fd)[0]
    live = (batch.m + batch.n) > 0
    assert np.allclose(logZ.numpy()[live], np.asarray(want.logZ)[live],
                       rtol=1e-4, atol=1e-4)


def test_generic_pair_matches_flat_gap_pair_on_flat_model():
    """On the shipped (flat-gap) model the generic pair computes what the
    flat-gap pair does, by other arithmetic: logZ within 1e-4, posterior
    within 2e-4."""
    batch = _batch()
    dev = device_batch(batch, "cpu")
    tables = tables_from_hmm(PairHmm.load(MODEL))
    logZ, post = posteriors_generic(tables, dev)
    flogZ, fpost = fb_cuda.posteriors_pre_plain(tables, dev)
    live = torch.from_numpy((batch.m + batch.n) > 0)
    err = (post - fpost).abs().max().item()
    print("generic vs flat-gap pair: posterior max abs err %.3g" % err)
    assert torch.allclose(logZ[live], flogZ[live], rtol=1e-4, atol=1e-4)
    assert err <= 2e-4
