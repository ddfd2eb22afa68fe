"""The unfused circular serving route (rows 11-14 and 20 of PERF.md's kernel
table): the port's circular stream helpers (ops/band.py
`circular_streams`, `circ_to_rel`, `circ_to_rel_device`,
`rel_to_circ_device`, ops/fb.py `circ_device_batch`) against the JAX
package's, and
`posteriors_circ` in each of the five serving modes on the CPU (the plain
versions of S, circ_backward_*, circ_post_* and the checkpoint pair)
against the JAX package's `posteriors_pallas_circ` in the same mode, in
interpret mode, on a gap-chain model (the shipped one) and on a flat-gap
model whose gap states 1 and 2 exchange mass (the kernels' generic 5x5
branch; tests/test_circ.py builds it the same way).  Tolerances
(tests/test_pallas.py, tests/test_circ.py): logZ rtol/atol 1e-4, in-band
posterior atol 2e-4, the modes against the port's own "em" 1e-6.  The JAX
functions compile without XLA's fusion pass, as in
tests/test_torch_em_counts.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm as JaxHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops.fb import circ_device_batch as jax_circ_batch
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import fb_circ_cuda as K
from marginalign_trna_tpu_torch.ops.fb import (
    circ_device_batch, device_batch, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_circ import (
    SERVE_MODES, circ_coefficients, posteriors_circ, posteriors_serve,
)

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")
FAST_COMPILE = {"xla_disable_hlo_passes": "fusion"}
MODELS = ("gap_chain", "non_chain")


def _batch(width=21):
    """A band of `width` (21: Wp 24): an 8-base deletion and a 6-base insertion
    along their guide paths (the band moves), an unguided noisy pair with
    an N, two short ragged pairs and padding lanes; D1 = 173 is a multiple
    of neither 8 nor 32, so the JAX kernels pad steps the port's do not
    run."""
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
    paths = [jband.path_from_cigar([(0, 40), (2, 8), (0, 42)]),
             jband.path_from_cigar([(0, 30), (1, 6), (0, 40)]), None, None,
             None]
    batch = jband.pack_banded_batch(reads, refs, width=width, paths=paths,
                                    pad_batch_to=8)
    assert batch.xb.shape[0] % 8 != 0
    return batch


def _jax_tables(model):
    """The JAX tables of the shipped model, or of its flat-gap variant
    whose gap states 1 and 2 exchange 0.05 (rows renormalised), which
    breaks the gap-chain pattern."""
    tables = make_tables(JaxHmm.load(MODEL))
    if model == "non_chain":
        T = np.asarray(tables.T).copy()
        for s, t in ((1, 2), (2, 1)):
            T[s, t] = 0.05
        T = T / T.sum(axis=1, keepdims=True)
        tables = tables._replace(T=jnp.asarray(T))
    return tables


@pytest.fixture(scope="module")
def case():
    batch = _batch()
    return {"batch": batch, "jcdev": jax_circ_batch(batch),
            "cdev": circ_device_batch(batch, device_batch(batch, "cpu"))}


@pytest.fixture(scope="module")
def ports(case):
    """Per model: the JAX tables and the port's (logZ, circular posterior)
    of every mode (plain versions)."""
    out = {}
    for model in MODELS:
        jtables = _jax_tables(model)
        tables = tables_from_jax(jax.device_get(jtables))
        chain = circ_coefficients(tables)[1]
        assert chain == (model == "gap_chain")
        out[model] = (jtables, {m: posteriors_circ(tables, case["cdev"], m)
                                for m in SERVE_MODES})
    return out


def test_circular_streams_match_jax(case):
    """circular_streams, circ_to_rel and circ_to_rel_device equal the JAX
    package's; circ_device_batch's streams, rotated on the device by
    rel_to_circ_device, equal the JAX package's host-rotated ones, and
    circ_to_rel_device undoes rel_to_circ_device."""
    batch = case["batch"]
    for got, want in zip(tband.circular_streams(batch),
                         jband.circular_streams(batch)):
        assert np.array_equal(got, want)
    cdev = case["cdev"]
    for name in ("xb", "yb", "valid", "final_d", "fink"):
        assert np.array_equal(getattr(cdev, name).numpy(),
                              np.asarray(getattr(case["jcdev"], name)))
    assert np.array_equal(cdev.lo.numpy(), batch.lo)
    vals = np.random.default_rng(3).random(batch.xb.shape).astype(np.float32)
    want = jband.circ_to_rel(vals, batch)
    assert np.array_equal(tband.circ_to_rel(vals, batch), want)
    lo = torch.from_numpy(batch.lo)
    rel = tband.circ_to_rel_device(torch.from_numpy(vals), lo)
    assert np.array_equal(
        rel.numpy(),
        np.asarray(jband.circ_to_rel_device(jnp.asarray(vals), batch.lo)))
    assert np.array_equal(tband.rel_to_circ_device(rel, lo).numpy(), vals)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", SERVE_MODES)
def test_posteriors_circ_matches_jax(case, ports, model, mode, monkeypatch):
    """posteriors_circ(mode) on the CPU vs `posteriors_pallas_circ(mode)`
    (its jitted body `_posteriors_circ_static`) in interpret mode: logZ on
    the live lanes within rtol/atol 1e-4, the posterior within atol 2e-4 on
    in-band cells and 0 elsewhere (both layouts circular; the JAX band's
    padded steps dropped as the JAX entry drops them).  "ckpt" runs at the
    JAX package's 32 diagonals per checkpoint on the gap-chain model and at
    8 on the other (its `_CKPT_BLOCK`; the unrolled 32-step pair takes
    ~27 s to compile here)."""
    if mode == "ckpt" and model == "non_chain":
        monkeypatch.setattr(fp, "_CKPT_BLOCK", 8)
    batch = case["batch"]
    jtables, got = ports[model]
    logZ, post = (t.numpy() for t in got[mode])
    st = fp.static_tables(jtables)
    jitted = fp._posteriors_circ_static.lower(
        st, case["jcdev"], mode=mode).compile(compiler_options=FAST_COMPILE)
    jlogZ, jpost = (np.asarray(a) for a in jitted(case["jcdev"]))
    assert post.shape == jpost.shape
    live = (batch.m + batch.n) > 0
    valid = case["cdev"].valid.numpy()
    lerr = float(np.abs(logZ - jlogZ)[live].max())
    perr = float(np.abs(post - jpost)[valid].max())
    print("%s, %s: logZ max abs err %.3g, posterior max abs err %.3g"
          % (model, mode, lerr, perr))
    assert np.allclose(logZ[live], jlogZ[live], rtol=1e-4, atol=1e-4)
    assert perr <= 2e-4
    assert np.abs(post[~valid]).max() <= 2e-4
    assert np.isfinite(post).all() and post.min() >= 0.0
    assert 0.0 < post.max() <= 1.0 + 1e-5


@pytest.mark.parametrize("model", MODELS)
def test_modes_match_em(ports, model):
    """Every mode computes what "em" does within 1e-6 (the JAX package's
    bound between its modes, tests/test_circ.py); the plain versions share
    one recursion and one emission lookup, so they agree exactly."""
    _, got = ports[model]
    logZ, post = got["em"]
    for mode in SERVE_MODES:
        lerr = (got[mode][0] - logZ).abs().max().item()
        perr = (got[mode][1] - post).abs().max().item()
        print("%s, %s vs em: logZ %.3g, posterior %.3g"
              % (model, mode, lerr, perr))
        assert torch.allclose(got[mode][0], logZ, rtol=1e-6, atol=1e-6)
        assert perr <= 1e-6


@pytest.mark.parametrize("kb", [8, 16, 32])
def test_ckpt_pair_replays_the_stored_backward(case, kb):
    """The checkpoint pair's plain versions at each block size: the
    posterior and logZ equal the codes pair's (lean) exactly, and the last
    checkpoint (the top block's entry) is the zero state."""
    cdev = case["cdev"]
    tables = tables_from_jax(jax.device_get(_jax_tables("gap_chain")))
    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.numpy().reshape(-1)
    valid = cdev.valid.view(torch.int8)
    args = (coef, chain, table, cdev.xb, cdev.yb, valid)
    bm, bls, logZ = K.circ_backward_codes_plain(*args, cdev.fink,
                                                cdev.final_d)
    want = K.circ_post_codes_plain(*args, bm, bls, logZ)
    ck, cs, clogZ = K.circ_ckpt_backward_plain(*args, cdev.fink,
                                               cdev.final_d, kb)
    d1k = cdev.xb.shape[0]
    assert ck.shape == (-(-d1k // kb), 6) + tuple(cdev.xb.shape[1:])
    assert torch.equal(ck[-1], torch.zeros_like(ck[-1]))
    assert torch.equal(cs[-1, 0], torch.zeros_like(cs[-1, 0]))
    assert torch.equal(cs[-1, 1], torch.ones_like(cs[-1, 1]))
    assert torch.equal(clogZ, logZ)
    post = K.circ_ckpt_post_plain(*args, cdev.fink, cdev.final_d, ck, cs,
                                  clogZ, kb)
    assert torch.equal(post, want)


def test_ckpt_block_fits_shared_memory():
    """32 diagonals per checkpoint at the shipped band (Wp 24), fewer where
    the replay would not fit 227 KB of shared memory, and 32 again with
    the replay in device memory where not even 8 fit."""
    assert K.ckpt_block(24) == 32
    assert K.ckpt_block(32) == 16
    assert K.ckpt_block(48) == 8
    assert K.ckpt_block(56) == 8 and K._replay_fits(56, 8)
    for Wp in (64, 128):
        assert K.ckpt_block(Wp) == 32 and not K._replay_fits(Wp, 32)


def test_ckpt_wide_band_matches_jax(monkeypatch):
    """At width 61 (Wp 64, the checkpoint posterior pass's replay in
    device memory on the card) "ckpt" on the CPU against the JAX package's
    "ckpt" route (at its 8 diagonals per checkpoint, to compile fast):
    logZ within rtol/atol 1e-4, the posterior within atol 2e-4; and the
    port's "ckpt" equal to its "lean".  posteriors_serve gives the same
    band in the band-relative layout."""
    monkeypatch.setattr(fp, "_CKPT_BLOCK", 8)
    batch = _batch(61)
    assert batch.xb.shape[1] == 64
    jtables = _jax_tables("gap_chain")
    tables = tables_from_jax(jax.device_get(jtables))
    dev = device_batch(batch, "cpu")
    cdev = circ_device_batch(batch, dev)
    logZ, post = posteriors_circ(tables, cdev, "ckpt")
    llogZ, lpost = posteriors_circ(tables, cdev, "lean")
    assert torch.equal(logZ, llogZ) and torch.equal(post, lpost)
    jcdev = jax_circ_batch(batch)
    jitted = fp._posteriors_circ_static.lower(
        fp.static_tables(jtables), jcdev, mode="ckpt").compile(
            compiler_options=FAST_COMPILE)
    jlogZ, jpost = (np.asarray(a) for a in jitted(jcdev))
    live = (batch.m + batch.n) > 0
    valid = cdev.valid.numpy()
    lerr = float(np.abs(logZ.numpy() - jlogZ)[live].max())
    perr = float(np.abs(post.numpy() - jpost)[valid].max())
    print("Wp 64, ckpt: logZ max abs err %.3g, posterior max abs err %.3g"
          % (lerr, perr))
    assert np.allclose(logZ.numpy()[live], jlogZ[live], rtol=1e-4, atol=1e-4)
    assert perr <= 2e-4
    slogZ, rel = posteriors_serve(tables, batch, dev, "ckpt")
    assert torch.equal(slogZ, logZ)
    assert torch.equal(rel, tband.circ_to_rel_device(post, cdev.lo))


def test_unknown_mode_raises(case):
    tables = tables_from_jax(jax.device_get(_jax_tables("gap_chain")))
    with pytest.raises(ValueError, match="serve"):
        posteriors_circ(tables, case["cdev"], "fused")
