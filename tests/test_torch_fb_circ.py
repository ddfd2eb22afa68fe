"""Port circular-layout caller pass (plain versions of the sv_backward and
cx_forward CUDA kernels) vs the JAX package's Pallas kernels
`_sv_backward_call` and `_cx_from_es` (interpret mode), fed the same es /
yb / fr streams, for the gap-chain branch (the shipped model) and the
generic 5x5 branch (a flat-gap model whose gap states exchange mass), at
band widths 21 and 45 (Wp 24 and 48: one and two band rows a thread in
the warp-per-lane kernels)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu.ops.fb_pallas import (
    _cx_from_es, _expand_streams, _flat_gap_consts, _gap_chain_consts,
    _sv_backward_call, compact_device_batch, static_tables,
)
from marginalign_trna_tpu_torch.ops import fb_circ_cuda
from marginalign_trna_tpu_torch.ops.fb import tables_from_jax
from marginalign_trna_tpu_torch.ops.fb_circ import circ_coefficients

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")
def _batch(rng, width):
    """A 10-base deletion and a 9-base insertion along their guide paths,
    an unguided random pair, a 5 x 8 pair and padded lanes."""
    x = rng.integers(0, 4, size=80).astype(np.int8)
    y = np.concatenate([x[:40], x[50:]])
    y[rng.random(len(y)) < 0.1] = 2
    x3 = rng.integers(0, 4, size=33).astype(np.int8)
    y3 = np.concatenate([x3[:20], rng.integers(0, 4, 9).astype(np.int8),
                         x3[20:]])
    reads = [y, rng.integers(0, 4, 55).astype(np.int8), y3,
             rng.integers(0, 4, 5).astype(np.int8)]
    refs = [x, rng.integers(0, 4, 60).astype(np.int8), x3,
            rng.integers(0, 4, 8).astype(np.int8)]
    paths = [jband.path_from_cigar([(0, 40), (2, 10), (0, 30)]), None,
             jband.path_from_cigar([(0, 20), (1, 9), (0, 13)]), None]
    return jband.pack_compact_batch(reads, refs, width=width, paths=paths,
                                    quantize=True)


def _tables(chain: bool):
    tables = make_tables(PairHmm.load(MODEL))
    if not chain:
        # Move mass between gap states 1 and 2 (tests/test_circ.py).
        T = np.asarray(tables.T).copy()
        for s, t in ((1, 2), (2, 1)):
            T[s, t] = 0.05
        T = T / T.sum(axis=1, keepdims=True)
        tables = tables._replace(T=jnp.asarray(T))
    st = static_tables(tables)
    gc = _flat_gap_consts(st)
    assert (_gap_chain_consts(st, gc) is not None) == chain
    return tables, st, gc


@pytest.fixture(scope="module",
                params=[(True, 21), (False, 21), (True, 45), (False, 45)],
                ids=["chain", "mix", "chain-wp48", "mix-wp48"])
def case(request):
    chain, width = request.param
    jtables, st, gc = _tables(chain)
    comp = _batch(np.random.default_rng(8), width)
    d1k = -(-comp.num_steps // 8) * 8
    cdev = compact_device_batch(comp)
    es, yb, fr, _, _ = _expand_streams(st, cdev, width, d1k, want_yb=True)
    fink = cdev.fink.astype(jnp.int32)[None, :]
    find = cdev.final_d.astype(jnp.int32)[None, :]
    tables = tables_from_jax(jax.device_get(jtables))
    coef, is_chain = circ_coefficients(tables)
    assert is_chain == chain
    t = {name: torch.from_numpy(np.array(a)) for name, a in
         (("es", es), ("yb", yb), ("fr", fr))}
    t["fink"] = torch.from_numpy(np.asarray(cdev.fink, np.int32))
    t["find"] = torch.from_numpy(np.asarray(cdev.final_d, np.int32))
    return st, gc, (es, yb, fr, fink, find), coef, chain, t, comp


def test_sv_backward_plain_matches_pallas(case):
    st, gc, (es, _, _, fink, find), coef, chain, t, comp = case
    bm_j, bls_j, logZ_j = (np.asarray(a) for a in
                           _sv_backward_call(st, gc, es, fink, find))
    bm, bls, logZ = fb_circ_cuda.sv_backward_plain(coef, chain, t["es"],
                                                   t["fink"], t["find"])
    live = (comp.m + comp.n) > 0
    assert np.allclose(logZ.numpy()[live], logZ_j[live], rtol=1e-4,
                       atol=1e-4)
    assert np.allclose(bls.numpy(), bls_j[:, 0, :], rtol=2e-4, atol=1e-6)
    assert np.allclose(bm.numpy(), bm_j, rtol=2e-4, atol=1e-30)


def test_cx_forward_plain_matches_pallas(case):
    st, gc, (es, yb, fr, fink, find), coef, chain, t, comp = case
    logZ_j, fl_j, tails_j = (np.asarray(a) for a in
                             _cx_from_es(st, gc, es, yb, fink, find, fr))
    bm, bls, logZ = fb_circ_cuda.sv_backward_plain(coef, chain, t["es"],
                                                   t["fink"], t["find"])
    fl, tails = fb_circ_cuda.cx_forward_plain(coef, chain, t["es"], t["yb"],
                                              t["fr"], bm, bls, logZ)
    live = (comp.m + comp.n) > 0
    assert np.allclose(logZ.numpy()[live], logZ_j[live], rtol=1e-4,
                       atol=1e-4)
    assert fl.shape == fl_j.shape and tails.shape == tails_j.shape
    assert np.abs(fl.numpy() - fl_j).max() <= 2e-4
    assert np.abs(tails.numpy() - tails_j).max() <= 2e-4
    # The totals carry real mass: about one expected base per read base.
    total = fl.sum().item() + tails.sum().item()
    assert 0.8 * comp.m.sum() <= total <= 1.01 * comp.m.sum()
