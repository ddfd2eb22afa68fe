"""Multi-problem lanes, module by module: the port's host packer, its
forward-backward pair (plain versions of fb_multi_forward /
fb_multi_backward), its guide Viterbi (plain nw_multi), MEA decode (plain
mea_multi) and per-position sums against the JAX package's
`pack_multi_banded_batch`, `posteriors_pallas_multi`,
`banded_nw_pallas_multi`, `mea_decode_multi` and `multi_band_expectations`
(Pallas in interpret mode), fed the same problems, for the gap-chain
branch (the shipped model made flat-gap) and the generic 5x5 branch (a
flat-gap model whose gap states 1 and 2 exchange mass)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import expectations as jexp
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops import mea as jmea
from marginalign_trna_tpu.ops import nw as jnw
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu.ops.wavefront_pallas import banded_nw_pallas_multi
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import fb_multi_cuda
from marginalign_trna_tpu_torch.ops import mea as tmea
from marginalign_trna_tpu_torch.ops import nw as tnw
from marginalign_trna_tpu_torch.ops.expectations import (
    multi_band_expectations,
)
from marginalign_trna_tpu_torch.ops.fb import (
    multi_device_batch, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_circ import circ_coefficients

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu", "models", "last_hmm_20.txt")
# The JAX multi pair compiles without XLA's fusion pass, as in
# tests/test_torch_em_counts.py (a long compile with it on this CPU).
FAST_COMPILE = {"xla_disable_hlo_passes": "fusion"}
NW_PARAMS = (1.0, -2.0, -3.0, -1.0)


def _noisy(rng, ref):
    """10% substitutions, 4% deletions, 4% insertions."""
    read = []
    for base in ref:
        u = rng.random()
        if u < 0.04:
            continue
        read.append(base if rng.random() >= 0.1 else int(rng.integers(0, 4)))
        if u > 0.96:
            read.append(int(rng.integers(0, 4)))
    return np.asarray(read, np.int8)


def _problems(rng, count, lo=8, hi=40):
    """Noisy read / ref pairs of lo..hi bases, one with a guide path that
    moves the band, and one empty-ish 2 x 3 pair."""
    refs = [rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
            for _ in range(count)]
    reads = [_noisy(rng, r) for r in refs]
    paths = [None] * count
    x = rng.integers(0, 4, size=hi).astype(np.int8)
    reads.append(np.concatenate([x[: hi // 2], x[hi // 2 + 6:]]))
    refs.append(x)
    paths.append(jband.path_from_cigar([(0, hi // 2), (2, 6),
                                        (0, hi - hi // 2 - 6)]))
    reads.append(rng.integers(0, 4, size=2).astype(np.int8))
    refs.append(rng.integers(0, 4, size=3).astype(np.int8))
    paths.append(None)
    return reads, refs, paths


def _hmm(chain: bool) -> JPairHmm:
    hmm = JPairHmm.load(MODEL)
    hmm.set_flat_indel_emissions()
    if not chain:
        T = np.asarray(hmm.transitions, np.float64).copy()
        for s, t in ((1, 2), (2, 1)):
            T[s, t] = 0.05
        hmm.transitions = T / T.sum(axis=1, keepdims=True)
    return hmm


def _posteriors_jax(tables, jmdev):
    st = fp.static_tables(tables)
    return fp._posteriors_multi_static.lower(st, jmdev).compile(
        compiler_options=FAST_COMPILE)(jmdev)


def _both(reads, refs, paths, width, pad_steps_to):
    jmb = jband.pack_multi_banded_batch(reads, refs, width=width,
                                        paths=paths,
                                        pad_steps_to=pad_steps_to)
    tmb = tband.pack_multi_banded_batch(reads, refs, width=width,
                                        paths=paths,
                                        pad_steps_to=pad_steps_to)
    return jmb, tmb


def test_pack_multi_banded_batch_matches_jax():
    """Every field of the port's packing equals the JAX package's, and
    lanes are really shared."""
    rng = np.random.default_rng(5)
    reads, refs, paths = _problems(rng, 12)
    jmb, tmb = _both(reads, refs, paths, 9, 96)
    for name in ("xb", "yb", "valid", "s1", "s2", "lo", "final_d", "final_k",
                 "m", "n", "start", "find", "fink_steps", "step_final",
                 "dloc"):
        assert np.array_equal(getattr(tmb, name), getattr(jmb, name)), name
    assert tmb.width == jmb.width
    assert [vars(p) for p in tmb.problems] == [vars(p) for p in jmb.problems]
    lanes = {p.lane for p in tmb.problems}
    assert len(lanes) < len(tmb.problems)
    # unpack_problem copies too.
    vals = rng.random(tmb.valid.shape).astype(np.float32)
    for p in range(len(reads)):
        assert np.array_equal(tband.unpack_problem(vals, tmb, p),
                              jband.unpack_problem(vals, jmb, p))


@pytest.fixture(scope="module", params=[True, False], ids=["chain", "mix"])
def fb_case(request):
    """The same packed problems through the JAX multi pair (interpret
    mode) and the port's plain pair."""
    chain = request.param
    rng = np.random.default_rng(21)
    reads, refs, paths = _problems(rng, 14)
    jmb, tmb = _both(reads, refs, paths, 9, 128)
    assert len({p.lane for p in tmb.problems}) < len(tmb.problems)
    jt = make_tables(_hmm(chain))
    logZ_j, post_j = (np.array(a) for a in
                      _posteriors_jax(jt, fp.multi_device_batch(jmb)))
    tables = tables_from_jax(jax.device_get(jt))
    assert circ_coefficients(tables)[1] == chain
    mdev = multi_device_batch(tmb, "cpu")
    logZ, post = fb_multi_cuda.posteriors_multi(tables, mdev)
    return jmb, tmb, mdev, (logZ_j, post_j), (logZ.numpy(), post.numpy())


def test_posteriors_multi_matches_pallas(fb_case):
    """logZ within rtol/atol 1e-4, the posterior band within 2e-4."""
    _, _, _, (logZ_j, post_j), (logZ, post) = fb_case
    assert np.isfinite(logZ).all()
    assert np.allclose(logZ, logZ_j, rtol=1e-4, atol=1e-4)
    assert np.abs(post - post_j).max() <= 2e-4


def test_posteriors_multi_kernel_streams(fb_case):
    """The forward's lsf changes only on the lane's rescale diagonals
    (d % 8 == 7, whatever problem holds them) and its terminal stream is
    nonzero only on terminal diagonals; the backward's posterior vanishes
    on spacer diagonals."""
    _, tmb, mdev, _, (logZ, post) = fb_case
    tables = tables_from_jax(jax.device_get(make_tables(_hmm(True))))
    coef, chain = circ_coefficients(tables)
    em = tables.Ematch[mdev.xb.long(), mdev.yb.long()] * mdev.valid
    _, lsf, term = fb_multi_cuda.fb_multi_forward_plain(
        coef, chain, em, mdev.valid, mdev.s1, mdev.start, mdev.fink)
    term = term.numpy()
    assert (term[tmb.find < 0] == 0).all()
    assert (term[tmb.find >= 0] > 0).all()
    steps = np.diff(lsf.numpy(), axis=0) != 0
    d = np.arange(1, lsf.shape[0])
    assert steps.any() and not steps[d % 8 != 7].any()
    spacer = ~tmb.valid.any(axis=1)
    assert (post.transpose(0, 2, 1)[spacer] == 0).all()


@pytest.mark.parametrize("width", [11, 40], ids=["Wp16", "Wp48"])
def test_banded_nw_multi_matches_pallas(width):
    """Pointers, final states and traceback_multi ops exact, scores within
    1e-5, at Wp 16 and at the guide's Wp 48."""
    rng = np.random.default_rng(30 + width)
    reads, refs, paths = _problems(rng, 10, 20, 50)
    jmb, tmb = _both(reads, refs, paths, width, 128)
    assert len({p.lane for p in tmb.problems}) < len(tmb.problems)
    jres = banded_nw_pallas_multi(jnp.asarray(NW_PARAMS, jnp.float32),
                                  fp.multi_device_batch(jmb))
    res = tnw.banded_nw_multi(tnw.NwParams(*NW_PARAMS),
                              multi_device_batch(tmb, "cpu"))
    jptr = np.asarray(jres.pointers)
    ptr = res.pointers.numpy()
    assert np.array_equal(ptr[tmb.valid], jptr[jmb.valid])
    assert np.array_equal(res.final_state.numpy(),
                          np.asarray(jres.final_state))
    assert np.allclose(res.score.numpy(), np.asarray(jres.score), atol=1e-5)
    for p in range(len(reads)):
        st = int(res.final_state[p])
        assert (tnw.traceback_multi(ptr, tmb, p, st)
                == jnw.traceback_multi(jptr, jmb, p, st)), p


def test_mea_decode_multi_matches_jax(fb_case):
    """mea_decode_multi fed the JAX posteriors: cigars identical to the
    JAX package's mea_decode_multi."""
    jmb, tmb, mdev, (_, post_j), _ = fb_case
    want = jmea.mea_decode_multi(post_j, jmb, 0.5, 0.0)
    got = tmea.mea_decode_multi(torch.from_numpy(post_j), tmb, mdev, 0.5,
                                0.0)
    assert got == want


def test_multi_band_expectations_match_jax(fb_case):
    """multi_band_expectations on one posterior band: within 1e-5 of the
    JAX package's."""
    _, tmb, mdev, (_, post_j), _ = fb_case
    P = len(tmb.problems)
    starts = np.cumsum([0] + [p.n + 3 for p in tmb.problems])[:P]
    total = int(starts[-1]) + tmb.problems[-1].n + 5
    want = np.zeros((total, 4))
    jexp.multi_band_expectations(post_j, tmb, starts, want)
    got = np.zeros((total, 4))
    multi_band_expectations(torch.from_numpy(post_j), tmb, mdev, starts, got)
    assert want.sum() > 1.0
    assert np.abs(got - want).max() <= 1e-5
