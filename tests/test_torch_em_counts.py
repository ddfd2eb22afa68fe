"""The E-step counts kernels of one model: the port's plain versions of
counts_fwd_all + counts_bwd (stored pair) and counts_fwd_ckpt +
counts_bwd_ckpt (checkpoint pair), through ops/fb_counts.py `counts`, vs the
JAX package's `_counts_pallas_jit` and `_counts_ckpt_jit` in interpret mode
(rows 24 and 28 of PERF.md's kernel table), on a random fiveStateAsymmetric
model (non-flat gap emissions).  The tolerances are the JAX package's
(tests/test_pallas.py): logZ rtol/atol 1e-4, posterior atol 2e-4, counts
rtol/atol 1e-3.  The JAX functions compile without XLA's fusion pass
(`interpret`): on the CPU that pass takes most of a minute per
interpret-mode kernel and changes nothing but float32 rounding.  The
lockstep trials functions are in tests/test_torch_em_counts_trials.py."""
import jax
import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.ops import fb_counts
from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_jax

# XLA compile options for the interpret-mode kernels (see the docstring).
FAST_COMPILE = {"xla_disable_hlo_passes": "fusion"}


def interpret(jitted, *args):
    """jitted(*args), compiled with FAST_COMPILE."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def em_batch(seed=6, width=21):
    """Width-21 band (Wp 24) unless `width` says otherwise: a 7-base
    deletion and a 5-base insertion along their guide paths (the band
    moves), an unguided noisy pair, two short ragged pairs, and padding
    lanes; D1 = 130 is not a multiple of 8."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=68).astype(np.int8)
    y = np.concatenate([x[:30], x[37:]])
    y[rng.random(len(y)) < 0.1] = 2
    x2 = rng.integers(0, 4, size=50).astype(np.int8)
    y2 = np.concatenate([x2[:20], rng.integers(0, 4, 5).astype(np.int8),
                         x2[20:]])
    reads = [y, y2, rng.integers(0, 4, 40).astype(np.int8),
             rng.integers(0, 4, 9).astype(np.int8),
             rng.integers(0, 4, 3).astype(np.int8)]
    refs = [x, x2, rng.integers(0, 4, 39).astype(np.int8),
            rng.integers(0, 4, 12).astype(np.int8),
            rng.integers(0, 4, 5).astype(np.int8)]
    reads[2][rng.random(40) < 0.1] = 4
    paths = [path_from_cigar([(0, 30), (2, 7), (0, 31)]),
             path_from_cigar([(0, 20), (1, 5), (0, 30)]), None, None, None]
    batch = pack_banded_batch(reads, refs, width=width, paths=paths,
                              pad_batch_to=8)
    assert batch.xb.shape[0] % 8 != 0
    return batch


def em_model(seed=3):
    """A random start as EM draws it, under fiveStateAsymmetric
    constraints: every transition and non-flat gap emissions."""
    hmm = PairHmm.random(seed=seed)
    hmm.apply_model_type_constraints()
    return hmm


def compare(got, want, batch, want_em):
    """Port CountsResult vs the JAX one; returns the maxima seen."""
    n = 5
    logz = np.asarray(want.logZ)
    assert np.allclose(got.logZ.numpy()[..., :n], logz[..., :n], rtol=1e-4,
                       atol=1e-4)
    err = {"logZ": float(np.abs(got.logZ.numpy() - logz)[..., :n].max())}
    if want.posteriors is not None:
        post = np.asarray(want.posteriors)
        assert got.posteriors.shape == post.shape
        err["post"] = float(np.abs(got.posteriors.numpy() - post).max())
        assert err["post"] <= 2e-4
    else:
        assert got.posteriors is None
    got_em = got.emit_match
    if got_em is None:
        dev = device_batch(batch, "cpu")
        got_em = (fb_counts.match_counts_from_posteriors_trials(
            got.posteriors, dev) if got.posteriors.dim() == 4
            else fb_counts.match_counts_from_posteriors(got.posteriors, dev))
    for name, g, w in (("trans", got.trans_counts, want.trans_counts),
                       ("gap", got.emit_gap, want.emit_gap),
                       ("match", got_em, want_em)):
        w = np.asarray(w)
        assert np.allclose(g.numpy(), w, rtol=1e-3, atol=1e-3), name
        err[name] = float(np.abs(g.numpy() - w).max())
    return err


@pytest.fixture(scope="module")
def case():
    batch = em_batch()
    jtables = make_tables(em_model())
    return batch, jtables, tables_from_jax(jax.device_get(jtables))


def test_counts_stored_matches_pallas(case):
    """Row 24: `_counts_pallas_jit` vs counts(kernel="stored")."""
    batch, jtables, tables = case
    dev = jax_device_batch(batch)
    want = interpret(jc._counts_pallas_jit, jtables, dev)
    got = fb_counts.counts(tables, device_batch(batch, "cpu"),
                           kernel="stored")
    err = compare(got, want, batch,
                  jc.match_counts_from_posteriors(want.posteriors, dev))
    print("row 24 max abs err", err)


def test_counts_ckpt_matches_pallas(case):
    """Row 28: `_counts_ckpt_jit` vs counts(kernel="ckpt")."""
    batch, jtables, tables = case
    want = interpret(jc._counts_ckpt_jit, jtables, jax_device_batch(batch))
    got = fb_counts.counts(tables, device_batch(batch, "cpu"),
                           kernel="ckpt")
    err = compare(got, want, batch, want.emit_match)
    print("row 28 max abs err", err)


@pytest.mark.parametrize("width,wp", [(9, 16), (29, 32)])
def test_counts_ckpt_matches_pallas_band_widths(width, wp):
    """Row 28 at the narrowest and the widest band the counts kernels take
    (Wp 16 and Wp 32, the checkpoint backward's warp of band rows half and
    wholly used): `_counts_ckpt_jit` vs counts(kernel="ckpt")."""
    batch = em_batch(width=width)
    assert batch.xb.shape[1] == wp
    jtables = make_tables(em_model())
    tables = tables_from_jax(jax.device_get(jtables))
    want = interpret(jc._counts_ckpt_jit, jtables, jax_device_batch(batch))
    got = fb_counts.counts(tables, device_batch(batch, "cpu"),
                           kernel="ckpt")
    err = compare(got, want, batch, want.emit_match)
    print("row 28 width %d max abs err %s" % (width, err))
