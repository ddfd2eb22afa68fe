"""Baum-Welch EM over multi-problem lanes (marginAlign --em with
multi=True) on the CPU, through the plain versions of the four multi-lane
counts kernels (counts_multi_fwd_all + counts_multi_bwd, the stored pair;
counts_multi_fwd_ckpt + counts_multi_bwd_ckpt, the checkpoint pair), against
the JAX package's `_counts_pallas_multi_jit`, `_counts_ckpt_multi_jit` and
their lockstep-trials twins in interpret mode (rows 25, 27 and 30 of
PERF.md's kernel table); against the port's own single-lane counts of the
same problems; and the two pairs against each other.  Training and
marginAlign --em end to end are in tests/test_torch_em_multi_paths.py.

Lanes hold three or more problems (widths 9 and 21, lanes of 96 diagonals;
one problem too long for that raises D1 to a count that is not a multiple
of 8); the model is a random fiveStateAsymmetric start (non-flat gap
emissions).  The tolerances are the JAX package's (tests/test_multi.py,
tests/test_pallas.py): logZ rtol/atol 1e-4, posterior band atol 2e-4,
counts rtol/atol 1e-3.  The JAX functions compile without XLA's fusion
pass (FAST_COMPILE, as in tests/test_torch_em_counts.py)."""
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.align import em as jem
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import fb_counts
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, multi_device_batch, tables_from_jax,
)
from test_torch_em_counts import em_model, interpret

WIDTHS = (9, 21)
KERNELS = ("stored", "ckpt")
JAX_COUNTS = {"stored": jc._counts_pallas_multi_jit,
              "ckpt": jc._counts_ckpt_multi_jit}
JAX_COUNTS_TRIALS = {"stored": jc._counts_pallas_multi_trials_jit,
                     "ckpt": jc._counts_ckpt_multi_trials_jit}


def _noisy(rng, ref):
    """15% substitutions, 4% deletions, 4% insertions."""
    read = []
    for base in ref:
        u = rng.random()
        if u < 0.04:
            continue
        read.append(base if rng.random() >= 0.15 else int(rng.integers(0, 4)))
        if u > 0.96:
            read.append(int(rng.integers(0, 4)))
    return np.asarray(read, np.int8)


def _problems(width, seed=4):
    """Eleven short noisy pairs (unguided), one pair along a guide path
    through a 6-base deletion (the band moves) and, at width 21, one pair
    of 104 diagonals, too long for a 96-diagonal lane (D1 becomes 104 + 1,
    not a multiple of 8)."""
    rng = np.random.default_rng(seed + width)
    refs = [rng.integers(0, 4, size=int(rng.integers(6, 22))).astype(np.int8)
            for _ in range(11)]
    reads = [_noisy(rng, r) for r in refs]
    reads[3][2] = 4                      # an N in a read
    paths = [None] * len(refs)
    x = rng.integers(0, 4, size=30).astype(np.int8)
    reads.append(np.concatenate([x[:15], x[21:]]))
    refs.append(x)
    paths.append(jband.path_from_cigar([(0, 15), (2, 6), (0, 9)]))
    if width == 21:
        long_ref = rng.integers(0, 4, size=52).astype(np.int8)
        long_read = long_ref.copy()
        hit = rng.random(52) < 0.15
        long_read[hit] = rng.integers(0, 4, size=int(hit.sum()))
        refs.append(long_ref)
        reads.append(long_read)
        paths.append(None)
    return reads, refs, paths


@pytest.fixture(scope="module")
def cases():
    """Per width: the JAX and the port's packing of the same problems,
    both packages' device batches, and the model's tables."""
    jtables = make_tables(em_model())
    tables = tables_from_jax(jax.device_get(jtables))
    out = {}
    for width in WIDTHS:
        reads, refs, paths = _problems(width)
        kw = dict(width=width, paths=paths, pad_steps_to=96)
        jmb = jband.pack_multi_banded_batch(reads, refs, **kw)
        tmb = tband.pack_multi_banded_batch(reads, refs, **kw)
        per_lane = Counter(p.lane for p in tmb.problems)
        assert max(per_lane.values()) >= 3, per_lane
        out[width] = dict(reads=reads, refs=refs, paths=paths, jmb=jmb,
                          tmb=tmb, jmdev=fp.multi_device_batch(jmb),
                          mdev=multi_device_batch(tmb, "cpu"),
                          jtables=jtables, tables=tables)
    assert out[21]["tmb"].xb.shape[0] % 8 != 0
    return out


def _port_match(res, mdev):
    if res.emit_match is not None:
        return res.emit_match
    if res.posteriors.dim() == 4:
        return fb_counts.match_counts_from_posteriors_multi_trials(
            res.posteriors, mdev)
    return fb_counts.match_counts_from_posteriors_multi(res.posteriors, mdev)


def _jax_match(res, jmdev):
    if res.emit_match is not None:
        return res.emit_match
    if res.posteriors.ndim == 4:
        return jc.match_counts_from_posteriors_multi_trials(res.posteriors,
                                                            jmdev)
    return jc.match_counts_from_posteriors_multi(res.posteriors, jmdev)


def _compare(got, want, mdev, jmdev):
    """Port CountsResult vs the JAX one at the JAX package's tolerances;
    returns the maxima seen."""
    logz = np.asarray(want.logZ)
    assert got.logZ.shape == logz.shape
    assert np.allclose(got.logZ.numpy(), logz, rtol=1e-4, atol=1e-4)
    err = {"logZ": float(np.abs(got.logZ.numpy() - logz).max())}
    if want.posteriors is not None:
        post = np.asarray(want.posteriors)
        assert got.posteriors.shape == post.shape
        err["post"] = float(np.abs(got.posteriors.numpy() - post).max())
        assert err["post"] <= 2e-4
    else:
        assert got.posteriors is None
    for name, g, w in (("trans", got.trans_counts, want.trans_counts),
                       ("gap", got.emit_gap, want.emit_gap),
                       ("match", _port_match(got, mdev),
                        _jax_match(want, jmdev))):
        w = np.asarray(w)
        assert np.allclose(g.numpy(), w, rtol=1e-3, atol=1e-3), name
        err[name] = float(np.abs(g.numpy() - w).max())
    return err


@pytest.mark.parametrize("kernel", KERNELS)
def test_counts_multi_matches_pallas(cases, monkeypatch, kernel):
    """Rows 25 and 30, a serial trial: counts_multi(kernel=) against the
    pair the JAX package's policy picks under MARGINALIGN_EM_KERNEL, at
    width 9."""
    width = 9
    c = cases[width]
    monkeypatch.setenv("MARGINALIGN_EM_KERNEL", kernel)
    assert jc._use_ckpt(c["jmb"].xb.shape) == (kernel == "ckpt")
    want = interpret(JAX_COUNTS[kernel], c["jtables"], c["jmdev"])
    got = fb_counts.counts_multi(c["tables"], c["mdev"], kernel=kernel)
    err = _compare(got, want, c["mdev"], c["jmdev"])
    print("width %d %s: max abs err %s" % (width, kernel, err))


@pytest.mark.parametrize("kernel", KERNELS)
def test_counts_multi_trials_matches_pallas(cases, monkeypatch, kernel):
    """Rows 27 and 30, lockstep trials: counts_multi_trials with two models
    against `_counts_pallas_multi_trials_jit` /
    `_counts_ckpt_multi_trials_jit`, at width 21 (Wp 24, D1 not a multiple
    of 8)."""
    c = cases[21]
    monkeypatch.setenv("MARGINALIGN_EM_KERNEL", kernel)
    hmms = [em_model(3), em_model(8)]
    jtables = jem.make_tables_stacked(hmms)
    assert jc._use_ckpt(c["jmb"].xb.shape, ntr=2) == (kernel == "ckpt")
    want = interpret(JAX_COUNTS_TRIALS[kernel], jtables, c["jmdev"])
    got = fb_counts.counts_multi_trials(
        tables_from_jax(jax.device_get(jtables)), c["mdev"], kernel=kernel)
    err = _compare(got, want, c["mdev"], c["jmdev"])
    print("trials %s: max abs err %s" % (kernel, err))


def test_counts_multi_ckpt_matches_pallas_widest_band():
    """Row 30, a serial trial at width 29 (Wp 32, every band row of the
    checkpoint backward's warp used): counts_multi(kernel="ckpt") against
    `_counts_ckpt_multi_jit`."""
    reads, refs, paths = _problems(29)
    kw = dict(width=29, paths=paths, pad_steps_to=96)
    jmb = jband.pack_multi_banded_batch(reads, refs, **kw)
    tmb = tband.pack_multi_banded_batch(reads, refs, **kw)
    assert tmb.xb.shape[1] == 32
    jtables = make_tables(em_model())
    jmdev = fp.multi_device_batch(jmb)
    mdev = multi_device_batch(tmb, "cpu")
    want = interpret(jc._counts_ckpt_multi_jit, jtables, jmdev)
    got = fb_counts.counts_multi(tables_from_jax(jax.device_get(jtables)),
                                 mdev, kernel="ckpt")
    err = _compare(got, want, mdev, jmdev)
    print("width 29 ckpt: max abs err %s" % err)


def _counts_arrays(res, mdev):
    return {"trans": res.trans_counts.numpy(), "gap": res.emit_gap.numpy(),
            "match": _port_match(res, mdev).numpy()}


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("width", WIDTHS)
def test_counts_multi_match_single_lanes(cases, width, kernel):
    """The engine check (the JAX package's test_multi_counts_match_engine):
    the multi-lane counts equal the port's single-lane counts of the same
    problems, one problem per lane, and each problem's logZ its lane's."""
    c = cases[width]
    got = fb_counts.counts_multi(c["tables"], c["mdev"], kernel=kernel)
    batch = tband.pack_banded_batch(c["reads"], c["refs"], width=width,
                                    paths=c["paths"])
    single = fb_counts.counts(c["tables"], device_batch(batch, "cpu"),
                              kernel=kernel)
    n = len(c["reads"])
    assert np.allclose(got.logZ.numpy(), single.logZ.numpy()[:n],
                       rtol=1e-4, atol=1e-3)
    want = {"trans": single.trans_counts.numpy(),
            "gap": single.emit_gap.numpy(),
            "match": (single.emit_match.numpy()
                      if single.emit_match is not None else
                      fb_counts.match_counts_from_posteriors(
                          single.posteriors,
                          device_batch(batch, "cpu")).numpy())}
    for name, g in _counts_arrays(got, c["mdev"]).items():
        assert np.allclose(g, want[name], rtol=1e-3, atol=1e-3), name
    print("width %d %s: logZ max abs err against single lanes %.3g" % (
        width, kernel, np.abs(got.logZ.numpy()
                              - single.logZ.numpy()[:n]).max()))


@pytest.mark.parametrize("width", WIDTHS)
def test_counts_multi_pairs_agree(cases, width):
    """The stored pair (match counts reduced from the posterior band,
    masked at every problem's first diagonal) and the checkpoint pair
    (match counts folded in the kernel with the same mask) count the same,
    within 1e-5 of the largest count; the same logZ."""
    c = cases[width]
    stored = fb_counts.counts_multi(c["tables"], c["mdev"], kernel="stored")
    ckpt = fb_counts.counts_multi(c["tables"], c["mdev"], kernel="ckpt")
    assert torch.equal(stored.logZ, ckpt.logZ)
    a, b = _counts_arrays(stored, c["mdev"]), _counts_arrays(ckpt, c["mdev"])
    for name in a:
        rel = np.abs(a[name] - b[name]).max() / np.abs(b[name]).max()
        print("width %d %s counts: pairs differ by %.3g (relative)"
              % (width, name, rel))
        assert rel <= 1e-5, name
