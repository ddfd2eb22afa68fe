"""The default (fused) realign path: the port's plain versions of the
mw_forward (M), scatter_lanes (L) and mea_dl (D) CUDA kernels, its row /
column sum assembly and `realigned_ops_for_jobs` vs the JAX package's
Pallas kernels `posteriors_weights_pallas_compact`, `bucket_scatter_chunked`
and `banded_mea_pallas_dl` (interpret mode), `rowcol_sums_from_flushed` and
its realignment with MARGINALIGN_KERNEL=pallas (compact streams, fused
realign, the accelerator default).  About 40 s on one CPU core."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.align import realign as jrealign
from marginalign_trna_tpu.models.hmm import PairHmm as JPairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.bucket_scatter import bucket_scatter_chunked
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu.ops.fb_pallas import (
    compact_device_batch as jax_compact_device_batch,
    posteriors_weights_pallas_compact,
)
from marginalign_trna_tpu.ops.mea import (
    rowcol_sums_from_flushed as jax_rowcol_sums,
)
from marginalign_trna_tpu.ops.wavefront_pallas import banded_mea_pallas_dl
from marginalign_trna_tpu_torch.align import realign as trealign
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops.bucket_scatter import scatter_lanes_plain
from marginalign_trna_tpu_torch.ops.fb import tables_from_jax
from marginalign_trna_tpu_torch.ops.fb_circ import (
    compact_device_batch, posteriors_weights_compact,
)
from marginalign_trna_tpu_torch.ops.mea import rowcol_sums_from_flushed
from marginalign_trna_tpu_torch.ops.wavefront_cuda import mea_dl_plain

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")
WIDTH = 21


def _pairs(rng):
    """A 10-base deletion and a 9-base insertion along their guide paths
    (the band steps and plateaus), an unguided noisy pair, a 5 x 8 pair."""
    x = rng.integers(0, 4, size=80).astype(np.int8)
    y = np.concatenate([x[:40], x[50:]])
    y[rng.random(len(y)) < 0.1] = 2
    x3 = rng.integers(0, 4, size=33).astype(np.int8)
    y3 = np.concatenate([x3[:20], rng.integers(0, 4, 9).astype(np.int8),
                         x3[20:]])
    x2 = rng.integers(0, 4, size=60).astype(np.int8)
    y2 = x2[3:58].copy()
    y2[rng.random(len(y2)) < 0.15] = 1
    reads = [y, y2, y3, rng.integers(0, 4, 5).astype(np.int8)]
    refs = [x, x2, x3, rng.integers(0, 4, 8).astype(np.int8)]
    paths = [jband.path_from_cigar([(0, 40), (2, 10), (0, 30)]), None,
             jband.path_from_cigar([(0, 20), (1, 9), (0, 13)]), None]
    return reads, refs, paths


@pytest.fixture(scope="module")
def fused():
    """The JAX package's fused realign pass and the port's (plain versions
    of E, S and M) on the same compact batch."""
    reads, refs, paths = _pairs(np.random.default_rng(8))
    comp_j = jband.pack_compact_batch(reads, refs, width=WIDTH, paths=paths,
                                      quantize=True)
    comp_t = tband.pack_compact_batch(reads, refs, width=WIDTH, paths=paths,
                                      quantize=True)
    jtables = make_tables(JPairHmm.load(MODEL))
    want = [np.asarray(a) for a in posteriors_weights_pallas_compact(
        jtables, jax_compact_device_batch(comp_j), WIDTH)]
    dev = compact_device_batch(comp_t, "cpu")
    got = posteriors_weights_compact(
        tables_from_jax(jax.device_get(jtables)), dev, WIDTH)
    return comp_j, comp_t, dev, want, got


def test_mw_forward_plain_matches_pallas(fused):
    """logZ rtol 1e-4, the band-relative posterior band atol 2e-4, the
    flushed sums and tails atol 2e-3 (the ROADMAP's FB tolerances)."""
    comp_j, comp_t, _, want, got = fused
    logZ_j, post_j, flc_j, flr_j, tc_j, tr_j = want
    logZ, post, flc, flr, tc, tr = (t.numpy() for t in got)
    live = (comp_t.m + comp_t.n) > 0
    assert np.allclose(logZ[live], logZ_j[live], rtol=1e-4, atol=1e-4)
    assert post.shape == post_j.shape == (comp_t.num_steps, comp_t.wp,
                                          comp_t.batch)
    assert np.abs(post - post_j).max() <= 2e-4
    for a, b in ((flc, flc_j), (flr, flr_j), (tc, tc_j), (tr, tr_j)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-3
    # The posterior carries real mass: about one match per aligned base.
    assert post.sum() > 0.5 * min(comp_t.m.sum(), comp_t.n.sum())


def test_rowcol_sums_match_jax(fused):
    """The port's assembly (fused_flush_jmaps / fused_row_jmaps + the
    plain L) vs the JAX package's scatter branch, on the same flush
    streams; and each position's sum equals its row / column of the
    posterior band."""
    comp_j, comp_t, dev, want, _ = fused
    _, post_j, flc, flr, tc, tr = want
    accr_j, accc_j = (np.asarray(a) for a in
                      jax_rowcol_sums(comp_j, flc, flr, tc, tr))
    accr, accc = rowcol_sums_from_flushed(
        comp_t, dev, *(torch.from_numpy(np.array(a))
                       for a in (flc, flr, tc, tr)))
    assert accr.shape == accr_j.shape and accc.shape == accc_j.shape
    assert np.abs(accr.numpy() - accr_j).max() <= 2e-3
    assert np.abs(accc.numpy() - accc_j).max() <= 2e-3
    # Direct sums over the band (cells with i >= 1 and j >= 1).
    D1, Wp, B = post_j.shape
    valid = tband.band_masks(dev.lo, dev.m, dev.n, WIDTH, Wp)[0].numpy()
    i = comp_t.lo[:, None, :] + np.arange(Wp)[None, :, None]
    j = np.arange(D1)[:, None, None] - i
    ok = valid & (i >= 1) & (j >= 1)
    for b in range(B):
        rows = np.zeros(accr.shape[0])
        cols = np.zeros(accc.shape[0])
        np.add.at(rows, i[:, :, b][ok[:, :, b]] - 1,
                  post_j[:, :, b][ok[:, :, b]])
        np.add.at(cols, j[:, :, b][ok[:, :, b]] - 1,
                  post_j[:, :, b][ok[:, :, b]])
        assert np.abs(rows - accr[:, b].numpy()).max() <= 2e-3
        assert np.abs(cols - accc[:, b].numpy()).max() <= 2e-3
    assert accr[:, 0].sum() > 0.5 * comp_t.m[0]


def _flush_tail(rng):
    """Targets that run up within the flushed rows and again within the
    tail rows, with -1 pads and a target past rg (the original case)."""
    D, Wp, B = 200, 24, 8
    jm = np.full((D + Wp, B), -1, np.int32)
    for b in range(B):
        flushed = np.sort(rng.choice(D, size=150, replace=False))
        jm[flushed, b] = np.arange(150) + b
        jm[D + rng.permutation(Wp)[:20], b] = 150 + b + np.arange(20)
    jm[3, 0] = 512 + 7                      # outside [0, rg): adds nowhere
    return jm


def _run_lengths(rng, D=603, B=37):
    """Runs of 1-17 equal targets per lane, so runs straddle the kernel's
    8-row chunks and 256-row tiles; D is a multiple of neither."""
    jm = np.full((D, B), -1, np.int32)
    for b in range(B):
        jm[:, b] = np.arange(D) // (1 + b % 17)
    jm[rng.random((D, B)) < 0.1] = -1
    return jm


def _edge_lanes(rng, D=603, B=37):
    """A lane of -1 only, a lane with one target over every row, a lane
    whose single run ends on a chunk edge, and lanes of increasing
    targets; B is not a multiple of 4 (the kernel's scalar loads)."""
    jm = np.tile((np.arange(D) // 3)[:, None], (1, B)).astype(np.int32)
    jm[:, 0] = -1
    jm[:, 1] = 77
    jm[:, 2] = np.where(np.arange(D) < 256, 5, -1)
    return jm


def _tail_back(rng, D=603, B=37, Wp=24):
    """Distinct increasing targets in the flushed rows, then Wp tail rows
    that go back over the last flushed targets in circular order."""
    jm = np.full((D, B), -1, np.int32)
    n = D - Wp
    for b in range(B):
        jm[:n, b] = np.arange(n) // 2 + b
        last = jm[n - 1, b]
        jm[n:, b] = last - (np.arange(Wp) + 7 * b) % Wp
    return jm


def _vector_lanes(rng):
    """The run-length case at B = 36: a multiple of 4 (the kernel's 16-byte
    loads) but not of the 16 lanes of a block."""
    return _run_lengths(rng, B=36)


@pytest.mark.parametrize("make", [_flush_tail, _run_lengths, _edge_lanes,
                                  _tail_back, _vector_lanes],
                         ids=lambda f: f.__name__.strip("_"))
def test_scatter_lanes_plain_matches_pallas(make):
    """L's plain version vs bucket_scatter_chunked (one channel, interpret
    mode) on the target streams L's chunked design must get right:
    runs straddling row chunks, D not a multiple of a chunk, a lane of -1,
    one target over every row, tail rows that go back, B not a multiple
    of 32: rtol 1e-5, and every targeted value counted once."""
    rng = np.random.default_rng(3)
    rg = 512
    jm = make(rng)
    Dt, B = jm.shape
    vals = rng.random((Dt, B)).astype(np.float32)
    got = scatter_lanes_plain(torch.from_numpy(vals), torch.from_numpy(jm),
                              rg)
    Dg = -(-Dt // 128) * 128
    vp = np.zeros((1, Dg, B), np.float32)
    vp[0, :Dt] = vals
    jp = np.full((Dg, B), -1, np.int32)
    jp[:Dt] = np.where(jm < rg, jm, -1)
    want = np.asarray(bucket_scatter_chunked(jnp.asarray(vp),
                                             jnp.asarray(jp), rg))[0]
    assert got.shape == want.shape == (rg, B)
    assert np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got.sum().item() == pytest.approx(
        vals[(jm >= 0) & (jm < rg)].sum(), rel=1e-5)


def test_mea_dl_plain_matches_pallas(rng):
    """D's plain version vs banded_mea_pallas_dl on the indel batch of
    tests/test_circ.py: pointers equal on every valid cell (rows k = 0 and
    cells with i = 0 or j = 0 included), scores rtol 1e-5."""
    n = 90
    x = rng.integers(0, 4, size=n).astype(np.int8)
    y = np.concatenate([x[:30], x[42:]])
    pd, pi = jband.path_from_cigar([(0, 30), (2, 12), (0, 48)])
    y2 = np.concatenate(
        [x[:50], rng.integers(0, 4, size=9).astype(np.int8), x[50:]])
    pd2, pi2 = jband.path_from_cigar([(0, 50), (1, 9), (0, 40)])
    x3 = rng.integers(0, 4, size=70).astype(np.int8)
    y3 = rng.integers(0, 4, size=64).astype(np.int8)
    batch = tband.pack_banded_batch(
        [y, y2, y3], [x, x, x3], width=WIDTH,
        paths=[(pd, pi), (pd2, pi2), None], pad_batch_to=4)
    D1, Wp, B = batch.valid.shape
    rgm = -(-int(batch.m.max()) // 256) * 256
    rgn = -(-int(batch.n.max()) // 256) * 256
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid * 0.9
    accr = rng.random((rgm, B)).astype(np.float32)
    accc = rng.random((rgn, B)).astype(np.float32)
    gap, mg = 0.5, 0.05
    want = banded_mea_pallas_dl(post, batch.lo, batch.m, batch.n, WIDTH,
                                batch.final_d, batch.final_k, accr, accc,
                                gap, mg)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ptr, score = mea_dl_plain(t(post), t(batch.lo), t(batch.m), t(batch.n),
                              WIDTH, t(batch.final_d), t(batch.final_k),
                              t(accr), t(accc), gap, mg)
    ptr_j = np.asarray(want.pointers)
    v = batch.valid
    assert ptr.shape == ptr_j.shape
    assert np.array_equal(ptr.numpy()[v], ptr_j[v])
    assert np.allclose(score.numpy(), np.asarray(want.score), rtol=1e-5,
                       atol=1e-6)
    i = batch.lo[:, None, :] + np.arange(Wp)[None, :, None]
    j = np.arange(D1)[:, None, None] - i
    assert (v & (i == 0)).any() and (v & (j == 0)).any()


def _jobs(rng, n_jobs=8):
    """Noisy reads (10% substitutions, 4% deletions, 4% insertions) of
    120-260 bases, each aligned to its window by its true cigar."""
    out = []
    for _ in range(n_jobs):
        ref = rng.integers(0, 4, size=int(rng.integers(120, 260)))
        read, cigar = [], []
        for base in ref:
            u = rng.random()
            if u < 0.04:
                cigar.append(2)
                continue
            read.append(base if rng.random() >= 0.1
                        else int(rng.integers(0, 4)))
            cigar.append(0)
            if u > 0.96:
                read.append(int(rng.integers(0, 4)))
                cigar.append(1)
        ops = []
        for op in cigar:
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + 1)
            else:
                ops.append((op, 1))
        out.append((np.asarray(read, np.int8), ref.astype(np.int8), ops))
    return out


@pytest.mark.parametrize("split_size", [0, 100])
def test_realigned_ops_match_jax(monkeypatch, split_size):
    """realigned_ops_for_jobs on the CPU (fused path) vs the JAX package's
    with MARGINALIGN_KERNEL=pallas: identical cigars, or at most one MEA
    tie flip."""
    monkeypatch.setenv("MARGINALIGN_KERNEL", "pallas")
    data = _jobs(np.random.default_rng(21))
    jjobs, tjobs = [], []
    for read, ref, ops in data:
        path = tband.path_from_cigar(ops)
        jjobs.append(jrealign.RealignJob(None, read, ref, path))
        tjobs.append(trealign.RealignJob(None, read, ref, path))
    want = jrealign.realigned_ops_for_jobs(
        jjobs, JPairHmm.load(MODEL), 0.5, 0.0, split_size=split_size)
    got = trealign.realigned_ops_for_jobs(
        tjobs, PairHmm.load(MODEL), 0.5, 0.0, "cpu", split_size=split_size)
    for ops, (read, ref, _) in zip(got, data):
        assert sum(ln for op, ln in ops if op != 2) == len(read)
        assert sum(ln for op, ln in ops if op != 1) == len(ref)
    flips = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
    print("jobs whose cigar differs from the JAX package's:", flips)
    assert len(flips) <= 1, flips
