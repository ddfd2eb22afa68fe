"""Port lane-summed scatter (plain version of the scatter_lanesum CUDA
kernel) and its target streams vs the JAX package: `fused_flush_jmaps_device`
and the Pallas kernel `bucket_scatter_lanesum` (interpret mode) on the JAX
package's group-aligned layout.  The port joins the flush and tail rows
without the TPU's 128-row group padding, so each comparison drops the JAX
layout's padding rows after checking that they add nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import bucket_scatter as jbs
from marginalign_trna_tpu.ops import expectations as jexp
from marginalign_trna_tpu_torch.ops import bucket_scatter as tbs
from marginalign_trna_tpu_torch.ops import expectations as texp

WIDTH = 21


def _without_group_pad(rows, d1k, wp):
    """The JAX layout's d1k flush rows and wp tail rows, without the
    padding rows between and after them (rows is [..., D, B])."""
    g = -(-d1k // jbs.GROUP) * jbs.GROUP
    return np.concatenate([rows[..., :d1k, :], rows[..., g:g + wp, :]],
                          axis=-2)


def _batch(rng, n_lanes):
    """Lanes of 30-300 bases around a shared reference, some with an
    indel, so lanes target overlapping global positions."""
    reads, refs, paths = [], [], []
    for _ in range(n_lanes):
        n = int(rng.integers(30, 300))
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        cut = n // 3
        read = np.concatenate([ref[:cut], ref[cut + 4:]])
        reads.append(read)
        refs.append(ref)
        paths.append(jband.path_from_cigar([(0, cut), (2, 4),
                                            (0, n - cut - 4)]))
    return jband.pack_compact_batch(reads, refs, width=WIDTH, paths=paths,
                                    quantize=True)


@pytest.fixture(scope="module", params=[3, 11], ids=["lanes3", "lanes11"])
def case(request):
    rng = np.random.default_rng(request.param)
    comp = _batch(rng, request.param)
    B = comp.batch
    total = 700
    off = np.zeros(B, np.int64)
    live = (comp.m + comp.n) > 0
    off[live] = rng.integers(0, total - comp.n[live])
    d1k = -(-comp.num_steps // 8) * 8
    return comp, off, total, d1k, rng


def test_flush_jmaps_match_jax(case):
    comp, off, _, d1k, _ = case
    want = np.asarray(jexp.fused_flush_jmaps_device(
        jnp.asarray(comp.lo), jnp.asarray(off), jnp.asarray(comp.n), WIDTH,
        comp.wp, d1k))
    jmap, jtail = texp.fused_flush_jmaps(
        torch.from_numpy(comp.lo), torch.from_numpy(off),
        torch.from_numpy(comp.n), WIDTH, comp.wp, d1k)
    g = -(-d1k // jbs.GROUP) * jbs.GROUP
    assert np.all(want[d1k:g] == -1)
    _, got = texp.concat_flush_tails(torch.zeros((1, d1k, comp.batch)),
                                     torch.zeros((1, comp.wp, comp.batch)),
                                     jmap, jtail)
    got = got.numpy()
    assert np.array_equal(got, _without_group_pad(want, d1k, comp.wp))
    # Every in-window position of a live lane is targeted exactly once.
    for b in np.flatnonzero(comp.n > 0):
        t = got[:, b]
        t = np.sort(t[t >= 0])
        assert np.array_equal(t, off[b] + np.arange(comp.n[b]))


def test_scatter_lanesum_plain_matches_pallas(case):
    """Values on every row (so -1 targets must add nothing), across the
    seam between the flush rows and the tail rows."""
    comp, off, total, d1k, rng = case
    rg = -(-total // 512) * 512
    jm = jexp.fused_flush_jmaps_device(
        jnp.asarray(comp.lo), jnp.asarray(off), jnp.asarray(comp.n), WIDTH,
        comp.wp, d1k)
    fl = rng.random((4, d1k, comp.batch)).astype(np.float32)
    tails = rng.random((4, comp.wp, comp.batch)).astype(np.float32)
    vals = jexp._concat_group_aligned_vals(jnp.asarray(fl),
                                          jnp.asarray(tails))
    vals_j, jm_j = jbs.pad_group_rows(vals, jm)
    want = np.asarray(jbs.bucket_scatter_lanesum(vals_j, jm_j, rg))

    g = -(-d1k // jbs.GROUP) * jbs.GROUP
    jm_j = np.asarray(jm_j)
    assert np.all(np.delete(jm_j, np.r_[:d1k, g:g + comp.wp], axis=0) == -1)
    jm = np.asarray(jm)
    vals_t, jm_t = texp.concat_flush_tails(
        torch.from_numpy(fl), torch.from_numpy(tails),
        torch.from_numpy(jm[:d1k].copy()), torch.from_numpy(jm[g:].copy()))
    assert np.array_equal(vals_t.numpy(),
                          _without_group_pad(np.asarray(vals_j), d1k, comp.wp))
    assert np.array_equal(jm_t.numpy(), _without_group_pad(jm_j, d1k, comp.wp))
    got = tbs.scatter_lanesum_plain(vals_t, jm_t, rg)
    assert got.shape == (rg, 4)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    # The -1 rows held values too; none of them reached the output.
    assert got.sum().item() < vals_t.sum().item()
