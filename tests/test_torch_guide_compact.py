"""The guide's compact device path: the port's plain version of the
expand_rel CUDA kernel (R) and its torch band masks vs the JAX package's
Pallas kernel `expand_rel_codes` (interpret mode) and `band_masks_device`,
and R + masks against the host band packer."""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.fb_pallas import (
    STEP_BLOCK, compact_device_batch as jax_compact_device_batch,
    expand_rel_codes as jax_expand_rel_codes,
)
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops.fb_circ import (
    compact_device_batch, expand_rel_codes,
)


def _inputs(seed, width):
    """Six pairs: a 12-base deletion and a 9-base insertion along their
    guide paths, unguided random pairs (one 5 x 8), an N in a read; the
    lane ladder pads the batch to 8 lanes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=90).astype(np.int8)
    y = np.concatenate([x[:30], x[42:]])
    x2 = rng.integers(0, 4, size=60).astype(np.int8)
    y2 = np.concatenate([x2[:35], rng.integers(0, 4, 9).astype(np.int8),
                         x2[35:]])
    reads = [y, y2, rng.integers(0, 4, 73).astype(np.int8),
             rng.integers(0, 4, 5).astype(np.int8),
             rng.integers(0, 4, 64).astype(np.int8),
             rng.integers(0, 4, 41).astype(np.int8)]
    refs = [x, x2, rng.integers(0, 4, 70).astype(np.int8),
            rng.integers(0, 4, 8).astype(np.int8),
            rng.integers(0, 4, 60).astype(np.int8),
            rng.integers(0, 4, 47).astype(np.int8)]
    reads[4][7] = 4
    paths = [jband.path_from_cigar([(0, 30), (2, 12), (0, 48)]),
             jband.path_from_cigar([(0, 35), (1, 9), (0, 25)]),
             None, None, None, None]
    comp_j = jband.pack_compact_batch(reads, refs, width=width, paths=paths,
                                      quantize=True)
    comp_t = tband.pack_compact_batch(reads, refs, width=width, paths=paths,
                                      quantize=True)
    full = tband.pack_banded_batch(reads, refs, width=width, paths=paths,
                                   quantize=True)
    return comp_j, comp_t, full


@pytest.mark.parametrize("width", [21, 40])
def test_expand_rel_plain_matches_pallas(width):
    """R's plain version equals the Pallas kernel (and the host packer) at
    every in-band cell; the Pallas kernel runs d1k = D1 rounded up to its
    step block."""
    comp_j, comp_t, full = _inputs(5, width)
    d1k = -(-comp_j.num_steps // STEP_BLOCK) * STEP_BLOCK
    xb_j, yb_j = (np.asarray(a) for a in
                  jax_expand_rel_codes(jax_compact_device_batch(comp_j), d1k))
    dev = compact_device_batch(comp_t, "cpu")
    xb, yb = expand_rel_codes(dev, comp_t.wp, d1k)
    assert xb.shape == (d1k, comp_t.wp, comp_t.batch) == xb_j.shape
    v = np.zeros(xb_j.shape, bool)
    v[: full.num_steps] = full.valid
    assert v.sum() == comp_t.dp_cells() > 0
    for got, want, host in ((xb, xb_j, full.xb), (yb, yb_j, full.yb)):
        got = got.numpy()
        assert np.array_equal(got[v], want[v])
        assert np.array_equal(got[: full.num_steps][full.valid],
                              host[full.valid])


@pytest.mark.parametrize("width", [21, 40])
def test_band_masks_match_jax_and_host(width):
    """valid, s1 and s2 from the offsets equal band_masks_device and the
    host packer's arrays exactly (padded lanes invalid everywhere)."""
    comp_j, comp_t, full = _inputs(6, width)
    want = [np.asarray(a) for a in jband.band_masks_device(
        comp_j.lo, comp_j.m, comp_j.n, width, comp_j.wp)]
    got = [t.numpy() for t in tband.band_masks(
        torch.from_numpy(comp_t.lo), torch.from_numpy(comp_t.m),
        torch.from_numpy(comp_t.n), width, comp_t.wp)]
    assert got[0].dtype == np.bool_
    for g, w, h in zip(got, want, (full.valid, full.s1, full.s2)):
        assert np.array_equal(g, w)
        assert np.array_equal(g, h)


@pytest.mark.parametrize("d1k_extra", [0, 16])
def test_circ_mw_streams_match_jax(d1k_extra):
    """fr, frr, lom from the offsets equal circ_mw_streams_device exactly,
    also past the packed diagonals (edge-replicated offsets)."""
    comp_j, comp_t, _ = _inputs(7, 21)
    d1k = comp_t.num_steps + d1k_extra
    want = [np.asarray(a) for a in jband.circ_mw_streams_device(
        comp_j.lo, 21, comp_j.wp, d1k)]
    got = tband.circ_mw_streams(torch.from_numpy(comp_t.lo), 21,
                                comp_t.wp, d1k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
