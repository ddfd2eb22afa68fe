"""The code windows of R's CUDA kernel (csrc/expand.cu `expand_rel_kernel`),
checked where there is no card.

The kernel gives a thread four lanes and a tile of R_TILE diagonals.  Row k
of diagonal d holds the read code at position lo(d) + k - 1 and the
reference code at d - lo(d) - k - 1 (clipped into the sequence), so per
lane and tile it stages the codes once into two windows, the reads
ascending from lmin - 1 and the reference descending from gmax - 1
(g = d - lo(d)), and reads rows k .. k + 3 of a diagonal as one funnel
shift of two window words at offset lo - lmin (reads) or gmax - g
(reference), up to Wp rounded up to four rows.  A lane whose tile spans
more words than the window holds (lo jumping) reads every code from the
sequences instead.  Its bit-equality with the plain version rests on the
window offsets landing on the closed-form positions on every cell and
the words staying inside what was staged.  Here that scheme runs in numpy
on `ops/band.py` compact batches at widths 21, 40 and 93, with one lane
whose lo jumps by 40 (so one of its tiles reads the sequences), held
equal to `expand_rel_plain` on every cell and to the JAX package's
`expand_rel_codes` (interpret mode) on the in-band cells of the batch as
packed.
"""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.fb_pallas import (
    compact_device_batch as jax_compact_device_batch,
    expand_rel_codes as jax_expand_rel_codes,
)
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops.fb_circ_cuda import expand_rel_plain

# csrc/expand.cu: diagonals a block, threads a block, lanes a thread.
R_TILE, R_THREADS, R_GROUP = 32, 64, 4


def rel_words(spread, Wp):
    """csrc/expand.cu `rel_words`."""
    return (spread >> 2) + ((Wp + 3) >> 2) + 1


def window_words(Wp):
    """csrc/expand.cu `rel_window_words`: 0 past 96 KB a block."""
    nw = rel_words(R_TILE - 1, Wp)
    return nw if 2 * R_GROUP * nw * R_THREADS * 4 <= 96 * 1024 else 0


def windows(reads, refs, lo, m, n, Wp, d1k):
    """(xb, yb) [d1k, Wp, B] int8 from the kernel's windows, and how many
    lane-tiles took the windows and how many read the sequences."""
    D1, B = lo.shape
    rows = np.arange(-(-Wp // 4) * 4)
    nw = window_words(Wp)
    xb = np.zeros((d1k, Wp, B), np.int8)
    yb = np.zeros((d1k, Wp, B), np.int8)
    used = {"window": 0, "direct": 0}
    for b in range(B):
        ycap, xcap = max(m[b] - 1, 0), max(n[b] - 1, 0)
        for d0 in range(0, d1k, R_TILE):
            ds = np.arange(d0, min(d0 + R_TILE, d1k))
            ls = lo[np.minimum(ds, D1 - 1), b].astype(np.int64)
            gs = ds - ls
            lmin, gmax = ls.min(), gs.max()
            ny = rel_words(ls.max() - lmin, Wp)
            nx = rel_words(gmax - gs.min(), Wp)
            if nw and ny <= nw and nx <= nw:
                used["window"] += 1
                wy = reads[np.clip(lmin - 1 + np.arange(4 * ny), 0, ycap), b]
                wx = refs[np.clip(gmax - 1 - np.arange(4 * nx), 0, xcap), b]
                for d, l, g in zip(ds, ls, gs):
                    oy, ox = l - lmin, gmax - g
                    # The last group's second word lies in the window.
                    assert (oy >> 2) + len(rows) // 4 < ny
                    assert (ox >> 2) + len(rows) // 4 < nx
                    yb[d, :, b] = wy[oy + rows][:Wp]
                    xb[d, :, b] = wx[ox + rows][:Wp]
            else:
                used["direct"] += 1
                for d, l, g in zip(ds, ls, gs):
                    k = np.arange(Wp)
                    yb[d, :, b] = reads[np.clip(l + k - 1, 0, ycap), b]
                    xb[d, :, b] = refs[np.clip(g - 1 - k, 0, xcap), b]
    return xb, yb, used


def _inputs(seed, width):
    """Guided deletion and insertion pairs, unguided noisy pairs (one
    5 x 8) and an N in a read: bands of ~180 diagonals, six tiles."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=96).astype(np.int8)
    y = np.concatenate([x[:30], x[42:]])
    x2 = rng.integers(0, 4, size=80).astype(np.int8)
    y2 = np.concatenate([x2[:35], rng.integers(0, 4, 9).astype(np.int8),
                         x2[35:]])
    x3 = rng.integers(0, 4, size=90).astype(np.int8)
    y3 = x3[3:88].copy()
    y3[rng.random(len(y3)) < 0.15] = 2
    y3[7] = 4
    reads = [y, y2, y3, rng.integers(0, 4, 5).astype(np.int8),
             rng.integers(0, 4, 64).astype(np.int8)]
    refs = [x, x2, x3, rng.integers(0, 4, 8).astype(np.int8),
            rng.integers(0, 4, 70).astype(np.int8)]
    paths = [jband.path_from_cigar([(0, 30), (2, 12), (0, 54)]),
             jband.path_from_cigar([(0, 35), (1, 9), (0, 45)]),
             None, None, None]
    comp_j = jband.pack_compact_batch(reads, refs, width=width, paths=paths,
                                      quantize=True)
    comp_t = tband.pack_compact_batch(reads, refs, width=width, paths=paths,
                                      quantize=True)
    full = tband.pack_banded_batch(reads, refs, width=width, paths=paths,
                                   quantize=True)
    return comp_j, comp_t, full


def _plain(comp, lo, d1k):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (comp.reads_p, comp.refs_p, lo.astype(np.int32),
          comp.m.astype(np.int32), comp.n.astype(np.int32))]
    return [a.numpy() for a in expand_rel_plain(*t, comp.wp, d1k)]


@pytest.mark.parametrize("width", [21, 40, 93])
def test_expand_rel_windows_match_plain_and_pallas(width):
    """The windows equal the plain version on every cell (lo
    edge-replicated past D1) and the Pallas kernel on in-band cells; with
    one lane's lo jumping by 40, that lane's tile reads the sequences and
    every cell still equals the plain version."""
    comp_j, comp, full = _inputs(5, width)
    D1 = comp.lo.shape[0]
    d1k = -(-D1 // 8) * 8 + 8
    args = (comp.reads_p, comp.refs_p, comp.lo, comp.m, comp.n, comp.wp,
            d1k)
    xb, yb, used = windows(*args)
    assert used == {"window": comp.batch * (-(-d1k // R_TILE)),
                    "direct": 0}
    pxb, pyb = _plain(comp, comp.lo, d1k)
    assert np.array_equal(xb, pxb) and np.array_equal(yb, pyb)

    xb_j, yb_j = (np.asarray(a) for a in jax_expand_rel_codes(
        jax_compact_device_batch(comp_j), d1k))
    v = np.zeros(xb_j.shape, bool)
    v[:full.num_steps] = full.valid
    assert v.sum() == comp.dp_cells() > 0
    assert np.array_equal(xb[v], xb_j[v]) and np.array_equal(yb[v], yb_j[v])

    lo = comp.lo.copy()
    lo[70:, 2] += 40
    jumped = (comp.reads_p, comp.refs_p, lo, comp.m, comp.n, comp.wp, d1k)
    xb, yb, used = windows(*jumped)
    assert used["direct"] >= 1 and used["window"] > 0
    pxb, pyb = _plain(comp, lo, d1k)
    assert np.array_equal(xb, pxb) and np.array_equal(yb, pyb)
