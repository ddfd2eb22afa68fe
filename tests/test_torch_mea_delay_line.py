"""The delay line of D's CUDA kernel (csrc/mea.cu `mea_dl_kernel`), checked
where there is no card.

The kernel holds each lane's band windows of gap weights in registers and
moves them from one anti-diagonal to the next: where the band's lower edge
steps (s1 = 1) the up window rolls up one row and the weight of read row
lo(d) + Wp - 1 enters at the top; where it does not (s1 = 0) the left
window rolls down and the weight of ref column d - lo(d) enters at row 0;
the windows are seeded from the closed form at d = 1 (and again wherever lo
moves by other than 0 or 1).  Its bit-equality with the plain version
rests on the windows holding exactly the closed-form weights that
`mea_dl_plain` builds (`mea_dl_gap_bands`) on every cell.  Here that
recurrence runs in numpy on bands from `ops/band.py` (`band_masks`) over
guided indel pairs, with reads whose band reaches past the sums' last rows
(the rgm - 1 / rgn - 1 clip) and sums past 1 (the weight's clip), and its
decode is held to the JAX package's `banded_mea_pallas_dl` (interpret
mode) on the same inputs.
"""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.wavefront_pallas import banded_mea_pallas_dl
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops.wavefront_cuda import (
    banded_mea_plain, mea_dl_gap_bands, mea_dl_plain,
)

GAP_GAMMA, MATCH_GAMMA = 0.5, 0.05


def _batch(rng, width):
    """A deletion and an insertion along their guide paths (the band steps
    and plateaus) and an unguided noisy pair, one read 256 bases long so
    that the band's top rows pass the 256 rows of the read sums."""
    x = rng.integers(0, 4, size=262).astype(np.int8)
    y = np.concatenate([x[:120], x[126:]])                  # 256 bases
    y[rng.random(len(y)) < 0.08] = 3
    pd, pi = jband.path_from_cigar([(0, 120), (2, 6), (0, 136)])
    x2 = rng.integers(0, 4, size=140).astype(np.int8)
    y2 = np.concatenate([x2[:70], rng.integers(0, 4, 11).astype(np.int8),
                         x2[70:]])
    pd2, pi2 = jband.path_from_cigar([(0, 70), (1, 11), (0, 70)])
    x3 = rng.integers(0, 4, size=90).astype(np.int8)
    y3 = x3[4:86].copy()
    y3[rng.random(len(y3)) < 0.15] = 1
    return tband.pack_banded_batch(
        [y, y2, y3], [x, x2, x3], width=width,
        paths=[(pd, pi), (pd2, pi2), None], pad_batch_to=4)


def _gap(sums):
    return np.float32(GAP_GAMMA) * np.clip(np.float32(1) - sums, 0, 1)


def delay_line(lo, accr, accc, Wp):
    """(wup, wleft) [D1, Wp, B] float32 from the kernel's recurrence; d = 0
    (which the decode never reads) holds zeros."""
    D1, B = lo.shape
    g_read, g_ref = _gap(accr), _gap(accc)
    lanes = np.arange(B)

    def up(i):     # closed form at read rows i [..., B]
        return np.where(i >= 1, g_read[np.clip(i - 1, 0, len(g_read) - 1),
                                       lanes], np.float32(0))

    def left(j):   # closed form at ref columns j [..., B]
        return np.where(j >= 1, g_ref[np.clip(j - 1, 0, len(g_ref) - 1),
                                      lanes], np.float32(0))

    k = np.arange(Wp)[:, None]
    wu = np.zeros((D1, Wp, B), np.float32)
    wl = np.zeros((D1, Wp, B), np.float32)
    for d in range(1, D1):
        l0 = lo[d]
        t1 = l0 - lo[d - 1]
        seed = np.full(B, d == 1) | ((t1 != 0) & (t1 != 1))
        rolled_up = np.roll(wu[d - 1], -1, axis=0)
        rolled_up[Wp - 1] = up(l0 + Wp - 1)
        rolled_left = np.roll(wl[d - 1], 1, axis=0)
        rolled_left[0] = left(d - l0)
        wu[d] = np.where(seed, up(l0 + k),
                         np.where(t1 == 1, rolled_up, wu[d - 1]))
        wl[d] = np.where(seed, left(d - l0 - k),
                         np.where(t1 == 0, rolled_left, wl[d - 1]))
    return wu, wl


@pytest.mark.parametrize("width", [21, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delay_line_holds_closed_form(seed, width):
    """The windows equal `mea_dl_gap_bands` on every cell of d >= 1 (every
    valid cell among them), the band reaches the sums' clip on valid cells,
    and the decode on them equals `mea_dl_plain` on every cell and the JAX
    package's delay-line kernel on every valid cell (scores within rtol
    1e-5, as tests/test_torch_realign_compact.py holds D's plain version to
    it)."""
    rng = np.random.default_rng(seed)
    batch = _batch(rng, width)
    D1, Wp, B = batch.valid.shape
    rgm = -(-int(batch.m.max()) // 256) * 256
    rgn = -(-int(batch.n.max()) // 256) * 256
    accr = (rng.random((rgm, B)) * 1.2).astype(np.float32)
    accc = (rng.random((rgn, B)) * 1.2).astype(np.float32)
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid * 0.9

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lo, m, n = t(batch.lo), t(batch.m), t(batch.n)
    valid, s1, s2 = tband.band_masks(lo, m, n, width, Wp)
    assert np.array_equal(valid.numpy(), batch.valid)
    wu, wl = delay_line(batch.lo, accr, accc, Wp)
    want_u, want_l = mea_dl_gap_bands(lo, t(accr), t(accc), GAP_GAMMA, Wp)
    assert np.array_equal(wu[1:], want_u.numpy()[1:])
    assert np.array_equal(wl[1:], want_l.numpy()[1:])
    i = batch.lo[:, None, :] + np.arange(Wp)[None, :, None]
    assert (batch.valid & (i - 1 >= rgm - 1)).any()

    wdiag = torch.where((t(post) >= MATCH_GAMMA) & (t(post) > 0), t(post),
                        -1e30)
    fd, fk = t(batch.final_d), t(batch.final_k)
    ptr, score = banded_mea_plain(wdiag, t(wu), t(wl), valid, s1, s2, fd, fk)
    plain_ptr, plain_score = mea_dl_plain(t(post), lo, m, n, width, fd, fk,
                                          t(accr), t(accc), GAP_GAMMA,
                                          MATCH_GAMMA)
    assert torch.equal(ptr, plain_ptr) and torch.equal(score, plain_score)
    want = banded_mea_pallas_dl(post, batch.lo, batch.m, batch.n, width,
                                batch.final_d, batch.final_k, accr, accc,
                                GAP_GAMMA, MATCH_GAMMA)
    v = batch.valid
    assert np.array_equal(ptr.numpy()[v], np.asarray(want.pointers)[v])
    assert np.allclose(score.numpy(), np.asarray(want.score), rtol=1e-5,
                       atol=1e-6)
