"""The tile scheme of the REL forward-backward pair's CUDA kernels, checked
where there is no card: csrc/fb.cu `rel_backward_kernel` (K2, fb_backward)
and `rel_forward_kernel` (K3, fb_forward).

Each kernel gives a lane a warp, `ceil(Wp / 32)` consecutive band rows a
thread (mk::WarpRows), the frontier in registers: K2 the gap states of
d + 1 and e_M * b_M of d + 1 and d + 2, K3 the gap mixes of d - 1 and the
match mixes of d - 1 and d - 2.  Every read of an earlier generation moves
the band by the same s1 / s2 shift for all of a lane's rows (the plain
versions' `shift`: one row for a shift of +-1, wrapping at Wp, none for
any other), so it is a shuffle (`RelLane::move`).  A block of LPB lanes
stages tiles of KT diagonals (16 at one row a thread, else 8: whole
rescale periods) of its lanes in shared memory, K2 from the top down and
K3 from d = 0 up: the float bands (em; K3 also bm) either as the tensor
memory accelerator copies them (the box [KT][Wp][LPB] lanes fastest, zeros
out of bounds, swizzled) or by cp.async (per-lane rows at an odd stride),
valid as a byte tile lanes fastest, s1 (and K3's bls) as [LPB][KT].  The
rescale takes the band max over the lane's rows in the band and its five
states (K2 at each period's low end, K3 at its high end); K3 computes the
posterior's scale exp(ls + bls - logZ) of a period's diagonals when the
period starts and again after its last diagonal's rescale.  bm (K2) and
post (K3) leave through an output tile as lane rows.
Their bit-equality with the plain versions rests on those offsets, on the
moves' source rows, on the scales computed ahead and on the order of the
arithmetic.  Here the scheme runs in torch (float32, the kernels' order of
operations), a block of LPB lanes at a time with the lanes past B idle,
each warp's 32 threads as a tensor axis.

The model is held bit for bit to the plain versions (bm, bls, logZ, post)
at one to four rows a thread, 8 and 16 lanes a block, both staging
layouts, over lane counts that are no multiple of either and diagonal
counts that are no multiple of a tile, on random bands and shifts (every
move of `shift`), terminals at d = 0 and lanes with no valid cell; and, on
packed synthetic reads, to the JAX package's `posteriors_pallas_specialised`
in interpret mode (logZ rtol / atol 1e-4, posteriors atol 2e-4, the JAX
tests' tolerances).
"""
import os

import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import fb as jfb
from marginalign_trna_tpu.ops.fb_pallas import posteriors_pallas_specialised
from marginalign_trna_tpu_torch.ops import fb_cuda
from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_jax

from test_torch_fb import _batch as packed_batch
from test_torch_mea_warp_tiles import roll, stage_plane, swizzled
from test_torch_warp_tiles import byte_stride, stage_bytes

F32 = torch.float32
MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu", "models", "last_hmm_20.txt")


def rel_kt(rpt):
    """csrc/fb_rel.cuh `rel_kt`: diagonals a tile."""
    return 16 if rpt == 1 else 8


def move(v, t, wp, rpt):
    """RelLane::move over a block: row k + t of v [LPB, 32, RPT] for the
    shift t [LPB] of each lane's warp: one row for t = +-1, wrapping at Wp,
    in place for any other t."""
    return roll(v, torch.where(t == 1, 1, torch.where(t == -1, -1, 0)), wp,
                rpt)


class Block:
    """The layout of one block of LPB lanes: each warp's rows, where a
    row's cell of tile diagonal kb lies in a stage plane, its valid byte,
    and the output tile's lane rows."""

    def __init__(self, D1, wp, B, b0, lpb, tma):
        self.wp, self.lpb, self.tma = wp, lpb, tma
        self.rpt = (wp + 31) // 32
        self.kt = rel_kt(self.rpt)
        self.nl = min(lpb, B - b0)
        self.b0 = b0
        kk = torch.arange(32)
        self.rows = (self.rpt * kk[:, None]
                     + torch.arange(self.rpt)[None, :])[None]  # [1, 32, R]
        self.inband = self.rows < wp
        self.k = self.rows.clamp(max=wp - 1)
        self.w = torch.arange(lpb)[:, None, None]
        self.stride = self.kt * wp + 1

    def at(self, kb):
        """RelLane::at: the plane offsets of the rows at tile diagonal kb."""
        q = kb * self.wp + self.k
        return (swizzled(q, self.w, self.lpb) if self.tma
                else self.w * self.stride + q)

    def valid(self, v_t, kb):
        """RelLane::valid from the byte tile."""
        q = (kb * self.wp + self.k) * byte_stride(self.lpb) + self.w
        return torch.from_numpy(v_t[q.numpy()] != 0).to(F32)

    def records(self, stream, d0, n):
        """A [D1, B] stream's records of the tile, [LPB, KT] (lanes past B
        and diagonals past the tile hold 0)."""
        rec = torch.zeros(self.lpb, self.kt, dtype=stream.dtype)
        rec[:self.nl, :n] = stream[d0:d0 + n, self.b0:self.b0 + self.nl].T
        return rec

    def emit(self, out, kb, vals):
        """The rows in the band of vals [LPB, 32, R] into the output tile
        at tile diagonal kb."""
        cell = (self.w * self.stride + kb * self.wp + self.rows).expand(
            vals.shape)
        at = self.inband.expand(vals.shape)
        out[cell[at]] = vals[at]

    def flush(self, out, band, d0, n):
        """rel_flush: the output tile's rows of the lanes in B to band."""
        for w in range(self.nl):
            band[d0:d0 + n, :, self.b0 + w] = out[
                w * self.stride:w * self.stride + n * self.wp].reshape(
                    n, self.wp)

    def band_max(self, vals):
        """rescale's factor: the max over the rows in the band and the five
        states, 0 where none is positive, then 1 for no mass."""
        m = torch.stack(vals).where(self.inband, 0.0).amax(dim=(0, 2, 3))
        m = torch.clamp(m, min=0.0)
        return torch.where(m > 0, m, torch.ones_like(m))


def rel_backward_tiles(coef, em, valid, s1, final_d, final_k, lpb=8,
                       tma=True):
    """(bm [D1, Wp, B], bls [D1, B], logZ [B]) as rel_backward_kernel
    computes them, block by block."""
    D1, wp, B = em.shape
    A = [[float(coef[s, u]) for u in range(5)] for s in range(5)]
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    bm = torch.full((D1, wp, B), float("nan"), dtype=F32)
    bls_out = torch.full((D1, B), float("nan"), dtype=F32)
    logZ = torch.full((B,), float("nan"), dtype=F32)
    for b0 in range(0, B, lpb):
        blk = Block(D1, wp, B, b0, lpb, tma)
        kt, nl, rpt = blk.kt, blk.nl, blk.rpt
        fd = torch.full((lpb, 1, 1), -1)
        fk = torch.full((lpb, 1, 1), -1)
        fd[:nl, 0, 0] = final_d[b0:b0 + nl].long()
        fk[:nl, 0, 0] = final_k[b0:b0 + nl].long()
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        p1, p2, g = zero, zero, [zero] * 4
        bls = torch.zeros(lpb, dtype=F32)
        cprev = torch.ones(lpb, dtype=F32)
        sh1 = sh2 = torch.zeros(lpb, dtype=torch.int32)
        tiles = (D1 + kt - 1) // kt
        for u in range(tiles):
            d0 = (tiles - 1 - u) * kt
            n = min(kt, D1 - d0)
            plane = stage_plane(em, d0, kt, b0, lpb, tma)
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            s1_t = blk.records(s1, d0, n)
            out = torch.full((lpb * blk.stride,), float("nan"), dtype=F32)
            obls = torch.zeros(lpb, kt, dtype=F32)
            for kb in range(n - 1, -1, -1):
                d = d0 + kb
                e, v = plane[blk.at(kb)], blk.valid(v_t, kb)
                x = [move(p2, 1 - (sh1 + sh2), wp, rpt)] + [
                    move(g[q], (q & 1) - sh1, wp, rpt) for q in range(4)]
                if kb % 8 == 7:
                    x[0] = x[0] / cprev[:, None, None]
                inj = ((d == fd) & (blk.rows == fk)).to(F32)
                new = []
                for s in range(5):
                    acc = A[s][0] * x[0]
                    for t in range(1, 5):
                        acc = acc + A[s][t] * x[t]
                    new.append((acc + inj) * v)
                sh2, sh1 = sh1, s1_t[:, kb]
                if kb % 8 == 0:
                    c = blk.band_max(new)
                    inv = 1.0 / c
                    new = [y * inv[:, None, None] for y in new]
                    bls = bls + torch.log(c)
                    cprev = c
                blk.emit(out, kb, new[0])
                obls[:, kb] = bls
                p2, p1 = p1, e * new[0]
                g = new[1:]
            blk.flush(out, bm, d0, n)
            bls_out[d0:d0 + n, b0:b0 + nl] = obls[:nl, :n].T
        # Row 0 is r = 0 of thread 0.
        z = 0.2 * ((((new[0][:, 0, 0] + new[1][:, 0, 0]) + new[2][:, 0, 0])
                    + new[3][:, 0, 0]) + new[4][:, 0, 0])
        logZ[b0:b0 + nl] = (torch.log(torch.clamp(z, min=1e-30)) + bls)[:nl]
    return bm, bls_out, logZ


def rel_forward_tiles(coef, em, valid, s1, bm, bls, logZ, lpb=8, tma=True):
    """The posterior band [D1, Wp, B] as rel_forward_kernel computes it,
    block by block."""
    D1, wp, B = em.shape
    A = [[float(coef[s, u]) for u in range(5)] for s in range(5)]
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    post = torch.full((D1, wp, B), float("nan"), dtype=F32)
    for b0 in range(0, B, lpb):
        blk = Block(D1, wp, B, b0, lpb, tma)
        kt, nl, rpt = blk.kt, blk.nl, blk.rpt
        lz = torch.zeros(lpb, dtype=F32)
        lz[:nl] = logZ[b0:b0 + nl]
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        mm1, mm2, g = zero, zero, [zero] * 4
        ls = torch.zeros(lpb, dtype=F32)
        cprev = torch.ones(lpb, dtype=F32)
        sprev = torch.zeros(lpb, dtype=torch.int32)
        for d0 in range(0, D1, kt):
            n = min(kt, D1 - d0)
            planes = [stage_plane(x, d0, kt, b0, lpb, tma) for x in (em, bm)]
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            s1_t, bls_t = blk.records(s1, d0, n), blk.records(bls, d0, n)
            out = torch.full((lpb * blk.stride,), float("nan"), dtype=F32)
            for kb in range(n):
                if kb % 8 == 0:
                    # RelForward::scales: the period's scales, ls as it
                    # stands at the period's start.
                    scale = torch.exp(ls[:, None] + bls_t[:, kb:kb + 8]
                                      - lz[:, None])
                alpha = scale[:, kb % 8]
                e, bmv = (p[blk.at(kb)] for p in planes)
                v = blk.valid(v_t, kb)
                if d0 + kb == 0:
                    # The start distribution at row 0.
                    row0 = (blk.rows == 0).to(F32).expand(lpb, 32, rpt)
                    f = [row0 * 0.2] * 5
                    sprev = s1_t[:, 0]
                else:
                    t1 = s1_t[:, kb]
                    t2 = t1 + sprev
                    sprev = t1
                    mm = move(mm1, t2 - 1, wp, rpt)
                    if kb % 8 == 0:
                        mm = mm / cprev[:, None, None]
                    f = [e * mm] + [move(g[q], t1 - (q & 1), wp, rpt) * v
                                    for q in range(4)]
                    if kb % 8 == 7:
                        c = blk.band_max(f)
                        inv = 1.0 / c
                        f = [y * inv[:, None, None] for y in f]
                        ls = ls + torch.log(c)
                        cprev = c
                        alpha = torch.exp(ls + bls_t[:, kb] - lz)
                blk.emit(out, kb, f[0] * bmv * alpha[:, None, None])
                mx = []
                for t in range(5):
                    acc = f[0] * A[0][t]
                    for s in range(1, 5):
                        acc = acc + f[s] * A[s][t]
                    mx.append(acc)
                mm1, mm2 = mm2, mx[0]
                g = mx[1:]
            blk.flush(out, post, d0, n)
    return post


def _coef():
    st = fb_cuda.static_tables(
        tables_from_jax(jax.device_get(jfb.make_tables(PairHmm.load(MODEL)))))
    return fb_cuda._coefficients(st, fb_cuda.require_flat_gaps(st))


def random_inputs(D1, wp, B, seed, final_d=None, invalid_lanes=()):
    """K2's inputs at random (tests/test_torch_cuda.py `_random_fb`): 80%
    valid cells and the origin (none in `invalid_lanes`), match emissions
    in [0, 1) premasked, s1 in {-1, 0, 1, 2}, terminals on any diagonal
    (every fifth at d = 0, every eleventh past the band) and row (every
    seventh past the band), or all at final_d."""
    rng = np.random.default_rng(seed)
    valid = rng.random((D1, wp, B)) < 0.8
    valid[0, 0] = True
    valid[..., list(invalid_lanes)] = False
    em = (rng.random((D1, wp, B)) * valid).astype(np.float32)
    if final_d is None:
        fd = rng.integers(0, D1, B)
        fd[::5] = 0
        fd[3::11] = D1 + 3
    else:
        fd = np.full(B, final_d)
    fk = rng.integers(0, wp, B)
    fk[2::7] = wp + 1
    s1 = rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05], size=(D1, B))
    return (_coef(), *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        em, valid, s1.astype(np.int32), fd.astype(np.int32),
        fk.astype(np.int32))))


def same_bits(got, want):
    """Bit for bit, NaN included (random bands may give the plain versions
    non-finite posteriors)."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def assert_plain(args, lpb, tma):
    got = rel_backward_tiles(*args, lpb=lpb, tma=tma)
    want = fb_cuda.fb_backward_plain(*args)
    for g, w in zip(got, want):
        assert same_bits(g, w), (g - w).abs().max()
    fargs = args[:4] + tuple(want)
    post = rel_forward_tiles(*fargs, lpb=lpb, tma=tma)
    assert same_bits(post, fb_cuda.fb_forward_plain(*fargs))


@pytest.mark.parametrize("lpb,wp,tma", [
    (8, 24, True), (8, 24, False), (16, 24, True), (16, 24, False),
    (8, 48, True), (16, 48, False), (8, 96, False), (8, 128, False)],
    ids=["8-24-tma", "8-24-cp_async", "16-24-tma", "16-24-cp_async",
         "8-48-tma", "16-48-cp_async", "8-96-cp_async", "8-128-cp_async"])
def test_rel_tiles_match_plain_random(lpb, wp, tma):
    """One to four rows a thread (tiles of 16, 8, 8 and 8 diagonals; TMA
    at up to two rows a thread, 16 lanes a block too, as csrc/fb_rel.cuh
    `rel_tma` and `rel_lanes` take them), 19 lanes (a partial block), 37
    diagonals (a partial tile at either end)."""
    assert_plain(random_inputs(37, wp, 19, seed=wp + lpb), lpb, tma)


@pytest.mark.parametrize("lpb", [8, 16])
def test_rel_tiles_edges(lpb):
    """Every terminal at d = 0; a third of the lanes with no valid cell;
    one, two and nine diagonals."""
    assert_plain(random_inputs(20, 24, 13, seed=1, final_d=0), lpb, True)
    assert_plain(random_inputs(20, 24, 13, seed=2,
                               invalid_lanes=range(0, 13, 3)), lpb, False)
    for D1 in (1, 2, 9):
        assert_plain(random_inputs(D1, 24, 9, seed=D1), lpb, True)


@pytest.fixture(scope="module")
def packed():
    """A width-21 batch of synthetic reads (tests/test_torch_fb.py), the
    port's kernel inputs for it and the JAX package's specialised Pallas
    posteriors in interpret mode."""
    batch, _, _ = packed_batch(np.random.default_rng(5))
    jtables = jfb.make_tables(PairHmm.load(MODEL))
    jlogZ, jpost = posteriors_pallas_specialised(jtables,
                                                 jfb.device_batch(batch))
    tables = tables_from_jax(jax.device_get(jtables))
    dev = device_batch(batch, "cpu")
    coef, em = fb_cuda.fb_inputs(tables, dev)
    args = (coef, em, dev.valid, dev.s1, dev.final_d, dev.final_k)
    return batch, args, np.asarray(jlogZ), np.asarray(jpost)


@pytest.mark.parametrize("lpb,tma", [(8, True), (16, False)])
def test_rel_tiles_match_pallas(packed, lpb, tma):
    """On packed synthetic reads, the model's logZ and posteriors agree with
    the JAX package's Pallas kernels in interpret mode and equal the plain
    versions bit for bit."""
    batch, args, jlogZ, jpost = packed
    bm, bls, logZ = rel_backward_tiles(*args, lpb=lpb, tma=tma)
    post = rel_forward_tiles(*args[:4], bm, bls, logZ, lpb=lpb, tma=tma)
    n = int((batch.m + batch.n > 0).sum())
    assert np.allclose(logZ.numpy()[:n], jlogZ[:n], rtol=1e-4, atol=1e-4)
    assert np.allclose(post.numpy(), jpost, atol=2e-4)
    assert_plain(args, lpb, tma)
