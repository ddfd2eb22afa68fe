"""The tile and record schemes of the stored counts pair's CUDA kernels,
checked where there is no card: the stored forward (csrc/fb_counts.cu
`counts_fwd_ckpt_kernel` in its CF_ALL mode: counts_fwd_all,
counts_multi_fwd_all) and the stored backward (`counts_stored_bwd_kernel`:
counts_bwd, counts_multi_bwd).

Both give a lane and trial a warp, band row k on thread k.  The forward
keeps each tile's five scaled planes in a per-warp record in shared memory
and writes them out as f_all rows (tests/test_torch_warp_tiles.py
`ckpt_forward_tiles` with out="all").  The backward stages each tile of 8
descending diagonals into a ring buffer: the lane's f_all rows at a
`lane_stride`, the code bytes lanes-fastest, s1 and lsf per lane (over
multi-problem lanes the start bytes and fink, find and L too).  It reads
f_all there, writes each posterior over its f_M value and writes the
tile's posterior rows out from there; each thread keeps its row's 25
transition partials (fused multiply-adds) and its gap counts in bins
indexed code * 4 + state - 1, summed over the warp's rows by a shuffle
tree at the end.  Here both run in torch (float32, the kernels' order of
operations; a fused multiply-add as one float64 sum rounded to float32), a
block of LPB lanes at a time with the lanes past B idle.

Each is held equal to its plain version (f_all, lsf, term and the
posterior band bit for bit, the count partials within rtol 1e-5: they sum
in another order) at 8 and 16 lanes a block, over lane counts that are no
multiple of either, one and three trials, single and multi-problem lanes,
a random EM start (gap emissions not flat) and the shipped flat-gap model;
and, through ops/fb_counts.py, to the JAX package's `_counts_pallas_trials_jit`
and `_counts_pallas_multi_jit` in interpret mode at the JAX tests'
tolerances (logZ 1e-4, counts 1e-3).
"""
import os

import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.align.em import make_tables_stacked
from marginalign_trna_tpu.models.hmm import PairHmm as JaxPairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import fb_counts
from marginalign_trna_tpu_torch.ops import fb_counts_cuda as K
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, multi_device_batch, multi_logz, tables_from_jax,
)

from test_torch_em_counts import compare, em_batch, em_model, interpret
from test_torch_em_multi import _compare as compare_multi
from test_torch_em_multi import _problems
from test_torch_warp_tiles import (
    _stacked, byte_stride, ckpt_forward_tiles, emission_table, lane_stride,
    shfl, stage_bytes, wrap,
)

NS, KB = 5, 8          # states; diagonals a tile
F32 = torch.float32
MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")


def stored_forward_tiles(T, Em, Eg, xb, yb, valid, s1, fink, start=None,
                         lpb=16):
    """(f_all, lsf, term) as counts_fwd_ckpt_kernel's CF_ALL mode computes
    them."""
    return ckpt_forward_tiles(T, Em, Eg, xb, yb, valid, s1, fink, start,
                              lpb=lpb, out="all")


def _fma(a, b, c):
    """__fmaf_rn(a, b, c): the exact product plus c, rounded once (float64
    holds the product of two float32 exactly)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _warp_sum(v):
    """warp_sum's shuffle-down tree over the thread axis (last, 32): the
    sum thread 0 ends with."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def stored_backward_tiles(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink,
                          find, logZ, start=None, lpb=16):
    """(post, tcp, egp) of the stored backward as counts_stored_bwd_kernel
    computes them, block by block."""
    multi = start is not None
    d1k, wp, B = xb.shape
    ntr, G, S = T.shape[0], d1k // KB, byte_stride(lpb)
    stride = lane_stride(KB * NS * wp, lpb)
    codes = [a.numpy().astype(np.uint8) for a in (xb, yb, valid)]
    s1n, finkn, findn = s1.numpy(), fink.numpy(), find.numpy()
    startn = start.numpy() if multi else None
    Tf = T.reshape(ntr, 25)
    tab = emission_table(Em, Eg)
    post = torch.zeros(ntr * d1k * wp * B, dtype=F32)
    tcp = torch.zeros(ntr, 25, B, dtype=F32)
    egp = torch.zeros(ntr, 20, B, dtype=F32)
    k = torch.arange(32)[None, None, :]          # [1, 1, 32]: thread = row
    row = k < wp
    w = torch.arange(lpb)[None, :, None]
    shape = (ntr, lpb, 32)

    def look(at):
        return torch.gather(tab, 1, at.expand(shape).reshape(ntr, -1)
                            ).reshape(shape)

    for b0 in range(0, B, lpb):
        lanes = [b0 + ww for ww in range(lpb) if b0 + ww < B]
        fk = np.full(lpb, -1, np.int64)
        fd = np.full(lpb, -1, np.int64)
        lz0 = torch.zeros(ntr, lpb, 1, dtype=F32)
        if not multi:
            for ww, b in enumerate(lanes):
                fk[ww], fd[ww] = finkn[b], findn[b]
                lz0[:, ww, 0] = logZ[:, b]
        fk = torch.from_numpy(fk)[None, :, None]
        fd = torch.from_numpy(fd)[None, :, None]
        zero = torch.zeros(shape, dtype=F32)
        bls = torch.zeros(ntr, lpb, 1, dtype=F32)
        cprev = torch.ones(ntr, lpb, 1, dtype=F32)
        sh1 = sh2 = torch.zeros(1, lpb, 1, dtype=torch.int64)
        p1 = p2 = zero
        g1 = [zero] * 4
        tca = torch.zeros(shape + (25,), dtype=F32)
        egb = torch.zeros(shape + (24,), dtype=F32)
        for u in range(G):
            d0 = (G - 1 - u) * KB
            # The ring buffer: f_all rows per lane, the code tiles, the
            # per-lane streams.
            fa = torch.full((ntr, lpb, stride), float("nan"), dtype=F32)
            s1_t = np.zeros((lpb, KB), np.int64)
            fk_t = np.full((lpb, KB), -1, np.int64)
            fd_t = np.full((lpb, KB), -1, np.int64)
            lsf_t = torch.zeros(ntr, lpb, KB, dtype=F32)
            lz_t = torch.zeros(ntr, lpb, KB, dtype=F32)
            for ww, b in enumerate(lanes):
                fa[:, ww, :KB * NS * wp] = f_all[:, d0:d0 + KB, :, :, b
                                                 ].reshape(ntr, -1)
                s1_t[ww] = s1n[d0:d0 + KB, b]
                lsf_t[:, ww] = lsf[:, d0:d0 + KB, b]
                if multi:
                    fk_t[ww] = finkn[d0:d0 + KB, b]
                    fd_t[ww] = findn[d0:d0 + KB, b]
                    lz_t[:, ww] = logZ[:, d0:d0 + KB, b]
            x_t, y_t, v_t = (stage_bytes(c.reshape(d1k * wp, B), d0 * wp,
                                         KB * wp, b0, lpb) for c in codes)
            st_t = stage_bytes(startn, d0, KB, b0, lpb) if multi else None
            for kb in range(KB - 1, -1, -1):
                d = d0 + kb
                at = (torch.where(row, k, 0) * S + w + kb * wp * S).numpy()
                x = torch.from_numpy(x_t[at].astype(np.int8).astype(np.int64))
                y = torch.from_numpy(y_t[at].astype(np.int8).astype(np.int64))
                xi = torch.where(row & (x >= 0) & (x < 5), x, 5)
                yi = torch.where(row & (y >= 0) & (y < 5), y, 5)
                v = torch.where(row, torch.from_numpy(v_t[at]).to(F32), 0.0)
                s1c, s2c = sh1, sh1 + sh2
                ra = wrap(k + 1 - s2c, wp)
                rb, rc = wrap(k - s1c, wp), wrap(k + 1 - s1c, wp)
                q0 = shfl(p2, ra)
                if kb == KB - 1:
                    q0 = q0 / cprev
                q = [q0, shfl(g1[0], rb), shfl(g1[1], rc), shfl(g1[2], rb),
                     shfl(g1[3], rc)]
                if multi:
                    inj_row = torch.from_numpy(np.where(
                        fd_t[:, kb] == d, fk_t[:, kb], -1))[None, :, None]
                    lz = lz_t[..., kb:kb + 1]
                else:
                    inj_row = torch.where(fd == d, fk, -1)
                    lz = lz0
                inj = (k == inj_row).to(F32)
                nb = []
                for s in range(NS):
                    acc = q[0] * Tf[:, s * 5, None, None]
                    for uu in range(1, NS):
                        acc = acc + q[uu] * Tf[:, s * 5 + uu, None, None]
                    nb.append((acc + inj) * v)
                sh2 = sh1
                sh1 = torch.from_numpy(s1_t[:, kb])[None, :, None]
                if multi:
                    bls = torch.where(inj_row >= 0, 0.0, bls)
                lsd = lsf_t[..., kb:kb + 1]
                if kb == 0:
                    mx = torch.where(row, torch.maximum(torch.maximum(
                        torch.maximum(nb[0], nb[1]),
                        torch.maximum(nb[2], nb[3])), nb[4]), 0.0).amax(
                            -1, keepdim=True)
                    c = torch.where(mx > 0, mx, 1.0)
                    inv = 1.0 / c
                    nb = [b_ * inv for b_ in nb]
                    bls = bls + torch.log(c)
                    cprev = c
                    alpha0 = torch.exp(lsd + bls - lz)
                    alpha1 = alpha0 * (1.0 / c)
                else:
                    alpha0 = torch.exp(lsd + bls - lz)
                    alpha1 = alpha0
                if multi:
                    bound = torch.from_numpy(st_t[kb * S + np.arange(lpb)]
                                             .astype(np.int8) != 0)
                    a0n = alpha0 * torch.where(bound, 0.0, 1.0)[None, :, None]
                else:
                    a0n = alpha0 * (0.0 if d == 0 else 1.0)
                # Row k's f_all values at slot (kb NS + s) Wp + k.
                base = kb * NS * wp
                fv = []
                for s in range(NS):
                    val = torch.zeros(shape, dtype=F32)
                    val[..., :wp] = fa[..., base + s * wp:base + (s + 1) * wp]
                    fv.append(val)
                pv = (fv[0] * nb[0]) * alpha0
                fa[..., base:base + wp] = pv[..., :wp]
                for s in range(NS):
                    fs = fv[s] * alpha1
                    for uu in range(NS):
                        tca[..., s * 5 + uu] = torch.where(
                            row, _fma(fs, q[uu], tca[..., s * 5 + uu]),
                            tca[..., s * 5 + uu])
                for s in range(1, NS):
                    code = xi if s & 1 else yi
                    hit = (code * 4 + s - 1).expand(shape)[..., None]
                    add = torch.where(row, (fv[s] * nb[s]) * a0n, 0.0)
                    egb.scatter_add_(3, hit, add[..., None])
                gx = [look(36 + 2 * xi), look(37 + 2 * xi)]
                gy = [look(48 + 2 * yi), look(49 + 2 * yi)]
                p2 = p1
                p1 = look(xi * 6 + yi) * nb[0]
                g1 = [gx[0] * nb[1], gy[0] * nb[2], gx[1] * nb[3],
                      gy[1] * nb[4]]
            # The flush: row k of diagonal d0 + kb from slot kb NS Wp + k.
            for ww, b in enumerate(lanes):
                for t in range(ntr):
                    for kb in range(KB):
                        r = torch.arange(wp)
                        post[((t * d1k + d0 + kb) * wp + r) * B + b] = fa[
                            t, ww, kb * NS * wp + r]
        for ww, b in enumerate(lanes):
            tcp[:, :, b] = _warp_sum(torch.where(
                row[..., None], tca, 0.0)[:, ww].transpose(-1, -2))
            for j in range(20):
                egp[:, j, b] = _warp_sum(torch.where(
                    row, egb[..., (j % 5) * 4 + j // 5], 0.0)[:, ww])
    return post.reshape(ntr, d1k, wp, B), tcp, egp


def _tables(model, ntr):
    """Stacked (T, Ematch, Egap) of `ntr` models: random EM starts (gap
    emissions not flat) or the shipped flat-gap model."""
    if model == "shipped":
        return _stacked([JaxPairHmm.load(MODEL)] * ntr)
    return _stacked([em_model(s) for s in (3, 8, 11)[:ntr]])


def _case(multi, model, ntr):
    """(tables, forward streams, find, the normaliser's function): the
    width-21 EM batch's lanes repeated to 21, or multi-problem lanes of the
    width-9 problems (Wp 16) padded to 21."""
    tabs = _tables(model, ntr)
    if multi:
        reads, refs, paths = _problems(9)
        mdev = multi_device_batch(tband.pack_multi_banded_batch(
            reads, refs, width=9, paths=paths, pad_steps_to=96,
            pad_batch_to=21), "cpu")
        *streams, fk, fd = fb_counts.multi_kernel_inputs(mdev)
        return tabs, (*streams, fk), fd, lambda lsf, term: multi_logz(
            lsf, term, mdev)[0]
    # The EM batch's 8 lanes repeated to 21.
    out = [torch.cat([a] * 3, dim=-1)[..., :21].contiguous()
           for a in fb_counts.kernel_inputs(device_batch(em_batch(), "cpu"))]
    *streams, fk, fd = out
    return tabs, (*streams, fk), fd, lambda lsf, term: \
        fb_counts.logz_from_terminal(lsf, term, fd)


@pytest.mark.parametrize("ntr,model", [(1, "shipped"), (3, "random")])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("lpb", [8, 16])
def test_stored_tiles_match_plain(lpb, multi, ntr, model):
    """The stored pair's tiles equal counts_fwd_all_plain + counts_bwd_plain
    (their counts_multi_ twins over multi-problem lanes): f_all, lsf, term
    and the posterior band bit for bit, the per-lane count partials within
    rtol 1e-5."""
    tabs, streams, fd, norm = _case(multi, model, ntr)
    B = streams[0].shape[-1]
    assert B % lpb != 0
    fwd, bwd = ((K.counts_multi_fwd_all_plain, K.counts_multi_bwd_plain)
                if multi else (K.counts_fwd_all_plain, K.counts_bwd_plain))
    start = streams[4] if multi else None
    fk = streams[-1]
    want = fwd(*tabs, *streams)
    got = stored_forward_tiles(*tabs, *streams[:4], fk, start=start, lpb=lpb)
    for name, g, w in zip(("f_all", "lsf", "term"), got, want):
        assert torch.equal(g, w), name
    f_all, lsf, term = want
    bargs = (*tabs, f_all, lsf, *streams, fd, norm(lsf, term))
    want = bwd(*bargs)
    got = stored_backward_tiles(*tabs, f_all, lsf, *streams[:4], fk, fd,
                                bargs[-1], start=start, lpb=lpb)
    assert torch.equal(got[0], want[0]), "post"
    assert want[1].abs().max() > 0 and want[2].abs().max() > 0
    for name, g, w in zip(("tcp", "egp"), got[1:], want[1:]):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6), name


def test_stored_tiles_match_pallas(monkeypatch):
    """Row 26: counts_trials(kernel="stored") with the tiles as its pair
    against `_counts_pallas_trials_jit` (interpret mode), two trials."""
    hmms = [em_model(3), em_model(8)]
    jtables = make_tables_stacked(hmms)
    batch = em_batch()

    def bwd(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink, find, logZ):
        return stored_backward_tiles(T, Em, Eg, f_all, lsf, xb, yb, valid,
                                     s1, fink, find, logZ, lpb=8)

    monkeypatch.setattr(K, "counts_fwd_all_plain", stored_forward_tiles)
    monkeypatch.setattr(K, "counts_bwd_plain", bwd)
    got = fb_counts.counts_trials(tables_from_jax(jax.device_get(jtables)),
                                  device_batch(batch, "cpu"), kernel="stored")
    dev = jax_device_batch(batch)
    want = interpret(jc._counts_pallas_trials_jit, jtables, dev)
    err = compare(got, want, batch,
                  jc.match_counts_from_posteriors_trials(want.posteriors,
                                                         dev))
    print("stored tiles, row 26: max abs err", err)


def test_stored_tiles_multi_match_pallas(monkeypatch):
    """Row 25: counts_multi(kernel="stored") with the tiles as its pair
    against `_counts_pallas_multi_jit` (interpret mode), width 21 (D1 not a
    multiple of 8)."""
    reads, refs, paths = _problems(21)
    kw = dict(width=21, paths=paths, pad_steps_to=96)
    jmb = jband.pack_multi_banded_batch(reads, refs, **kw)
    mdev = multi_device_batch(tband.pack_multi_banded_batch(reads, refs,
                                                            **kw), "cpu")
    jmdev = fp.multi_device_batch(jmb)
    jtables = make_tables(em_model())

    def fwd(T, Em, Eg, xb, yb, valid, s1, start, fink):
        return stored_forward_tiles(T, Em, Eg, xb, yb, valid, s1, fink, start)

    def bwd(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, start, fink, find, L):
        return stored_backward_tiles(T, Em, Eg, f_all, lsf, xb, yb, valid,
                                     s1, fink, find, L, start=start)

    monkeypatch.setattr(K, "counts_multi_fwd_all_plain", fwd)
    monkeypatch.setattr(K, "counts_multi_bwd_plain", bwd)
    got = fb_counts.counts_multi(tables_from_jax(jax.device_get(jtables)),
                                 mdev, kernel="stored")
    want = interpret(jc._counts_pallas_multi_jit, jtables, jmdev)
    err = compare_multi(got, want, mdev, jmdev)
    print("stored tiles, row 25: max abs err", err)
