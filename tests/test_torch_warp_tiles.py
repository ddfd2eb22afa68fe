"""The tile and index schemes of two warp-per-lane CUDA kernels, checked
where there is no card: the counts checkpoint forward (csrc/fb_counts.cu
`counts_fwd_ckpt_kernel`) and C (csrc/fb_circ.cu `cx_forward_kernel`).

Each kernel gives a lane a warp and stages tiles of diagonals of its
block's lanes in shared memory; a thread reads its rows at the kernel's
offsets, the rows cross the warp by shuffles, and the outputs go through a
per-lane record in shared memory that the block writes out.  Their
bit-equality with the plain versions rests on those offsets, on the
shuffles' source rows and on the order of the arithmetic.  Here both
schemes run in torch (float32, the kernels' order of operations), a
block of LPB lanes at a time with the lanes past B idle:

- the checkpoint forward: 8-diagonal tiles of the xb / yb / valid (and
  start) bytes lanes-fastest at `byte_stride(LPB)` (mk::stage_bytes), s1
  (and fink) [LPB][8], the emission tables with the gap emissions in
  pairs by code, band row k on thread k of 32, the mixes shuffled from
  rows k + t2 - 1, k + t1 and k + t1 - 1, the warp's record (checkpoint,
  term with its default 0, lsf, cs) and its flush to [Ntr, G, 10, Wp, B];
- C: tiles of 8 diagonals of es and bm rows per lane, the read codes as a
  byte tile, the records (bls, fr), band row kk + 32 r on thread kk, the
  rolls down by one row as the kernel's shuffles, the posterior's scale
  computed once per rescale period by thread j for its diagonal j, the
  four code accumulators rolled each diagonal, fl through an output tile
  [LPB][4 KT + 1], the tails.

Each is held equal to its plain version on every output (both model
forms, single and multi-problem lanes, one and three trials, 8 and 16
lanes a block, lane counts that are no multiple of either), and to the
JAX package's functions as the JAX tests run them: C's fl and tails
against `_cx_from_es` (tests/test_torch_fb_circ.py, atol 2e-4); the
checkpoint forward's logZ and, through the plain checkpoint backward, the
E-step counts against `_counts_ckpt_trials_jit` and `_counts_ckpt_multi_jit`
in interpret mode (tests/test_torch_em_counts.py and
tests/test_torch_em_multi.py: logZ 1e-4, counts 1e-3).
"""
import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.align.em import make_tables_stacked
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops import fb_pallas_counts as jc
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu.ops.fb_pallas import (
    _cx_from_es, _expand_streams, compact_device_batch,
)
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import fb_circ_cuda, fb_counts
from marginalign_trna_tpu_torch.ops import fb_counts_cuda as K
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, multi_device_batch, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_circ import circ_coefficients

from test_torch_em_counts import compare, em_batch, em_model, interpret
from test_torch_em_multi import _compare as compare_multi
from test_torch_em_multi import _problems
from test_torch_fb_circ import _batch as circ_batch
from test_torch_fb_circ import _tables as circ_tables

NS, KB = 5, 8          # states; diagonals a checkpoint tile
CX_KT = 8              # csrc/fb_circ.cu: C's diagonals a tile
F32 = torch.float32


def byte_stride(lpb):
    """csrc/common.cuh `byte_stride`."""
    return 4 * ((lpb // 4) | 1)


def stage_bytes(src, r0, nrows, b0, lpb):
    """mk::stage_bytes: rows r0 .. r0 + nrows - 1 of the [rows, B] byte
    array src, lanes b0 .. b0 + lpb - 1, as a flat tile (row q at
    q * byte_stride, lanes fastest; lanes past B stay 0)."""
    S = byte_stride(lpb)
    tile = np.zeros(nrows * S, np.uint8)
    for w in range(lpb):
        if b0 + w < src.shape[1]:
            tile[np.arange(nrows) * S + w] = src[r0:r0 + nrows, b0 + w].view(
                np.uint8)
    return tile


def shfl(v, src):
    """__shfl_sync over the thread axis (last) of v: out[.., j] =
    v[.., src[.., j] mod 32]."""
    return torch.gather(v, -1, (src % 32).long().expand(v.shape))


def wrap(k, wp):
    """mk::wrap."""
    return torch.where(k < 0, k + wp, torch.where(k >= wp, k - wp, k))


# ---------------------------------------------- the checkpoint forward


def _mix(f, T, t):
    """mix_to: sum_s f[s] * T[s][t], left to right; T [ntr, 25]."""
    acc = f[0] * T[:, t, None, None]
    for s in range(1, NS):
        acc = acc + f[s] * T[:, s * 5 + t, None, None]
    return acc


def lane_stride(n, lpb):
    """csrc/fb_counts.cu `lane_stride`: the least stride >= n that is
    32 / lpb modulo 32."""
    return n + (32 // lpb - n % 32) % 32


def emission_table(Em, Eg):
    """csrc/fb_counts.cu `cf_tables` [Ntr, 60]: em6 [x * 6 + y], then the
    pairs (Egap[1][c], Egap[3][c]) and (Egap[2][c], Egap[4][c]); zero at
    code 5."""
    ntr = Em.shape[0]
    em6 = torch.zeros(ntr, 6, 6, dtype=F32)
    em6[:, :5, :5] = Em
    pairs = torch.zeros(ntr, 2, 6, 2, dtype=F32)
    for q, (s_a, s_b) in enumerate(((1, 3), (2, 4))):
        pairs[:, q, :5, 0] = Eg[:, s_a]
        pairs[:, q, :5, 1] = Eg[:, s_b]
    return torch.cat([em6.reshape(ntr, 36), pairs.reshape(ntr, 24)], 1)


def ckpt_forward_tiles(T, Em, Eg, xb, yb, valid, s1, fink, start=None,
                       lpb=16, out="ckpt"):
    """(ckpt, cs, lsf, term) of the checkpoint forward as
    counts_fwd_ckpt_kernel computes them, block by block; with out="all"
    (its CF_ALL mode, the stored forward counts_fwd_all) (f_all, lsf, term),
    each warp's record holding the tile's five planes."""
    multi = start is not None
    store_all = out == "all"
    d1k, wp, B = xb.shape
    ntr, G, S = T.shape[0], d1k // KB, byte_stride(lpb)
    codes = [a.numpy().astype(np.uint8) for a in (xb, yb, valid)]
    s1n, finkn = s1.numpy(), fink.numpy()
    startn = start.numpy() if multi else None
    Tf = T.reshape(ntr, 25)
    tab = emission_table(Em, Eg)
    lead = KB * NS * wp if store_all else 2 * NS * wp
    rec_len = (lane_stride(lead + 2 * KB, lpb) if store_all
               else lead + 2 * KB + 5)
    ckpt = torch.zeros(ntr * G * lead * B, dtype=F32)
    cs = torch.zeros(ntr * G * 4 * B, dtype=F32)
    lsf = torch.zeros(ntr * d1k * B, dtype=F32)
    term = torch.zeros(ntr * d1k * B, dtype=F32)
    k = torch.arange(32)[None, None, :]          # [1, 1, 32]: thread = row
    row = k < wp
    w = torch.arange(lpb)[None, :, None]
    for b0 in range(0, B, lpb):
        fk = np.full(lpb, -1, np.int64)           # the lane's terminal row
        for ww in range(lpb):
            if b0 + ww < B and not multi:
                fk[ww] = finkn[b0 + ww]
        fk = torch.from_numpy(fk)[None, :, None]
        zero = torch.zeros(ntr, lpb, 32, dtype=F32)
        f = [zero] * NS
        mM1 = mM2 = zero
        mG = [zero] * 4
        ls = torch.zeros(ntr, lpb, 1, dtype=F32)
        cprev = torch.ones(ntr, lpb, 1, dtype=F32)
        sprev = torch.zeros(lpb, dtype=torch.int64)[None, :, None]
        for g in range(G):
            d0 = g * KB
            x_t, y_t, v_t = (stage_bytes(c.reshape(d1k * wp, B), d0 * wp,
                                         KB * wp, b0, lpb) for c in codes)
            st_t = (stage_bytes(startn, d0, KB, b0, lpb) if multi
                    else None)
            s1_t = np.zeros(KB * lpb, np.int64)
            fk_t = np.zeros(KB * lpb, np.int64)
            for q in range(KB * lpb):
                kb, ww = divmod(q, lpb)
                if b0 + ww < B:
                    s1_t[ww * KB + kb] = s1n[d0 + kb, b0 + ww]
                    if multi:
                        fk_t[ww * KB + kb] = finkn[d0 + kb, b0 + ww]
            rec = torch.full((ntr, lpb, rec_len), float("nan"), dtype=F32)
            o_term = lead
            rec[:, :, o_term:o_term + KB] = 0.0   # term defaults to 0
            lsA = ls
            cell = torch.where(row, k, 0) * S + w   # [1, lpb, 32]
            for kb in range(KB):
                t1 = torch.from_numpy(s1_t[np.arange(lpb) * KB + kb])[
                    None, :, None]
                at = (cell + kb * wp * S).numpy()
                x = torch.from_numpy(x_t[at].astype(np.int8).astype(np.int64))
                y = torch.from_numpy(y_t[at].astype(np.int8).astype(np.int64))
                xi = torch.where(row & (x >= 0) & (x < 5), x, 5)
                yi = torch.where(row & (y >= 0) & (y < 5), y, 5)
                v = torch.where(row, torch.from_numpy(v_t[at]).to(F32), 0.0)
                if not multi and kb == 0 and g == 0:
                    f = [torch.where(k == 0, 0.2, 0.0).to(F32).expand(
                        ntr, lpb, 32)] * NS
                    sprev = t1
                else:
                    t2 = t1 + sprev
                    sprev = t1
                    def look(at):
                        return torch.gather(tab, 1, at.expand(
                            ntr, lpb, 32).reshape(ntr, -1)).reshape(
                                ntr, lpb, 32)

                    e = [look(xi * 6 + yi), look(36 + 2 * xi),
                         look(48 + 2 * yi), look(37 + 2 * xi),
                         look(49 + 2 * yi)]
                    if kb == KB - 1 and not store_all:
                        for s in range(NS):
                            vals = f[s]
                            rec[:, :, (NS + s) * wp:(NS + s + 1) * wp] = \
                                vals[..., :wp]
                    ra = wrap(k + t2 - 1, wp)
                    rb, rc = wrap(k + t1, wp), wrap(k + t1 - 1, wp)
                    m = [shfl(mM2, ra), shfl(mG[0], rb), shfl(mG[1], rc),
                         shfl(mG[2], rb), shfl(mG[3], rc)]
                    if kb == 0:
                        m[0] = m[0] / cprev
                    f = [(e[s] * m[s]) * v for s in range(NS)]
                    if multi:
                        seed = torch.from_numpy(st_t[kb * S + np.arange(
                            lpb)].astype(np.int8) != 0)[None, :, None]
                        inj = torch.where(seed & (k == 0), 0.2, 0.0).to(F32)
                        f = [fs + inj for fs in f]
                tv = (((f[0] + f[1]) + f[2]) + f[3]) + f[4]
                if kb == KB - 1:
                    mx = torch.where(row, torch.maximum(torch.maximum(
                        torch.maximum(f[0], f[1]),
                        torch.maximum(f[2], f[3])), f[4]), 0.0).amax(
                            -1, keepdim=True)
                    c = torch.where(mx > 0, mx, 1.0)
                    inv = 1.0 / c
                    f = [fs * inv for fs in f]
                    tv = tv * (1.0 / c)
                    ls = ls + torch.log(c)
                    cprev = c
                fkd = (torch.from_numpy(fk_t[np.arange(lpb) * KB + kb])[
                    None, :, None] if multi else fk)
                hit = row & (k == fkd)
                cur = rec[:, :, o_term + kb]
                rec[:, :, o_term + kb] = torch.where(
                    hit.any(-1), (tv * hit).sum(-1), cur)
                if store_all:
                    for s in range(NS):
                        at = (kb * NS + s) * wp
                        rec[:, :, at:at + wp] = f[s][..., :wp]
                mM2 = mM1
                mM1 = _mix(f, Tf, 0)
                mG = [_mix(f, Tf, u + 1) for u in range(4)]
            if not store_all:
                for s in range(NS):
                    rec[:, :, s * wp:(s + 1) * wp] = f[s][..., :wp]
                rec[:, :, o_term + 2 * KB:o_term + 2 * KB + 4] = torch.cat(
                    [ls, cprev, sprev.to(F32).expand(ntr, lpb, 1),
                     torch.zeros(ntr, lpb, 1)], -1)
            rec[:, :, o_term + KB:o_term + 2 * KB] = torch.cat(
                [lsA.expand(ntr, lpb, KB - 1), ls], -1)
            # The flush: lane w of each trial's record, row r of the
            # checkpoint (f_all: of the tile) to ((t G + g) lead + r) B + b.
            for t in range(ntr):
                for ww in range(lpb):
                    b = b0 + ww
                    if b >= B:
                        continue
                    o = rec[t, ww]
                    r = torch.arange(lead)
                    ckpt[((t * G + g) * lead + r) * B + b] = o[r]
                    i = torch.arange(KB)
                    at = ((t * d1k + d0 + i) * B + b)
                    term[at] = o[o_term + i]
                    lsf[at] = o[o_term + KB + i]
                    if not store_all:
                        j = torch.arange(4)
                        cs[((t * G + g) * 4 + j) * B + b] = o[
                            o_term + 2 * KB + j]
    lsf, term = lsf.reshape(ntr, d1k, B), term.reshape(ntr, d1k, B)
    if store_all:
        return ckpt.reshape(ntr, d1k, NS, wp, B), lsf, term
    return (ckpt.reshape(ntr, G, 2 * NS, wp, B), cs.reshape(ntr, G, 4, B),
            lsf, term)


def _stacked(hmms):
    tables = tables_from_jax(jax.device_get(make_tables_stacked(hmms)))
    return tables.T, tables.Ematch, tables.Egap


@pytest.mark.parametrize("lpb", [8, 16])
@pytest.mark.parametrize("multi", [False, True])
def test_ckpt_forward_tiles_match_plain(multi, lpb):
    """The checkpoint forward's tiles equal counts_fwd_ckpt_plain /
    counts_multi_fwd_ckpt_plain on ckpt, cs, lsf and term: three trials,
    5 and 21 lanes packed at widths 21 and 9 (Wp 24, 16)."""
    tabs = _stacked([em_model(3), em_model(8), em_model(11)])
    if multi:
        reads, refs, paths = _problems(9)
        mb = tband.pack_multi_banded_batch(reads, refs, width=9, paths=paths,
                                           pad_steps_to=96, pad_batch_to=21)
        *streams, fk, _ = fb_counts.multi_kernel_inputs(
            multi_device_batch(mb, "cpu"))
        args = (*tabs, *streams, fk)
        want = K.counts_multi_fwd_ckpt_plain(*args)
        got = ckpt_forward_tiles(*tabs, *streams[:4], fk, start=streams[4],
                                 lpb=lpb)
    else:
        *streams, fk, _ = fb_counts.kernel_inputs(
            device_batch(em_batch(), "cpu"))
        args = (*tabs, *streams, fk)
        want = K.counts_fwd_ckpt_plain(*args)
        got = ckpt_forward_tiles(*args, lpb=lpb)
    for name, g, w in zip(("ckpt", "cs", "lsf", "term"), got, want):
        assert torch.equal(g, w), name


def test_ckpt_forward_tiles_match_pallas(monkeypatch):
    """Row 29: counts_trials(kernel="ckpt") with the tiles as its forward
    against `_counts_ckpt_trials_jit` (interpret mode), two trials."""
    hmms = [em_model(3), em_model(8)]
    jtables = make_tables_stacked(hmms)
    batch = em_batch()
    monkeypatch.setattr(K, "counts_fwd_ckpt_plain", ckpt_forward_tiles)
    got = fb_counts.counts_trials(tables_from_jax(jax.device_get(jtables)),
                                  device_batch(batch, "cpu"), kernel="ckpt")
    want = interpret(jc._counts_ckpt_trials_jit, jtables,
                     jax_device_batch(batch))
    err = compare(got, want, batch, want.emit_match)
    print("tiles, row 29: max abs err", err)


def test_ckpt_forward_tiles_multi_match_pallas(monkeypatch):
    """Row 30: counts_multi(kernel="ckpt") with the tiles as its forward
    against `_counts_ckpt_multi_jit` (interpret mode), width 21 (D1 not a
    multiple of 8)."""
    reads, refs, paths = _problems(21)
    kw = dict(width=21, paths=paths, pad_steps_to=96)
    jmb = jband.pack_multi_banded_batch(reads, refs, **kw)
    mdev = multi_device_batch(tband.pack_multi_banded_batch(reads, refs,
                                                            **kw), "cpu")
    jmdev = fp.multi_device_batch(jmb)
    jtables = make_tables(em_model())

    def tiles(T, Em, Eg, xb, yb, valid, s1, start, fink):
        return ckpt_forward_tiles(T, Em, Eg, xb, yb, valid, s1, fink, start)

    monkeypatch.setattr(K, "counts_multi_fwd_ckpt_plain", tiles)
    got = fb_counts.counts_multi(tables_from_jax(jax.device_get(jtables)),
                                 mdev, kernel="ckpt")
    want = interpret(jc._counts_ckpt_multi_jit, jtables, jmdev)
    err = compare_multi(got, want, mdev, jmdev)
    print("tiles, row 30: max abs err", err)


# ---------------------------------------------------------------------- C


def roll_down(v, wp):
    """csrc/fb_circ.cu `roll_down` on v [.., RPT, 32]: row k - 1 (row
    Wp - 1 for row 0) of rows k = kk + 32 r, by the kernel's shuffles."""
    rpt = v.shape[-2]
    kk = torch.arange(32)
    if rpt == 1:
        return shfl(v, torch.where(kk == 0, wp - 1, kk - 1))
    up = shfl(v, (kk + 31) & 31)
    wrapv = shfl(v[..., rpt - 1:, :], torch.full((32,), (wp - 1) & 31))
    out = []
    for r in range(rpt):
        alt = up[..., r - 1, :] if r > 0 else wrapv[..., 0, :]
        out.append(torch.where(kk > 0, up[..., r, :], alt))
    return torch.stack(out, -2)


def cx_tiles(coef, chain, es, yb, fr, bm, bls, logZ, lpb=16):
    """(fl [4, d1k, B], tails [4, Wp, B]) as cx_forward_kernel computes
    them, block by block."""
    c = fb_circ_cuda._floats(coef)
    C = fb_circ_cuda
    A = [[c[C.COEF_A + 5 * s + u] for u in range(5)] for s in range(5)]
    d1k, wp, B = es.shape
    rpt = -(-wp // 32)
    S, stride = byte_stride(lpb), CX_KT * wp + 1
    esn, bmn, ybn = es.numpy(), bm.numpy(), yb.numpy()
    fl = torch.zeros(4 * d1k * B, dtype=F32)
    tails = torch.zeros(4 * wp * B, dtype=F32)
    kk = torch.arange(32)
    rows = kk[None, :] + 32 * torch.arange(rpt)[:, None]      # [RPT, 32]
    inb = rows < wp
    for b0 in range(0, B, lpb):
        lanes = np.minimum(b0 + np.arange(lpb), B - 1)
        live = torch.from_numpy(b0 + np.arange(lpb) < B)
        lz = torch.where(live, logZ[lanes], 0.0)[:, None, None]
        zero = torch.zeros(lpb, rpt, 32, dtype=F32)
        f = [zero] * 5
        mm1 = mm2 = g1 = g2 = g3 = g4 = zero
        acc = [zero] * 4
        ls = torch.zeros(lpb, 1, 1, dtype=F32)
        cprev = torch.ones(lpb, 1, 1, dtype=F32)
        for d0 in range(0, d1k, CX_KT):
            n = min(CX_KT, d1k - d0)
            # The stage: es and bm rows per lane, records, the code tile.
            es_t = np.zeros(lpb * stride, np.float32)
            bm_t = np.zeros(lpb * stride, np.float32)
            rec_bls = np.zeros(lpb * CX_KT, np.float32)
            rec_fr = np.zeros(lpb * CX_KT, np.int64)
            for w in range(lpb):
                if b0 + w < B:
                    r = np.arange(n * wp)
                    es_t[w * stride + r] = esn[d0:d0 + n, :, b0 + w].reshape(-1)
                    bm_t[w * stride + r] = bmn[d0:d0 + n, :, b0 + w].reshape(-1)
                    rec_bls[w * CX_KT + np.arange(n)] = bls[d0:d0 + n,
                                                            b0 + w].numpy()
                    rec_fr[w * CX_KT + np.arange(n)] = fr[d0:d0 + n,
                                                          b0 + w].numpy()
            yb_t = stage_bytes(ybn.reshape(d1k * wp, B), d0 * wp, n * wp,
                               b0, lpb)
            out = np.full(lpb * (4 * CX_KT + 1), np.nan, np.float32)
            w = np.arange(lpb)[:, None, None]
            for p in range(0, n, 8):
                # Thread j of a lane holds the scale of the period's
                # diagonal j, shuffled out per diagonal.
                a = torch.exp(ls + torch.from_numpy(
                    rec_bls[w * CX_KT + p + (kk.numpy() & 7)]) - lz)
                for kb in range(p, min(p + 8, n)):
                    d = d0 + kb
                    alpha = shfl(a, torch.full((32,), kb & 7))
                    at = w * stride + kk.numpy()[None, None, :] + kb * wp + \
                        32 * np.arange(rpt)[None, :, None]
                    if d == 0:
                        origin = rows == 0
                        f = [torch.where(origin, 0.2, 0.0).to(F32).expand(
                            lpb, rpt, 32)]
                        f += [torch.where(origin, c[C.COEF_PI + s - 1]
                                          if chain else 0.2, 0.0).to(
                            F32).expand(lpb, rpt, 32) for s in range(1, 5)]
                    else:
                        x = torch.where(inb, torch.from_numpy(
                            es_t[np.where(inb.numpy(), at, 0)]), -1.0)
                        v = torch.where(x >= 0, 1.0, 0.0)
                        e = torch.clamp(x, min=0.0)
                        mm = mm2 / cprev if (kb & 7) == 0 else mm2
                        f = [e * mm, g1 * v, g2 * v, g3 * v, g4 * v]
                        if (kb & 7) == 7:
                            mx = torch.where(inb, torch.maximum(torch.maximum(
                                torch.maximum(f[0], f[1]),
                                torch.maximum(f[2], f[3])), f[4]), 0.0).amax(
                                    dim=(-2, -1), keepdim=True)
                            cf = torch.where(mx > 0, mx, 1.0)
                            inv = 1.0 / cf
                            f = [fs * inv for fs in f]
                            ls = ls + torch.log(cf)
                            cprev = cf
                            alpha = torch.exp(ls + torch.from_numpy(
                                rec_bls[w * CX_KT + kb]) - lz)
                    bmv = torch.from_numpy(bm_t[np.where(inb.numpy(), at,
                                                         0)])
                    post = torch.where(inb, f[0] * bmv * alpha, 0.0)
                    # The sink.
                    frd = torch.from_numpy(rec_fr[w[:, 0, 0] * CX_KT + kb])[
                        :, None, None]
                    yat = (kb * wp + rows.numpy()[None]) * S + w
                    code = torch.where(inb, torch.from_numpy(
                        yb_t[np.where(inb.numpy(), yat, 0)].astype(
                            np.int8).astype(np.int64)), -1)
                    pv = torch.where((rows == 0) & (d == 0), 0.0, post)
                    flush = inb & (rows == frd)
                    for ch in range(4):
                        rolled = roll_down(acc[ch], wp)
                        got = (rolled * flush).sum(dim=(-2, -1))
                        at_fl = w[:, 0, 0] * (4 * CX_KT + 1) + ch * CX_KT + kb
                        out[at_fl] = np.where(flush.any(dim=(-2, -1)).numpy(),
                                              got.numpy(), out[at_fl])
                        acc[ch] = torch.where(
                            inb, torch.where(flush, 0.0, rolled)
                            + torch.where(code == ch, pv, 0.0), acc[ch])
                    outside = ((frd < 0) | (frd >= wp))[:, 0, 0].numpy()
                    for ch in range(4):
                        at_fl = w[:, 0, 0] * (4 * CX_KT + 1) + ch * CX_KT + kb
                        out[at_fl] = np.where(outside, 0.0, out[at_fl])
                    # publish
                    if chain:
                        mm = c[C.COEF_T00] * f[0]
                        for s in range(1, 5):
                            mm = mm + c[C.COEF_MC + s - 1] * f[s]
                        gs = [f[0] + c[C.COEF_C + u - 1] * f[u]
                              for u in range(1, 5)]
                    else:
                        mm = f[0] * A[0][0]
                        for s in range(1, 5):
                            mm = mm + f[s] * A[s][0]
                        gs = []
                        for u in range(1, 5):
                            g = f[0] * A[0][u]
                            for s in range(1, 5):
                                g = g + f[s] * A[s][u]
                            gs.append(g)
                    g1, g3 = gs[0], gs[2]
                    mm2 = mm1
                    mm1 = roll_down(mm, wp)
                    g2 = roll_down(gs[1], wp)
                    g4 = roll_down(gs[3], wp)
            # The flush of the tile's fl: lane w, row c * KT + kb.
            for ww in range(lpb):
                if b0 + ww >= B:
                    continue
                for j in range(4 * CX_KT):
                    ch, kb = divmod(j, CX_KT)
                    if kb < n:
                        fl[(ch * d1k + d0 + kb) * B + b0 + ww] = float(
                            out[ww * (4 * CX_KT + 1) + j])
        for ww in range(lpb):
            if b0 + ww >= B:
                continue
            for ch in range(4):
                for r in range(rpt):
                    for t in range(32):
                        k = t + 32 * r
                        if k < wp:
                            tails[(ch * wp + k) * B + b0 + ww] = acc[ch][
                                ww, r, t]
    return fl.reshape(4, d1k, B), tails.reshape(4, wp, B)


def _cx_case(chain, width, pad_to=None):
    """test_torch_fb_circ.py's batch (a deletion and an insertion along
    guide paths, an unguided pair, a 5 x 8 pair, padded lanes), es / yb /
    fr from the JAX package's `_expand_streams`, its lanes repeated to
    `pad_to` lanes (as packed when None); S's plain outputs."""
    jtables, st, gc = circ_tables(chain)
    comp = circ_batch(np.random.default_rng(8), width)
    d1k = -(-comp.num_steps // 8) * 8
    cdev = compact_device_batch(comp)
    es, yb, fr, _, _ = _expand_streams(st, cdev, width, d1k, want_yb=True)
    fink = cdev.fink.astype(np.int32)
    find = cdev.final_d.astype(np.int32)
    tables = tables_from_jax(jax.device_get(jtables))
    coef, is_chain = circ_coefficients(tables)
    assert is_chain == chain
    pad_to = pad_to or es.shape[2]
    reps = -(-pad_to // es.shape[2])

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(
            np.tile(a, (1,) * (a.ndim - 1) + (reps,))[..., :pad_to]))

    tes, tyb, tfr, tfink, tfind = (t(a) for a in (es, yb, fr, fink, find))
    back = fb_circ_cuda.sv_backward_plain(coef, chain, tes, tfink, tfind)
    jax_in = (st, gc, es, yb, cdev.fink.astype(np.int32)[None, :],
              cdev.final_d.astype(np.int32)[None, :], fr)
    return (coef, chain, tes, tyb, tfr, *back), jax_in, comp


@pytest.mark.parametrize("lpb", [8, 16])
@pytest.mark.parametrize("chain,width", [(True, 21), (False, 21),
                                         (True, 45), (False, 45)],
                         ids=["chain", "mix", "chain-wp48", "mix-wp48"])
def test_cx_tiles_match_plain(chain, width, lpb):
    """C's tiles equal cx_forward_plain on fl and tails: both model forms,
    one and two band rows a thread, 19 lanes (a partial block), flush rows
    past the band, a partial last tile where d1k is no multiple of 8."""
    args, _, _ = _cx_case(chain, width, 19)
    got = cx_tiles(*args, lpb=lpb)
    want = fb_circ_cuda.cx_forward_plain(*args)
    assert args[4].min() < 0 or args[4].max() >= args[2].shape[1]
    for name, g, w in zip(("fl", "tails"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("chain", [True, False], ids=["chain", "mix"])
def test_cx_tiles_match_pallas(chain):
    """C's tiles against the JAX package's `_cx_from_es` (interpret mode)
    at width 21, its tolerance (tests/test_torch_fb_circ.py)."""
    args, jax_in, comp = _cx_case(chain, 21)
    fl, tails = cx_tiles(*args, lpb=8)
    logZ_j, fl_j, tails_j = (np.asarray(a) for a in _cx_from_es(*jax_in))
    live = (comp.m + comp.n) > 0
    assert np.allclose(args[7].numpy()[live], logZ_j[live], rtol=1e-4,
                       atol=1e-4)
    assert fl.shape == fl_j.shape and tails.shape == tails_j.shape
    assert np.abs(fl.numpy() - fl_j).max() <= 2e-4
    assert np.abs(tails.numpy() - tails_j).max() <= 2e-4
