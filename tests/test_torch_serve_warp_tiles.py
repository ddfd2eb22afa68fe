"""The tile scheme of the circular serving route's CUDA kernels, checked
where there is no card: csrc/fb_serve.cu `serve_backward_kernel` (the
backwards circ_backward_emv / _codes / _codes_es, S's walk `sv_walk` over
their emission sources; S itself is its signed-stream instance) and
`serve_post_kernel` (the posterior forwards circ_post_es / _emv / _codes).

The backward gives a lane a warp, `ceil(Wp / 32)` consecutive band rows a
thread (mk::WarpRows: row k = RPT kk + r), and walks tiles of KT
descending diagonals (16 at one row a thread, else 8: whole rescale
periods) staged in a ring of buffers (8 lanes a block for the serving
sources): the float stream (es or em) as lane rows at an odd stride, the
source's byte streams (valid; xb, yb and valid) as byte tiles lanes
fastest.  Each b_M goes over the float it replaces (es, em) or into a
float plane of the buffer (codes), and the tile leaves from there; codes_es
decodes the tile's cells again as it leaves, writing es = e - (1 - v).
The forward gives a lane a warp with band row k = kk + 32 r on thread kk
(M's layout, `WarpForward`: the row moves are roll-downs by shuffles) and
walks tiles of KT ascending diagonals (16 at one row a thread and 8 lanes
a block, else 8) staged one ahead: the float bands (es or em, and bm)
either as the tensor memory accelerator copies them (the box [KT][Wp][LPB]
lanes fastest, zeros out of bounds, swizzled) or by cp.async (lane rows),
bls as [LPB][KT], the byte tiles as the backward's.  It
computes the posterior's scale exp(ls + bls - logZ) of a rescale period's
diagonals when the period starts and again after the period's rescale,
and the circular band leaves through an output tile as lane rows.  Their
bit-equality with the plain versions rests on those offsets, on the row
moves, on the source decodes (codes outside 0..4 emit 0) and on the order
of the arithmetic.  Here both run in torch (float32, the kernels' order of
operations), a block of LPB lanes at a time with the lanes past B idle.

The models are held bit for bit to the plain versions (bm, bls, logZ, es
and post) at one to four rows a thread, 8 and 16 lanes a block, both
staging layouts of the forward, every source of each kernel, over lane
counts that are no multiple of a block and diagonal counts that are no
multiple of a tile, with terminals at d = 0, lanes with no valid cell and
codes outside 0..4; and, on packed synthetic reads, to the JAX package's
`posteriors_pallas_circ` in each of the modes sv, em, lean and emw in
interpret mode (logZ rtol / atol 1e-4, posteriors atol 2e-4, the JAX
tests' tolerances; the JAX functions compiled without XLA's fusion pass,
as tests/test_torch_fb_serve.py compiles them).
"""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu_torch.ops import fb_circ_cuda as K
from marginalign_trna_tpu_torch.ops.fb import tables_from_jax
from marginalign_trna_tpu_torch.ops.fb_circ import (
    circ_coefficients, emission_stream, posteriors_circ,
)

from test_torch_fb_serve import FAST_COMPILE, _jax_tables
from test_torch_fb_serve import case  # noqa: F401  (fixture)
from test_torch_mea_warp_tiles import roll, stage_plane, swizzled
from test_torch_warp_tiles import byte_stride, roll_down, stage_bytes

F32 = torch.float32
NAN = float("nan")


def kt_of(rpt, lpb=8):
    """csrc/fb_circ.cuh `sv_kt` (lpb 8: the serving backwards' block) and
    csrc/fb_serve.cu `sp_kt`: diagonals a tile."""
    return 16 if rpt == 1 and lpb == 8 else 8


class Coef:
    """The model's coefficients (csrc/common.cuh `FlatGapCoef`)."""

    def __init__(self, coef, chain):
        c = K._floats(coef)
        self.chain = chain
        self.A = [[c[K.COEF_A + 5 * s + u] for u in range(5)]
                  for s in range(5)]
        self.t00 = c[K.COEF_T00]
        self.m0, self.cb, self.r, self.tz, self.pi, self.mc, self.cc = (
            [c[o + i] for i in range(4)] for o in (
                K.COEF_M0, K.COEF_CB, K.COEF_R, K.COEF_TZ, K.COEF_PI,
                K.COEF_MC, K.COEF_C))


def codes_cell(table, x, y, vb):
    """csrc/fb_circ.cuh `codes_cell`: (e, v) from codes x, y (int8) and the
    valid byte vb; e = Ematch[x][y] * v, 0 for a code outside 0..4."""
    x = torch.from_numpy(x.astype(np.int64))
    y = torch.from_numpy(y.astype(np.int64))
    v = torch.from_numpy(vb != 0).to(F32)
    ok = (x >= 0) & (x < 5) & (y >= 0) & (y < 5)
    em = torch.where(ok, table[(x * 5 + y).clamp(0, 24)], 0.0)
    return em * v, v


def byte_tiles(streams, d0, n, kt, b0, lpb):
    """The source's byte streams [D1, Wp, B] of a tile as mk::stage_bytes
    lays them out, one after another at kt Wp byte_stride(lpb) bytes."""
    out = []
    for s in streams:
        t = np.zeros(kt * s.shape[1] * byte_stride(lpb), np.uint8)
        tile = stage_bytes(s.numpy().reshape(-1, s.shape[2]),
                           d0 * s.shape[1], n * s.shape[1], b0, lpb)
        t[:len(tile)] = tile
        out.append(t)
    return np.concatenate(out) if out else None


def rescale(vals, inb):
    """The band max over the rows in the band and the five states (0 where
    none is positive), 1 where there is no mass; per lane [LPB]."""
    m = torch.stack(vals).where(inb, 0.0).amax(dim=(0, 2, 3)).clamp(min=0.0)
    return torch.where(m > 0, m, torch.ones_like(m))


def serve_backward_tiles(coef, chain, src, streams, fink, find, lpb=8):
    """(bm, bls, logZ) (and es for "codes_es") as the walk of S (src "es":
    streams (es,)) or serve_backward_kernel (src "emv": (em, valid);
    "codes" / "codes_es": (table, xb, yb, valid)) computes them, block by
    block."""
    C = Coef(coef, chain)
    first = streams[1] if src.startswith("codes") else streams[0]
    d1k, wp, B = first.shape
    rpt = -(-wp // 32)
    kt, SB = kt_of(rpt), byte_stride(lpb)
    stride, tb = kt * wp + 1, kt * wp * byte_stride(lpb)
    kk = torch.arange(32)
    rows = (rpt * kk[:, None] + torch.arange(rpt)[None, :])[None]  # 1,32,R
    inb = rows < wp
    kc = rows.clamp(max=wp - 1).numpy()
    w = torch.arange(lpb)[:, None, None]
    table = (torch.from_numpy(np.asarray(streams[0], np.float32))
             if src.startswith("codes") else None)
    bytes_in = list(streams[1:])  # valid; xb, yb, valid
    bm = torch.full((d1k, wp, B), NAN, dtype=F32)
    bls_out = torch.full((d1k, B), NAN, dtype=F32)
    es_out = torch.full((d1k, wp, B), NAN, dtype=F32)
    logZ = torch.full((B,), NAN, dtype=F32)
    up = torch.ones(lpb, dtype=torch.int64)
    for b0 in range(0, B, lpb):
        nl = min(lpb, B - b0)
        fd = torch.full((lpb, 1, 1), -1)
        fk = torch.full((lpb, 1, 1), -1)
        fd[:nl, 0, 0] = find[b0:b0 + nl].long()
        fk[:nl, 0, 0] = fink[b0:b0 + nl].long()
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        p1 = p2 = g1 = g2 = g3 = g4 = zero
        bls = torch.zeros(lpb, 1, 1, dtype=F32)
        cprev = torch.ones(lpb, 1, 1, dtype=F32)
        tiles = -(-d1k // kt)
        for u in range(tiles):
            d0 = (tiles - 1 - u) * kt
            n = min(kt, d1k - d0)
            plane = (stage_plane(streams[0], d0, kt, b0, lpb, False)
                     if src in ("es", "emv") else
                     torch.full((lpb * stride,), NAN, dtype=F32))
            planes = [plane, torch.full((lpb * stride,), NAN, dtype=F32)]
            bt = byte_tiles(bytes_in, d0, n, kt, b0, lpb)
            obls = torch.zeros(lpb, kt, dtype=F32)
            for kb in range(n - 1, -1, -1):
                d = d0 + kb
                off = torch.where(inb, kb * wp + rows, kt * wp)
                at = w * stride + off
                if src == "es":
                    x = torch.where(inb, plane[at], -1.0)
                    v = torch.where(x >= 0, 1.0, 0.0)
                    e = torch.clamp(x, min=0.0)
                else:
                    cb = (kb * wp + kc) * SB + w.numpy()
                    if src == "emv":
                        e = plane[at]
                        v = torch.from_numpy(bt[cb] != 0).to(F32)
                    else:
                        e, v = codes_cell(table, bt[cb].view(np.int8),
                                          bt[cb + tb].view(np.int8),
                                          bt[cb + 2 * tb])
                q0 = p2 / cprev if kb % 8 == 7 else p2
                q = [q0, g1, g2, g3, g4]
                inj = (d == fd) & (rows == fk)
                if C.chain:
                    acc0 = C.t00 * q[0]
                    for s in range(1, 5):
                        acc0 = acc0 + C.m0[s - 1] * q[s]
                    nb = [torch.where(inj, 1.0, acc0) * v]
                    for s in range(1, 5):
                        accs = q[0] + C.cb[s - 1] * q[s]
                        nb.append(torch.where(inj, C.r[s - 1], accs) * v)
                else:
                    injv = inj.to(F32)
                    nb = []
                    for s in range(5):
                        acc = q[0] * C.A[s][0]
                        for t in range(1, 5):
                            acc = acc + q[t] * C.A[s][t]
                        nb.append((acc + injv) * v)
                if kb % 8 == 0:
                    c = rescale(nb, inb)[:, None, None]
                    inv = 1.0 / c
                    nb = [y * inv for y in nb]
                    bls = bls + torch.log(c)
                    cprev = c
                sel = inb.expand(lpb, 32, rpt)
                planes[0][at[sel]] = nb[0][sel]
                if src == "codes_es":
                    planes[1][at[sel]] = (e - (1.0 - v))[sel]
                obls[:, kb] = bls[:, 0, 0]
                p2 = p1
                p1 = roll(e * nb[0], up, wp, rpt)
                g1, g3 = nb[1], nb[3]
                g2 = roll(nb[2], up, wp, rpt)
                g4 = roll(nb[4], up, wp, rpt)
            for j in range(nl):
                rows_j = slice(j * stride, j * stride + n * wp)
                bm[d0:d0 + n, :, b0 + j] = planes[0][rows_j].reshape(n, wp)
                es_out[d0:d0 + n, :, b0 + j] = planes[1][rows_j].reshape(
                    n, wp)
            bls_out[d0:d0 + n, b0:b0 + nl] = obls[:nl, :n].T
        # Row 0 is r = 0 of thread 0.
        z = [y[:, 0, 0] for y in nb]
        if C.chain:
            zr = z[0]
            for s in range(1, 5):
                zr = zr + C.tz[s - 1] * z[s]
        else:
            zr = (((z[0] + z[1]) + z[2]) + z[3]) + z[4]
        lz = torch.log(torch.clamp(0.2 * zr, min=1e-30)) + bls[:, 0, 0]
        logZ[b0:b0 + nl] = lz[:nl]
    out = (bm, bls_out, logZ)
    return out + (es_out,) if src == "codes_es" else out


def serve_post_tiles(coef, chain, src, streams, bm, bls, logZ, lpb=8,
                     tma=True):
    """The circular posterior band as serve_post_kernel computes it over
    source src ("es": streams (es,); "emv": (em, valid); "codes": (table,
    xb, yb, valid)), block by block, its float bands staged by TMA or by
    cp.async."""
    C = Coef(coef, chain)
    d1k, wp, B = bm.shape
    rpt = -(-wp // 32)
    kt, SB = kt_of(rpt, lpb), byte_stride(lpb)
    stride, tb = kt * wp + 1, kt * wp * byte_stride(lpb)
    kk = torch.arange(32)
    rows = (kk[None, :] + 32 * torch.arange(rpt)[:, None])[None]  # 1,R,32
    inb = rows < wp
    kc = rows.clamp(max=wp - 1)
    w = torch.arange(lpb)[:, None, None]
    table = (torch.from_numpy(np.asarray(streams[0], np.float32))
             if src == "codes" else None)
    bytes_in = list(streams[1:])  # valid; xb, yb, valid
    post = torch.full((d1k, wp, B), NAN, dtype=F32)
    for b0 in range(0, B, lpb):
        nl = min(lpb, B - b0)
        lz = torch.zeros(lpb, 1, 1, dtype=F32)
        lz[:nl, 0, 0] = logZ[b0:b0 + nl]
        zero = torch.zeros(lpb, rpt, 32, dtype=F32)
        mm1 = mm2 = g1 = g2 = g3 = g4 = zero
        ls = torch.zeros(lpb, 1, 1, dtype=F32)
        cprev = torch.ones(lpb, 1, 1, dtype=F32)
        for d0 in range(0, d1k, kt):
            n = min(kt, d1k - d0)
            bands = ([streams[0]] if src != "codes" else []) + [bm]
            planes = [stage_plane(x, d0, kt, b0, lpb, tma) for x in bands]
            bt = byte_tiles(bytes_in, d0, n, kt, b0, lpb)
            bls_t = torch.zeros(lpb, kt, dtype=F32)
            bls_t[:nl, :n] = bls[d0:d0 + n, b0:b0 + nl].T
            out = torch.full((lpb * stride,), NAN, dtype=F32)
            for kb in range(n):
                d = d0 + kb
                if kb % 8 == 0:
                    # The period's scales, ls as it stands at its start.
                    scale = torch.exp(ls[:, :, 0] + bls_t[:, kb:kb + 8] - lz[
                        :, :, 0])
                alpha = scale[:, kb % 8][:, None, None]
                q = kb * wp + kc
                at = swizzled(q, w, lpb) if tma else w * stride + q
                if d == 0:
                    origin = rows == 0
                    f = [torch.where(origin, 0.2, 0.0).to(F32).expand(
                        lpb, rpt, 32)]
                    f += [torch.where(origin, C.pi[s - 1] if C.chain
                                      else 0.2, 0.0).to(F32).expand(
                        lpb, rpt, 32) for s in range(1, 5)]
                else:
                    if src == "es":
                        x = planes[0][at]
                        v = torch.where(x >= 0, 1.0, 0.0)
                        e = torch.clamp(x, min=0.0)
                    else:
                        cb = ((kb * wp + kc) * SB + w).numpy()
                        if src == "emv":
                            e = planes[0][at]
                            v = torch.from_numpy(bt[cb] != 0).to(F32)
                        else:
                            e, v = codes_cell(table, bt[cb].view(np.int8),
                                              bt[cb + tb].view(np.int8),
                                              bt[cb + 2 * tb])
                    mm = mm2 / cprev if kb % 8 == 0 else mm2
                    f = [e * mm, g1 * v, g2 * v, g3 * v, g4 * v]
                    if kb % 8 == 7:
                        c = rescale(f, inb)[:, None, None]
                        inv = 1.0 / c
                        f = [y * inv for y in f]
                        ls = ls + torch.log(c)
                        cprev = c
                        alpha = torch.exp(ls + bls_t[:, kb][:, None, None]
                                          - lz)
                p = f[0] * planes[-1][at] * alpha
                cell = (w * stride + kb * wp + rows).expand(p.shape)
                sel = inb.expand(p.shape)
                out[cell[sel]] = p[sel]
                if C.chain:
                    mm = C.t00 * f[0]
                    for s in range(1, 5):
                        mm = mm + C.mc[s - 1] * f[s]
                    g = [f[0] + C.cc[t - 1] * f[t] for t in range(1, 5)]
                else:
                    mm = f[0] * C.A[0][0]
                    for s in range(1, 5):
                        mm = mm + f[s] * C.A[s][0]
                    g = []
                    for t in range(1, 5):
                        acc = f[0] * C.A[0][t]
                        for s in range(1, 5):
                            acc = acc + f[s] * C.A[s][t]
                        g.append(acc)
                g1, g3 = g[0], g[2]
                mm2 = mm1
                mm1 = roll_down(mm, wp)
                g2 = roll_down(g[1], wp)
                g4 = roll_down(g[3], wp)
            for j in range(nl):
                post[d0:d0 + n, :, b0 + j] = out[
                    j * stride:j * stride + n * wp].reshape(n, wp)
    return post


def same_bits(got, want):
    """Bit for bit, NaN included."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def random_case(d1k, wp, B, chain_model, seed, final_d=None,
                invalid_lanes=()):
    """(coef, chain, table, xb, yb, valid, em, es, fink, find) at random:
    codes in -1..5 (some outside 0..4, which emit 0), 75% valid cells (none
    in `invalid_lanes`), es and em of the codes as ops/fb_circ.py
    `emission_stream` makes them, terminals on any row and at d = 0,
    d1k - 1, a rescale edge, a tile edge or anywhere (or all at
    final_d)."""
    rng = np.random.default_rng(seed)
    tables = _tables(chain_model)
    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.numpy().reshape(-1)
    xb = torch.from_numpy(rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8))
    yb = torch.from_numpy(rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8))
    valid = rng.random((d1k, wp, B)) < 0.75
    valid[..., list(invalid_lanes)] = False
    valid = torch.from_numpy(valid.astype(np.int8))
    em = emission_stream(table, xb, yb, valid, False)
    es = emission_stream(table, xb, yb, valid, True)
    if final_d is None:
        find = rng.integers(0, d1k, B)
        find[::5] = 0
        find[1::5] = d1k - 1
        find[2::5] = min(8, d1k - 1)
        find[3::5] = min(16, d1k - 1)
    else:
        find = np.full(B, final_d)
    fink = rng.integers(0, wp, B)
    return (coef, chain, table, xb, yb, valid, em, es,
            torch.from_numpy(fink.astype(np.int32)),
            torch.from_numpy(find.astype(np.int32)))


def _tables(chain_model):
    return tables_from_jax(_jax_tables("gap_chain" if chain_model
                                       else "non_chain"))


# The backwards (S's es source too) and forwards by source: the plain
# version's name and its stream arguments from random_case's tuple.
BACKWARDS = {
    "es": ("sv_backward", lambda c: (c[7],)),
    "emv": ("circ_backward_emv", lambda c: (c[6], c[5])),
    "codes": ("circ_backward_codes", lambda c: (c[2], c[3], c[4], c[5])),
    "codes_es": ("circ_backward_codes_es",
                 lambda c: (c[2], c[3], c[4], c[5])),
}
FORWARDS = {
    "es": ("circ_post_es", lambda c: (c[7],)),
    "emv": ("circ_post_emv", lambda c: (c[6], c[5])),
    "codes": ("circ_post_codes", lambda c: (c[2], c[3], c[4], c[5])),
}


def assert_plain(case_, lpb, tma, sources=("emv", "codes", "codes_es")):
    """Each backward source of `sources` and each forward source, against
    their plain versions bit for bit; the forwards on the plain S's
    outputs (which every backward source equals)."""
    coef, chain = case_[:2]
    fink, find = case_[8:]
    for src in sources:
        name, streams = BACKWARDS[src]
        got = serve_backward_tiles(coef, chain, src, streams(case_), fink,
                                   find, lpb if src == "es" else 8)
        want = getattr(K, name + "_plain")(coef, chain, *streams(case_),
                                           fink, find)
        for g, x in zip(got, want):
            assert same_bits(g, x), (src, (g - x).abs().max())
    back = K.sv_backward_plain(coef, chain, case_[7], fink, find)
    for src, (name, streams) in FORWARDS.items():
        got = serve_post_tiles(coef, chain, src, streams(case_), *back,
                               lpb=lpb, tma=tma)
        want = getattr(K, name + "_plain")(coef, chain, *streams(case_),
                                           *back)
        assert same_bits(got, want), (src, (got - want).abs().max())


@pytest.mark.parametrize("lpb,wp,tma,chain", [
    (8, 24, True, True), (8, 24, False, False), (16, 24, True, False),
    (16, 24, False, True), (8, 48, True, True), (16, 64, False, False),
    (8, 96, False, True), (8, 128, False, False)],
    ids=["8-24-tma-chain", "8-24-cp_async-generic", "16-24-tma-generic",
         "16-24-cp_async-chain", "8-48-tma-chain", "16-64-cp_async-generic",
         "8-96-cp_async-chain", "8-128-cp_async-generic"])
def test_serve_tiles_match_plain_random(lpb, wp, tma, chain):
    """One to four rows a thread (tiles of 16, 8, 8 and 8 diagonals, 8 at
    16 lanes a block; TMA at up to two rows a thread, 16 lanes a block too,
    as csrc/fb_serve.cu `sp_tma` and `sp_setup` take them), both model
    branches, 19 lanes (a partial block), 37 diagonals (a partial tile at
    either end), codes outside 0..4."""
    assert_plain(random_case(37, wp, 19, chain, seed=wp + lpb), lpb, tma)


def test_sv_tiles_match_plain():
    """S is the walk's signed-stream instance: the same model, source es,
    equals sv_backward_plain at one and two rows a thread, 16 and 8 lanes
    a block."""
    for wp, lpb in ((24, 16), (40, 8)):
        assert_plain(random_case(29, wp, 11, True, seed=wp), lpb, False,
                     sources=("es",))


@pytest.mark.parametrize("lpb", [8, 16])
def test_serve_tiles_edges(lpb):
    """Every terminal at d = 0; a third of the lanes with no valid cell;
    one, two and nine diagonals."""
    assert_plain(random_case(20, 24, 13, True, seed=1, final_d=0), lpb, True)
    assert_plain(random_case(20, 24, 13, False, seed=2,
                             invalid_lanes=range(0, 13, 3)), lpb, False)
    for d1k in (1, 2, 9):
        assert_plain(random_case(d1k, 24, 9, True, seed=d1k), lpb, True)


def serve_tiles(tables, cdev, mode, lpb, tma):
    """(logZ, circular posterior) of serving mode `mode` (sv, em, lean,
    emw) through the tile models, as ops/fb_circ.py `posteriors_circ`
    chains the kernels."""
    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.numpy().reshape(-1)
    xb, yb, fink, find = cdev.xb, cdev.yb, cdev.fink, cdev.final_d
    valid = cdev.valid.view(torch.int8)
    codes = (table, xb, yb, valid)
    if mode == "sv":
        src, streams = "es", (emission_stream(table, xb, yb, cdev.valid,
                                              True),)
    elif mode == "em":
        src, streams = "emv", (emission_stream(table, xb, yb, cdev.valid,
                                               False), valid)
    else:
        src, streams = ("codes" if mode == "lean" else "codes_es"), codes
    back = serve_backward_tiles(coef, chain, src, streams, fink, find, 8)
    bm, bls, logZ = back[:3]
    if mode == "emw":
        src, streams = "es", (back[3],)
    elif mode == "lean":
        src = "codes"
    post = serve_post_tiles(coef, chain, src, streams, bm, bls, logZ,
                            lpb=lpb, tma=tma)
    return logZ, post


@pytest.mark.parametrize("mode,lpb,tma", [
    ("sv", 8, True), ("em", 16, False), ("lean", 8, False),
    ("emw", 16, True)])
def test_serve_tiles_match_pallas(case, mode, lpb, tma):  # noqa: F811
    """On packed synthetic reads (tests/test_torch_fb_serve.py's batch),
    each mode's tile models agree with the JAX package's
    `posteriors_pallas_circ` (its jitted body) in interpret mode and equal
    the port's plain route bit for bit."""
    batch, cdev = case["batch"], case["cdev"]
    jtables = _jax_tables("gap_chain")
    tables = tables_from_jax(jtables)
    logZ, post = serve_tiles(tables, cdev, mode, lpb, tma)
    rlogZ, rpost = posteriors_circ(tables, cdev, mode)
    assert same_bits(logZ, rlogZ) and same_bits(post, rpost)
    jitted = fp._posteriors_circ_static.lower(
        fp.static_tables(jtables), case["jcdev"], mode=mode).compile(
            compiler_options=FAST_COMPILE)
    jlogZ, jpost = (np.asarray(a) for a in jitted(case["jcdev"]))
    live = (batch.m + batch.n) > 0
    valid = cdev.valid.numpy().astype(bool)
    assert np.allclose(logZ.numpy()[live], jlogZ[live], rtol=1e-4,
                       atol=1e-4)
    assert np.abs(post.numpy() - jpost)[valid].max() <= 2e-4
