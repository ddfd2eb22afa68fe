"""The tile scheme of the checkpoint pair's CUDA kernels, checked where
there is no card: csrc/fb_ckpt.cu `ckpt_backward_kernel`
(circ_ckpt_backward) and `ckpt_post_kernel` (circ_ckpt_post).

The backward is S's walk over the codes (csrc/fb_circ.cuh `SvWarp` in its
checkpoint mode): a lane a warp, `ceil(Wp / 32)` consecutive band rows a
thread (mk::WarpRows: row k = RPT kk + r), tiles of KT descending
diagonals (16 at one row a thread, else 8) of the byte streams xb, yb and
valid staged in a ring of two buffers, 8 lanes a block.  Blocks of KB
diagonals start on tile boundaries, and before the top tile of each block
every thread puts its rows of the checkpoint from its registers into a
shared-memory buffer that the block writes out after the next barrier:
p1, p2 and gap states 2 and 4 are held rolled up one row, so row k goes
to row k + 1 mod Wp.  No b_M and no bls leave.

The posterior pass stages each block of KB diagonals once (the lanes'
checkpoints and the block's byte tiles, KB / KT sub-tiles of the
backward's layout); a replay restores the checkpoint into S's registers
(rolled rows as publish leaves them, rows past the band zero) and steps
the block's diagonals down into a per-lane tile of bm rows [KB][Wp] (odd
stride) and bls [KB]; the forward (M's layout, row k = kk + 32 r:
`WarpForward`) runs the block's diagonals up over that tile, writing each
posterior over the b_M it used, its scale exp(ls + bls - logZ) computed
once a rescale period and again after the period's rescale; the tile
leaves as lane rows.  In the pipelined version (a replay and a forward
warp a lane, 8 or 4 lanes a block) phase p replays block p, runs the
forward of block p - 1, flushes block p - 2 and stages block p + 1, in
three stage and three tile buffers; in the sequential version (one warp a
lane replays, then runs the forward; 16 lanes a block where the lanes
outnumber what the card holds) phase p flushes block p - 1 and stages
block p + 1, in two of each.  Here both kernels
run in torch (float32, the kernels' order of operations), a block of LPB
lanes at a time with the lanes past B idle, the buffers reused in the
kernel's order (the pipelined forward runs before the replay of its phase,
so a buffer the two roles shared would show).

The models are held bit for bit to the plain versions (ck, cs, logZ and
post) at one to four rows a thread, KB 8, 16 and 32, 16, 8 and 4 lanes a
block, both versions of the posterior pass and both model branches, over
lane counts that are no multiple of a block and diagonal counts that are
no multiple of KB or of a tile, with terminals at d = 0, lanes with no
valid cell and codes outside 0..4; and, on packed synthetic reads, to the
JAX package's `posteriors_pallas_circ` in its "ckpt" mode in interpret
mode (logZ rtol / atol 1e-4, posteriors atol 2e-4, the JAX tests'
tolerances; compiled without XLA's fusion pass at 8 diagonals a
checkpoint, as tests/test_torch_fb_serve.py compiles it).
"""
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu_torch.ops import fb_circ_cuda as K
from marginalign_trna_tpu_torch.ops.fb import tables_from_jax
from marginalign_trna_tpu_torch.ops.fb_circ import (
    circ_coefficients, posteriors_circ,
)

from test_torch_fb_serve import FAST_COMPILE, _jax_tables
from test_torch_fb_serve import case  # noqa: F401  (fixture)
from test_torch_mea_warp_tiles import roll
from test_torch_serve_warp_tiles import (
    Coef, byte_tiles, codes_cell, random_case, rescale, same_bits,
)
from test_torch_warp_tiles import byte_stride, roll_down

F32 = torch.float32
NAN = float("nan")


def kt_of(rpt):
    """csrc/fb_circ.cuh `sv_kt`: diagonals a tile of S's walk, the
    checkpoint backward's ring and the posterior pass's sub-tiles."""
    return 16 if rpt == 1 else 8


class Back:
    """A block's backward registers in S's layout: p1, p2, g1..g4
    [LPB, 32, RPT] (p1, p2, g2, g4 rolled up one row), bls and cprev
    [LPB, 1, 1]."""

    def __init__(self, lpb, rpt):
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        self.p1 = self.p2 = self.g1 = self.g2 = self.g3 = self.g4 = zero
        self.bls = torch.zeros(lpb, 1, 1, dtype=F32)
        self.cprev = torch.ones(lpb, 1, 1, dtype=F32)
        self.nb = None


def back_step(C, st, e, v, d, kb, fd, fk, rows, inb, wp, rpt):
    """SvWarp::step: generation d (tile row kb) from the registers, its
    rescale at d % 8 == 0, the rolled publish; returns nb."""
    lpb = e.shape[0]
    q0 = st.p2 / st.cprev if kb % 8 == 7 else st.p2
    q = [q0, st.g1, st.g2, st.g3, st.g4]
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
        st.bls = st.bls + torch.log(c)
        st.cprev = c
    up = torch.ones(lpb, dtype=torch.int64)
    st.p2 = st.p1
    st.p1 = roll(e * nb[0], up, wp, rpt)
    st.g1, st.g3 = nb[1], nb[3]
    st.g2 = roll(nb[2], up, wp, rpt)
    st.g4 = roll(nb[4], up, wp, rpt)
    st.nb = nb
    return nb


def back_cells(table, bt, kb, wp, kc, w, lpb, kt):
    """(e, v) of S's rows at tile row kb from a sub-tile's byte tiles bt
    (rows past the band read row Wp - 1's bytes)."""
    SB, tb = byte_stride(lpb), kt * wp * byte_stride(lpb)
    cb = (kb * wp + kc) * SB + w
    return codes_cell(table, bt[cb].view(np.int8), bt[cb + tb].view(np.int8),
                      bt[cb + 2 * tb])


def layouts(wp, lpb):
    """S's rows (k = RPT kk + r) [1, 32, RPT], those in the band, their
    byte rows, the lane index [LPB, 1, 1]; M's rows (k = kk + 32 r)
    [1, RPT, 32], those in the band, their byte rows."""
    rpt = -(-wp // 32)
    kk = torch.arange(32)
    srows = (rpt * kk[:, None] + torch.arange(rpt)[None, :])[None]
    frows = (kk[None, :] + 32 * torch.arange(rpt)[:, None])[None]
    w = torch.arange(lpb)[:, None, None]
    return (srows, srows < wp, srows.clamp(max=wp - 1).numpy(), w.numpy(),
            frows, frows < wp, frows.clamp(max=wp - 1).numpy())


def lane_ends(fink, find, b0, lpb):
    nl = min(lpb, fink.shape[0] - b0)
    fd = torch.full((lpb, 1, 1), -1)
    fk = torch.full((lpb, 1, 1), -1)
    fd[:nl, 0, 0] = find[b0:b0 + nl].long()
    fk[:nl, 0, 0] = fink[b0:b0 + nl].long()
    return nl, fd, fk


def ckpt_backward_tiles(coef, chain, table, xb, yb, valid, fink, find, kb,
                        lpb=8):
    """(ck, cs, logZ) as ckpt_backward_kernel computes them, block by
    block: tiles from the top in a ring of two byte buffers, checkpoint g
    written from the rolled registers before the top tile of block g."""
    C = Coef(coef, chain)
    d1k, wp, B = xb.shape
    rpt = -(-wp // 32)
    kt = kt_of(rpt)
    assert kb % kt == 0
    srows, sin, skc, w, *_ = layouts(wp, lpb)
    tab = torch.from_numpy(np.asarray(table, np.float32))
    G = -(-d1k // kb)
    ck = torch.full((G, 6, wp, B), NAN, dtype=F32)
    cs = torch.full((G, 2, B), NAN, dtype=F32)
    logZ = torch.full((B,), NAN, dtype=F32)
    tiles = -(-d1k // kt)

    def first(u):
        return (tiles - 1 - u) * kt

    def count(u):
        return min(kt, d1k - first(u))

    sel = sin.expand(lpb, 32, rpt)
    k = srows.expand(lpb, 32, rpt)
    lane = torch.arange(lpb)[:, None, None].expand(lpb, 32, rpt)
    for b0 in range(0, B, lpb):
        nl, fd, fk = lane_ends(fink, find, b0, lpb)
        st = Back(lpb, rpt)
        ring = [None, None]
        ring[0] = byte_tiles((xb, yb, valid), first(0), count(0), kt, b0, lpb)
        for u in range(tiles):
            if u + 1 < tiles:
                ring[(u + 1) % 2] = byte_tiles((xb, yb, valid), first(u + 1),
                                               count(u + 1), kt, b0, lpb)
            d0, n = first(u), count(u)
            if (d0 + n) % kb == 0 or d0 + n == d1k:
                g = d0 // kb
                ku = (k + 1) % wp
                live = sel & (lane < nl)
                bl = b0 + lane[live]
                for s, (x, rolled) in enumerate((
                        (st.p1, True), (st.p2, True), (st.g1, False),
                        (st.g2, True), (st.g3, False), (st.g4, True))):
                    ck[g, s][(ku if rolled else k)[live], bl] = x[live]
                cs[g, 0, b0:b0 + nl] = st.bls[:nl, 0, 0]
                cs[g, 1, b0:b0 + nl] = st.cprev[:nl, 0, 0]
            bt = ring[u % 2]
            for kk in range(n - 1, -1, -1):
                e, v = back_cells(tab, bt, kk, wp, skc, w, lpb, kt)
                back_step(C, st, e, v, d0 + kk, kk, fd, fk, srows, sin, wp,
                          rpt)
        z = [y[:, 0, 0] for y in st.nb]
        if C.chain:
            zr = z[0]
            for s in range(1, 5):
                zr = zr + C.tz[s - 1] * z[s]
        else:
            zr = (((z[0] + z[1]) + z[2]) + z[3]) + z[4]
        lz = torch.log(torch.clamp(0.2 * zr, min=1e-30)) + st.bls[:, 0, 0]
        logZ[b0:b0 + nl] = lz[:nl]
    return ck, cs, logZ


def restore(c, wp, rpt, srows, sin):
    """restore_ckpt: S's registers from the lanes' staged checkpoints c
    [LPB, 6 Wp + 2]: row k's own values, p1, p2, g2, g4 from row k + 1 mod
    Wp; rows past the band zero."""
    lpb = c.shape[0]
    st = Back(lpb, rpt)
    k = torch.where(sin, srows, 0).expand(lpb, 32, rpt)
    ku = torch.where(sin & (srows + 1 < wp), srows + 1, 0).expand(
        lpb, 32, rpt)

    def plane(s, idx):
        x = c[:, s * wp:(s + 1) * wp].gather(
            1, idx.reshape(lpb, -1)).reshape(lpb, 32, rpt)
        return torch.where(sin, x, 0.0)

    st.p1, st.p2 = plane(0, ku), plane(1, ku)
    st.g1, st.g2 = plane(2, k), plane(3, ku)
    st.g3, st.g4 = plane(4, k), plane(5, ku)
    st.bls = c[:, 6 * wp][:, None, None].clone()
    st.cprev = c[:, 6 * wp + 1][:, None, None].clone()
    return st


class Fwd:
    """A block's forward registers in M's layout [LPB, RPT, 32]."""

    def __init__(self, lpb, rpt, lz):
        zero = torch.zeros(lpb, rpt, 32, dtype=F32)
        self.mm1 = self.mm2 = self.g1 = self.g2 = self.g3 = self.g4 = zero
        self.ls = torch.zeros(lpb, 1, 1, dtype=F32)
        self.cprev = torch.ones(lpb, 1, 1, dtype=F32)
        self.lz = lz


def fwd_step(C, ft, table, bt, d, kb, alpha, wp, rpt, frows, fin, fkc, w,
             lpb, kt):
    """CkForward::step: generation d (sub-tile diagonal kb) of M's
    recursion from the codes in byte tiles bt; returns (f, alpha)."""
    SB, tb = byte_stride(lpb), kt * wp * byte_stride(lpb)
    C_ = C
    if d == 0:
        origin = frows == 0
        f = [torch.where(origin, 0.2, 0.0).to(F32).expand(lpb, rpt, 32)]
        f += [torch.where(origin, C_.pi[s - 1] if C_.chain else 0.2,
                          0.0).to(F32).expand(lpb, rpt, 32)
              for s in range(1, 5)]
    else:
        cb = (kb * wp + fkc) * SB + w
        e, v = codes_cell(table, bt[cb].view(np.int8),
                          bt[cb + tb].view(np.int8), bt[cb + 2 * tb])
        mm = ft.mm2 / ft.cprev if kb % 8 == 0 else ft.mm2
        f = [e * mm, ft.g1 * v, ft.g2 * v, ft.g3 * v, ft.g4 * v]
        if kb % 8 == 7:
            c = rescale(f, fin)[:, None, None]
            inv = 1.0 / c
            f = [y * inv for y in f]
            ft.ls = ft.ls + torch.log(c)
            ft.cprev = c
            alpha = None
    return f, alpha


def fwd_publish(C, ft, f, wp):
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
    ft.g1, ft.g3 = g[0], g[2]
    ft.mm2 = ft.mm1
    ft.mm1 = roll_down(mm, wp)
    ft.g2 = roll_down(g[1], wp)
    ft.g4 = roll_down(g[3], wp)


def ckpt_post_tiles(coef, chain, table, xb, yb, valid, fink, find, ck, cs,
                    logZ, kb, lpb=8, pipe=True):
    """The circular posterior band as ckpt_post_kernel computes it, block by
    block, in its phases: the pipelined version (pipe: replay block p,
    forward block p - 1, flush p - 2, stage p + 1; three buffers each) or
    the sequential one (replay and forward block p, flush p - 1, stage
    p + 1; two each)."""
    C = Coef(coef, chain)
    d1k, wp, B = xb.shape
    rpt = -(-wp // 32)
    kt = kt_of(rpt)
    assert kb % kt == 0
    SB = byte_stride(lpb)
    srows, sin, skc, w, frows, fin, fkc = layouts(wp, lpb)
    tab = torch.from_numpy(np.asarray(table, np.float32))
    G = -(-d1k // kb)
    nbuf, lag = (3, 1) if pipe else (2, 0)
    tstride, crows = kb * wp + 1, 6 * wp + 2
    post = torch.full((d1k, wp, B), NAN, dtype=F32)

    def count(g):
        return min(kb, d1k - g * kb)

    ssel = sin.expand(lpb, 32, rpt)
    fsel = fin.expand(lpb, rpt, 32)
    lanes = torch.arange(lpb)[:, None, None]
    for b0 in range(0, B, lpb):
        nl, fd, fk = lane_ends(fink, find, b0, lpb)
        lz = torch.zeros(lpb, 1, 1, dtype=F32)
        lz[:nl, 0, 0] = logZ[b0:b0 + nl]
        stages = [None] * nbuf
        tiles = [torch.full((lpb * (tstride + kb),), NAN, dtype=F32)
                 for _ in range(nbuf)]

        def stage(g):
            c = torch.full((lpb, crows), NAN, dtype=F32)
            for j in range(nl):
                c[j, :6 * wp] = ck[g, :, :, b0 + j].reshape(-1)
                c[j, 6 * wp:] = cs[g, :, b0 + j]
            lo, n = g * kb, count(g)
            subs = [byte_tiles((xb, yb, valid), lo + j * kt,
                               min(kt, n - j * kt), kt, b0, lpb)
                    for j in range(-(-n // kt))]
            stages[g % nbuf] = (c, np.concatenate(subs))

        def flush(g):
            t, n = tiles[g % nbuf], count(g)
            for j in range(nl):
                post[g * kb:g * kb + n, :, b0 + j] = t[
                    j * tstride:j * tstride + n * wp].reshape(n, wp)

        def replay(g):
            c, bt = stages[g % nbuf]
            t = tiles[g % nbuf]
            st = restore(c, wp, rpt, srows, sin)
            lo, n = g * kb, count(g)
            for j in range((n - 1) // kt, -1, -1):
                sub = bt[j * 3 * kt * wp * SB:(j + 1) * 3 * kt * wp * SB]
                for kk in range(min(kt, n - j * kt) - 1, -1, -1):
                    e, v = back_cells(tab, sub, kk, wp, skc, w, lpb, kt)
                    nb = back_step(C, st, e, v, lo + j * kt + kk, kk, fd, fk,
                                   srows, sin, wp, rpt)
                    at = (lanes * tstride + (j * kt + kk) * wp + srows) \
                        .expand(lpb, 32, rpt)
                    t[at[ssel]] = nb[0][ssel]
                    t[lpb * tstride + torch.arange(lpb) * kb + j * kt + kk] \
                        = st.bls[:, 0, 0]

        ft = Fwd(lpb, rpt, lz)

        def forward(g):
            _, bt = stages[g % nbuf]
            t = tiles[g % nbuf]
            lo, n = g * kb, count(g)
            for j in range(-(-n // kt)):
                sub = bt[j * 3 * kt * wp * SB:(j + 1) * 3 * kt * wp * SB]
                bls = t[lpb * tstride + torch.arange(lpb)[:, None] * kb
                        + j * kt + torch.arange(kt)[None, :]]
                for kk in range(min(kt, n - j * kt)):
                    d = lo + j * kt + kk
                    if kk % 8 == 0:
                        # The period's scales, ls as it stands at its start.
                        scale = torch.exp(ft.ls[:, :, 0] + bls[:, kk:kk + 8]
                                          - ft.lz[:, :, 0])
                    alpha = scale[:, kk % 8][:, None, None]
                    f, a = fwd_step(C, ft, tab, sub, d, kk, alpha, wp, rpt,
                                    frows, fin, fkc, w, lpb, kt)
                    if a is None:
                        alpha = torch.exp(ft.ls + bls[:, kk][:, None, None]
                                          - ft.lz)
                    at = (lanes * tstride + (j * kt + kk) * wp + frows) \
                        .expand(lpb, rpt, 32)
                    p = f[0] * t[at] * alpha
                    t[at[fsel]] = p[fsel]
                    fwd_publish(C, ft, f, wp)

        stage(0)
        for p in range(G + lag):
            if p - lag - 1 >= 0:
                flush(p - lag - 1)
            if p + 1 < G:
                stage(p + 1)
            if pipe:
                if p >= 1:
                    forward(p - 1)
                if p < G:
                    replay(p)
            else:
                replay(p)
                forward(p)
        flush(G - 1)
    return post


def assert_plain(case_, kb, lpb, pipe):
    """Both models against the plain versions bit for bit: the backward on
    the case's codes, the posterior pass on the plain backward's
    checkpoints."""
    coef, chain, table, xb, yb, valid = case_[:6]
    fink, find = case_[8:]
    codes = (coef, chain, table, xb, yb, valid)
    want = K.circ_ckpt_backward_plain(*codes, fink, find, kb)
    got = ckpt_backward_tiles(*codes, fink, find, kb)
    for name, g, x in zip(("ck", "cs", "logZ"), got, want):
        assert same_bits(g, x), (name, (g - x).abs().max())
    post = ckpt_post_tiles(*codes, fink, find, *want, kb, lpb=lpb, pipe=pipe)
    wpost = K.circ_ckpt_post_plain(*codes, fink, find, *want, kb)
    assert same_bits(post, wpost), (post - wpost).abs().max()


@pytest.mark.parametrize("wp,kb,lpb,pipe,chain", [
    (24, 32, 8, True, True), (24, 16, 16, False, False),
    (32, 16, 8, True, False), (40, 16, 16, False, True),
    (48, 8, 8, True, True), (64, 32, 4, True, False),
    (96, 32, 4, True, True), (128, 8, 4, True, False)],
    ids=["24-kb32-pipe-chain", "24-kb16-seq16-generic",
         "32-kb16-pipe-generic", "40-kb16-seq16-chain", "48-kb8-pipe-chain",
         "64-kb32-4lanes-generic", "96-kb32-4lanes-chain",
         "128-kb8-4lanes-generic"])
def test_ckpt_tiles_match_plain_random(wp, kb, lpb, pipe, chain):
    """One to four rows a thread (tiles of 16 diagonals at one row, else
    8), KB 8, 16 and 32, the pipelined posterior pass at 8 and 4 lanes a
    block and the sequential one at 16, both model branches, 19 lanes (a
    partial block), 45 diagonals (no multiple of KB or of a tile), codes
    outside 0..4."""
    assert_plain(random_case(45, wp, 19, chain, seed=wp + kb), kb, lpb, pipe)


@pytest.mark.parametrize("pipe", [True, False])
def test_ckpt_tiles_edges(pipe):
    """Every terminal at d = 0; a third of the lanes with no valid cell;
    one, two, nine and 32 diagonals (one block: the pipeline only fills)
    and 33 (two blocks); pipelined at 8 lanes, sequential at 16."""
    lpb = 8 if pipe else 16
    assert_plain(random_case(40, 24, 13, True, seed=1, final_d=0), 32, lpb,
                 pipe)
    assert_plain(random_case(40, 24, 13, False, seed=2,
                             invalid_lanes=range(0, 13, 3)), 16, lpb, pipe)
    for d1k in (1, 2, 9, 32, 33):
        assert_plain(random_case(d1k, 24, 9, True, seed=d1k), 32, lpb, pipe)


def test_ckpt_restore_rows_past_band():
    """At Wp 41 and 72 (rows past the band on the last thread: row Wp - 1
    is no thread's last row) the restored registers equal the registers
    the backward held when it saved them on every row in the band."""
    for wp, rpt in ((41, 2), (72, 3)):
        rng = np.random.default_rng(wp)
        srows, sin, *_ = layouts(wp, 4)
        st = Back(4, rpt)
        for name in ("p1", "p2", "g1", "g2", "g3", "g4"):
            setattr(st, name, torch.from_numpy(
                rng.random((4, 32, rpt)).astype(np.float32)))
        c = torch.full((4, 6 * wp + 2), NAN, dtype=F32)
        k = srows.expand(4, 32, rpt)
        ku = (k + 1) % wp
        lane = torch.arange(4)[:, None, None].expand(4, 32, rpt)
        sel = sin.expand(4, 32, rpt)
        for s, (x, rolled) in enumerate((
                (st.p1, True), (st.p2, True), (st.g1, False),
                (st.g2, True), (st.g3, False), (st.g4, True))):
            c[lane[sel], s * wp + (ku if rolled else k)[sel]] = x[sel]
        c[:, 6 * wp:] = 1.0
        got = restore(c, wp, rpt, srows, sin)
        for name in ("p1", "p2", "g1", "g2", "g3", "g4"):
            g, x = getattr(got, name), getattr(st, name)
            assert torch.equal(g[sel], x[sel]), (wp, name)
            assert torch.equal(g[~sel], torch.zeros_like(g[~sel]))


@pytest.mark.parametrize("chain_model,pipe", [(True, True), (False, False)])
def test_ckpt_tiles_match_pallas(case, chain_model, pipe,  # noqa: F811
                                 monkeypatch):
    """On packed synthetic reads (tests/test_torch_fb_serve.py's batch),
    the tile models (pipelined at 8 lanes, sequential at 16) at the port's
    KB (32 at Wp 24) agree with the JAX
    package's `posteriors_pallas_circ(mode="ckpt")` (its jitted body) in
    interpret mode at its 8 diagonals a checkpoint, and equal the port's
    plain "ckpt" route bit for bit."""
    monkeypatch.setattr(fp, "_CKPT_BLOCK", 8)
    batch, cdev = case["batch"], case["cdev"]
    jtables = _jax_tables("gap_chain" if chain_model else "non_chain")
    tables = tables_from_jax(jtables)
    coef, chain = circ_coefficients(tables)
    assert chain == chain_model
    table = tables.Ematch.numpy().reshape(-1)
    codes = (coef, chain, table, cdev.xb, cdev.yb, cdev.valid.view(
        torch.int8))
    kb = K.ckpt_block(cdev.xb.shape[1])
    assert kb == 32
    ck = ckpt_backward_tiles(*codes, cdev.fink, cdev.final_d, kb)
    post = ckpt_post_tiles(*codes, cdev.fink, cdev.final_d, *ck, kb,
                           lpb=8 if pipe else 16, pipe=pipe)
    logZ = ck[2]
    rlogZ, rpost = posteriors_circ(tables, cdev, "ckpt")
    assert same_bits(logZ, rlogZ) and same_bits(post, rpost)
    jitted = fp._posteriors_circ_static.lower(
        fp.static_tables(jtables), case["jcdev"], mode="ckpt").compile(
            compiler_options=FAST_COMPILE)
    jlogZ, jpost = (np.asarray(a) for a in jitted(case["jcdev"]))
    live = (batch.m + batch.n) > 0
    valid = cdev.valid.numpy().astype(bool)
    assert np.allclose(logZ.numpy()[live], jlogZ[live], rtol=1e-4,
                       atol=1e-4)
    assert np.abs(post.numpy() - jpost)[valid].max() <= 2e-4
