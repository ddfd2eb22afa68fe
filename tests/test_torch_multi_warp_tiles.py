"""The tile scheme of the multi-lane forward-backward pair's CUDA kernels,
checked where there is no card: csrc/fb_multi.cu `multi_forward_kernel`
(fb_multi_forward) and `multi_backward_kernel` (fb_multi_backward).

They run in the REL pair's warp-per-lane layout (tests/
test_torch_rel_warp_tiles.py): a lane a warp, `ceil(Wp / 32)` consecutive
band rows a thread, every read of an earlier generation one shuffle
(`RelLane::move`), blocks of LPB lanes staging tiles of KT diagonals (16 at
one row a thread, else 8) by the tensor memory accelerator or cp.async.
The forward is K3's recursion with K2's outputs: it stages em and valid,
the records s1 and fink and the start flags as a byte tile; it seeds row 0
where a problem starts (the gap-chain form overwrites, the generic form
adds 0.2 to all five states), takes every row's terminal sum before the
rescale at d % 8 == 7 and times 1 / c there, and writes fm through the
output tile, lsf and term as per-lane records (term zeroed first, then
written by the thread holding the terminal row).  The backward is K2's
recursion with K3's staging (em and fm planes, the records s1, fink, find,
lsf and L): it injects at the terminal row (chain: overwrite wherever fink
names a row; generic: add 1 on the problem's terminal diagonal), restarts
bls there before the rescale at d % 8 == 0, and writes
fm * b_M * exp(lsf + bls - L) with the scale computed on each diagonal.

Here the scheme runs in torch (float32, the kernels' order of operations),
a block of LPB lanes at a time with the lanes past B idle, each warp's 32
threads as a tensor axis.  It is held bit for bit to the plain versions
(fm, lsf, term, post) at one to four rows a thread, 8 and 16 lanes a
block, both staging layouts and both model forms, over lane counts that
are no multiple of either and diagonal counts that are no multiple of a
tile, with problems starting at d = 0, on a tile's first and last
diagonal and right after a spacer, terminals on the last diagonal, on
either kernel's rescale diagonal and in the same tile as their start, and
lanes with no valid cell; and, on packed synthetic reads, to the JAX
package's multi-lane Pallas pair in interpret mode (logZ rtol / atol
1e-4, posteriors atol 2e-4, tests/test_torch_multi.py's tolerances).
"""
import jax
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu_torch.ops import fb_multi_cuda as fmc
from marginalign_trna_tpu_torch.ops.band import SPACER
from marginalign_trna_tpu_torch.ops.fb import (
    multi_device_batch, multi_logz, tables_from_jax,
)
from marginalign_trna_tpu_torch.ops.fb_circ import circ_coefficients
from marginalign_trna_tpu_torch.ops.fb_circ_cuda import (
    COEF_A, COEF_C, COEF_CB, COEF_K, COEF_M0, COEF_MC, COEF_PI, COEF_R,
    COEF_T00, _floats,
)

from test_torch_multi import _both, _hmm, _posteriors_jax, _problems
from test_torch_rel_warp_tiles import Block, move, same_bits, stage_plane
from test_torch_warp_tiles import byte_stride, stage_bytes

F32 = torch.float32


def _mixes(c, chain, f):
    """The mixes generation f contributes, in the kernel's order: the match
    target at d+2 and the gap targets at d+1."""
    if chain:
        m = c[COEF_T00] * f[0]
        for s in range(1, 5):
            m = m + c[COEF_MC + s - 1] * f[s]
        return m, [f[0] + c[COEF_C + u - 1] * f[u] for u in range(1, 5)]
    out = []
    for t in range(5):
        acc = f[0] * c[COEF_A + t]
        for s in range(1, 5):
            acc = acc + f[s] * c[COEF_A + 5 * s + t]
        out.append(acc)
    return out[0], out[1:]


def multi_forward_tiles(coef, chain, em, valid, s1, start, fink, lpb=8,
                        tma=True):
    """(fm [D1, Wp, B], lsf [D1, B], term [D1, B]) as multi_forward_kernel
    computes them, block by block."""
    D1, wp, B = em.shape
    c = _floats(coef)
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    start_rows = start.numpy().view(np.uint8)
    fm = torch.full((D1, wp, B), float("nan"), dtype=F32)
    lsf = torch.full((D1, B), float("nan"), dtype=F32)
    term = torch.full((D1, B), float("nan"), dtype=F32)
    for b0 in range(0, B, lpb):
        blk = Block(D1, wp, B, b0, lpb, tma)
        kt, nl, rpt = blk.kt, blk.nl, blk.rpt
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        mm1, mm2, g = zero, zero, [zero] * 4
        ls = torch.zeros(lpb, dtype=F32)
        cprev = torch.ones(lpb, dtype=F32)
        sprev = torch.zeros(lpb, dtype=torch.int32)
        for d0 in range(0, D1, kt):
            n = min(kt, D1 - d0)
            plane = stage_plane(em, d0, kt, b0, lpb, tma)
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            st_t = stage_bytes(start_rows, d0, n, b0, lpb)
            s1_t, fk_t = blk.records(s1, d0, n), blk.records(fink, d0, n)
            out = torch.full((lpb * blk.stride,), float("nan"), dtype=F32)
            olsf = torch.full((lpb, kt), float("nan"), dtype=F32)
            oterm = torch.zeros(lpb, kt, dtype=F32)  # zeroed first
            for kb in range(n):
                e, v = plane[blk.at(kb)], blk.valid(v_t, kb)
                # RelLane::starts: the lane's start byte of the diagonal.
                starts = torch.from_numpy(
                    st_t[kb * byte_stride(lpb) + np.arange(lpb)] != 0)
                t1 = s1_t[:, kb]
                t2 = t1 + sprev
                sprev = t1
                mm = move(mm1, t2 - 1, wp, rpt)
                if kb % 8 == 0:
                    mm = mm / cprev[:, None, None]
                q = [move(g[u], t1 - (u & 1), wp, rpt) for u in range(4)]
                seed = starts[:, None, None] & (blk.rows == 0)
                if chain:
                    f = [torch.where(seed, 0.2, e * mm)] + [
                        torch.where(seed, c[COEF_PI + s], q[s] * v)
                        for s in range(4)]
                    w = f[0]
                    for s in range(1, 5):
                        w = w + c[COEF_K + s - 1] * f[s]
                else:
                    inj = torch.where(seed, 0.2, 0.0)
                    f = [e * mm * v + inj] + [q[s] * v + inj
                                              for s in range(4)]
                    w = (((f[0] + f[1]) + f[2]) + f[3]) + f[4]
                if kb % 8 == 7:
                    cf = blk.band_max(f)
                    inv = 1.0 / cf
                    w = w * inv[:, None, None]
                    f = [y * inv[:, None, None] for y in f]
                    ls = ls + torch.log(cf)
                    cprev = cf
                blk.emit(out, kb, f[0])
                # The thread holding row fink stores its row's sum.
                own = (blk.rows == fk_t[:, kb, None, None]) & blk.inband
                for ln in range(lpb):
                    if own[ln].any():
                        oterm[ln, kb] = w[ln][own[ln]][0]
                olsf[:, kb] = ls
                mix_m, g = _mixes(c, chain, f)
                mm1, mm2 = mm2, mix_m
            blk.flush(out, fm, d0, n)
            lsf[d0:d0 + n, b0:b0 + nl] = olsf[:nl, :n].T
            term[d0:d0 + n, b0:b0 + nl] = oterm[:nl, :n].T
    return fm, lsf, term


def multi_backward_tiles(coef, chain, fm, lsf, L, em, valid, s1, fink, find,
                         lpb=8, tma=True):
    """The posterior band [D1, Wp, B] as multi_backward_kernel computes it,
    block by block."""
    D1, wp, B = em.shape
    c = _floats(coef)
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    post = torch.full((D1, wp, B), float("nan"), dtype=F32)
    for b0 in range(0, B, lpb):
        blk = Block(D1, wp, B, b0, lpb, tma)
        kt, rpt = blk.kt, blk.rpt
        zero = torch.zeros(lpb, 32, rpt, dtype=F32)
        p1, p2, g = zero, zero, [zero] * 4
        bls = torch.zeros(lpb, dtype=F32)
        cprev = torch.ones(lpb, dtype=F32)
        sh1 = sh2 = torch.zeros(lpb, dtype=torch.int32)
        tiles = (D1 + kt - 1) // kt
        for u in range(tiles):
            d0 = (tiles - 1 - u) * kt
            n = min(kt, D1 - d0)
            planes = [stage_plane(x, d0, kt, b0, lpb, tma) for x in (em, fm)]
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            s1_t, fk_t, fd_t, lsf_t, L_t = (
                blk.records(x, d0, n) for x in (s1, fink, find, lsf, L))
            out = torch.full((lpb * blk.stride,), float("nan"), dtype=F32)
            for kb in range(n - 1, -1, -1):
                d = d0 + kb
                e, fmv = (p[blk.at(kb)] for p in planes)
                v = blk.valid(v_t, kb)
                x0 = move(p2, 1 - (sh1 + sh2), wp, rpt)
                q = [move(g[u], (u & 1) - sh1, wp, rpt) for u in range(4)]
                if kb % 8 == 7:
                    x0 = x0 / cprev[:, None, None]
                inj = blk.rows == fk_t[:, kb, None, None]
                at_term = fd_t[:, kb] == d
                if chain:
                    acc = c[COEF_T00] * x0
                    for s in range(1, 5):
                        acc = acc + c[COEF_M0 + s - 1] * q[s - 1]
                    nb = [torch.where(inj, 1.0, acc) * v] + [
                        torch.where(inj, c[COEF_R + s - 1],
                                    x0 + c[COEF_CB + s - 1] * q[s - 1]) * v
                        for s in range(1, 5)]
                else:
                    one = (inj & at_term[:, None, None]).to(F32)
                    nb = []
                    for s in range(5):
                        acc = x0 * c[COEF_A + 5 * s]
                        for t in range(1, 5):
                            acc = acc + q[t - 1] * c[COEF_A + 5 * s + t]
                        nb.append((acc + one) * v)
                sh2, sh1 = sh1, s1_t[:, kb]
                bls = torch.where(at_term, 0.0, bls)
                if kb % 8 == 0:
                    cf = blk.band_max(nb)
                    inv = 1.0 / cf
                    nb = [y * inv[:, None, None] for y in nb]
                    bls = bls + torch.log(cf)
                    cprev = cf
                alpha = torch.exp(lsf_t[:, kb] + bls - L_t[:, kb])
                blk.emit(out, kb, fmv * nb[0] * alpha[:, None, None])
                p2, p1 = p1, e * nb[0]
                g = nb[1:]
            blk.flush(out, post, d0, n)
    return post


# Problem layouts (first diagonal, terminal diagonal) of the first lanes;
# D1 37, tiles of 16 diagonals at one row a thread, else 8.  Lane 0: a
# start at d = 0 with its terminal on the forward's rescale diagonal 7 in
# the same tile, then (a spacer apart) a terminal on the backward's
# rescale diagonal 16, a start on the next spacer's far side, a terminal
# on a 16-tile's last diagonal 31, one on the last diagonal 36.  Lane 1: a
# start on a tile's last diagonal 15 and one on d % 8 == 7 with its
# terminal on a tile's first diagonal 32, a one-diagonal problem.  Lane 2:
# starts on a tile's first diagonal 16 and 32.
LAYOUTS = (
    ((0, 7), (10, 16), (19, 31), (34, 36)),
    ((15, 20), (23, 32), (35, 35)),
    ((16, 24), (32, 36)),
)


def random_multi(D1, wp, B, seed, chain=True, invalid_lanes=()):
    """The multi pair's inputs at random: the shipped model (chain) or its
    flat-gap variant whose gap states 1 and 2 exchange mass, lanes of
    problems (the first lanes as LAYOUTS, the others of 1-20 diagonals,
    SPACER apart, from d 0-3), 95% of each problem's cells valid (none in
    `invalid_lanes` and on spacers), match emissions in [0, 1) premasked,
    s1 in {-1, 0, 1, 2}, terminal rows 0-5 (within a short problem's
    reach; every seventh past the band: no terminal sum, no injection); the
    forward's
    arguments, then the backward's on the plain forward's outputs (L from
    `multi_logz`'s arithmetic)."""
    rng = np.random.default_rng(seed)
    start = np.zeros((D1, B), np.int8)
    find = np.full((D1, B), -1, np.int32)
    fink = np.full((D1, B), -1, np.int32)
    step_final = np.zeros((D1, B), np.int64)
    live = np.zeros((D1, B), bool)
    n_term = 0
    for b in range(B):
        if b < len(LAYOUTS):
            probs = [p for p in LAYOUTS[b] if p[1] < D1]
        else:
            probs, d = [], int(rng.integers(0, 4))
            while d < D1:
                e = min(d + int(rng.integers(0, 20)), D1 - 1)
                probs.append((d, e))
                d = e + 1 + SPACER
        for d0, e in probs:
            start[d0, b] = 1
            find[e, b] = e
            fink[e, b] = (wp + 1 if n_term % 7 == 6
                          else rng.integers(0, min(wp, 6)))
            n_term += 1
            step_final[d0:e + 1, b] = e
            live[d0:e + 1, b] = True
    valid = (rng.random((D1, wp, B)) < 0.95) & live[:, None, :]
    valid[..., list(invalid_lanes)] = False
    em = (rng.random((D1, wp, B)) * valid).astype(np.float32)
    s1 = rng.choice([-1, 0, 1, 2], p=[.02, .48, .48, .02],
                    size=(D1, B)).astype(np.int32)
    tables = tables_from_jax(jax.device_get(make_tables(_hmm(chain))))
    coef, is_chain = circ_coefficients(tables)
    assert is_chain == chain
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (em, valid, s1, start, fink, find)]
    fargs = (coef, chain, t[0], t[1], t[2], t[3], t[4])
    fmv, lsf, term = fmc.fb_multi_forward_plain(*fargs)
    L = (torch.log(term.clamp(min=1e-30)) + lsf).gather(
        0, torch.from_numpy(step_final))
    bargs = (coef, chain, fmv, lsf, L, t[0], t[1], t[2], t[4], t[5])
    return fargs, bargs


def assert_plain(fargs, bargs, lpb, tma):
    got = multi_forward_tiles(*fargs, lpb=lpb, tma=tma)
    want = fmc.fb_multi_forward_plain(*fargs)
    for name, g, w in zip(("fm", "lsf", "term"), got, want):
        assert same_bits(g, w), (name, (g - w).abs().max())
    post = multi_backward_tiles(*bargs, lpb=lpb, tma=tma)
    assert same_bits(post, fmc.fb_multi_backward_plain(*bargs))


@pytest.mark.parametrize("chain", [True, False], ids=["chain", "mix"])
@pytest.mark.parametrize("lpb,wp,tma", [
    (8, 24, True), (16, 24, False), (16, 48, True), (8, 48, False),
    (8, 96, False), (8, 128, False)],
    ids=["8-24-tma", "16-24-cp_async", "16-48-tma", "8-48-cp_async",
         "8-96-cp_async", "8-128-cp_async"])
def test_multi_tiles_match_plain(lpb, wp, tma, chain):
    """One to four rows a thread (tiles of 16, 8, 8 and 8 diagonals; TMA
    at up to two rows a thread, 16 lanes a block too, as csrc/fb_rel.cuh
    `rel_tma` and `rel_lanes` take them), both model forms, 19 lanes (a
    partial block), 37 diagonals (a partial tile at either end), the
    LAYOUTS lanes and a lane with no valid cell."""
    fargs, bargs = random_multi(37, wp, 19, seed=wp + lpb, chain=chain,
                                invalid_lanes=(5,))
    assert_plain(fargs, bargs, lpb, tma)


@pytest.mark.parametrize("lpb", [8, 16])
def test_multi_tiles_short_lanes(lpb):
    """One, two, nine and sixteen diagonals (a partial tile, a tile), a
    third of the lanes with no valid cell."""
    for D1 in (1, 2, 9, 16):
        fargs, bargs = random_multi(D1, 24, 13, seed=D1,
                                    invalid_lanes=range(0, 13, 3))
        assert_plain(fargs, bargs, lpb, D1 % 2 == 0)


@pytest.fixture(scope="module", params=[True, False], ids=["chain", "mix"])
def packed(request):
    """Packed synthetic reads (tests/test_torch_multi.py's problems), the
    port's multi-lane inputs for them and the JAX package's multi-lane
    posteriors (Pallas in interpret mode)."""
    chain = request.param
    reads, refs, paths = _problems(np.random.default_rng(22), 10)
    jmb, tmb = _both(reads, refs, paths, 9, 96)
    jt = make_tables(_hmm(chain))
    jlogZ, jpost = (np.array(a) for a in
                    _posteriors_jax(jt, fp.multi_device_batch(jmb)))
    tables = tables_from_jax(jax.device_get(jt))
    coef, is_chain = circ_coefficients(tables)
    assert is_chain == chain
    mdev = multi_device_batch(tmb, "cpu")
    em = tables.Ematch[mdev.xb.long(), mdev.yb.long()] * mdev.valid
    fargs = (coef, chain, em, mdev.valid, mdev.s1, mdev.start, mdev.fink)
    return fargs, mdev, jlogZ, jpost


@pytest.mark.parametrize("lpb,tma", [(8, True), (16, False)])
def test_multi_tiles_match_pallas(packed, lpb, tma):
    """On packed synthetic reads, the model's logZ and posteriors agree with
    the JAX package's multi-lane Pallas pair in interpret mode and equal
    the plain versions bit for bit."""
    fargs, mdev, jlogZ, jpost = packed
    coef, chain = fargs[:2]
    fmv, lsf, term = multi_forward_tiles(*fargs, lpb=lpb, tma=tma)
    L, logZ = multi_logz(lsf, term, mdev)
    bargs = (coef, chain, fmv, lsf, L, fargs[2], mdev.valid, mdev.s1,
             mdev.fink, mdev.find)
    post = multi_backward_tiles(*bargs, lpb=lpb, tma=tma)
    assert np.isfinite(logZ.numpy()).all()
    assert np.allclose(logZ.numpy(), jlogZ, rtol=1e-4, atol=1e-4)
    assert np.abs(post.numpy() - jpost).max() <= 2e-4
    assert_plain(fargs, bargs, lpb, tma)
