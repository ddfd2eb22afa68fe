"""The tile schemes of nw_multi's and mea_multi's CUDA kernels, checked
where there is no card: csrc/nw.cu `nw_kernel` and csrc/mea.cu
`mea_warp_kernel` with their MULTI flag (K1's and K4's kernels over lanes
that hold several problems, ops/band.py `pack_multi_banded_batch`).

Each kernel gives a lane T threads, a warp (T = 32), half of one (T = 16,
two lanes a warp: nw_multi up to Wp 48, mea_multi up to Wp 32) or a
quarter (T = 8, four lanes a warp: nw_multi up to Wp 24),
`ceil(Wp / T)` consecutive band rows a thread (mk::WarpRows: a one-row
move is one shuffle of the edge row within the lane's threads, the band
wrapping at Wp), its frontier generations in registers, starting at NEG.  A block of LPB lanes stages tiles of KT diagonals (nw_multi 8;
mea_multi 8, or 4 at three or four rows a thread): the codes and the valid
band (nw_multi) or the valid band (mea_multi) as byte tiles lanes fastest
at `byte_stride(LPB)`; mea_multi's three weight bands as the tensor memory
accelerator copies them (the box [KT][Wp][LPB], zeros out of bounds,
16-byte pieces swizzled; B a multiple of 4, Wp <= 64) or by cp.async
(per-lane rows at an odd stride); s1, s2, fink and find as records
[LPB][KT]; the problems' start flags as a byte tile of KT rows.  At the
start of a tile each warp packs its lane's start flag and terminal row of
every tile diagonal into one int in place of fink (`mk::pack_steps`: the
row where find >= 0, else 0xffff, the flag at bit 16) and fills its lane's
terminal record [NP][KT][LPB] with NEG; on each diagonal row 0 is seeded
(score 0, pointer 0; nw_multi M 0, X and Y NEG) where a problem starts,
and the thread holding the terminal row writes max(value, NEG) into the
record.  The pointers leave through a byte tile, the records as lane rows
of term [NP, D1, B] (NP 3 for nw_multi's M, X, Y, 1 for mea_multi).

Their bit-equality with the plain versions rests on those layouts, on the
shuffles' source rows and on the order of the arithmetic.  Here the schemes
run in torch (float32, the kernels' order of operations), a block of LPB
lanes at a time with the lanes past B idle, each lane's T threads as a
tensor axis.  The models are held bit for bit to `nw_multi_plain` /
`mea_multi_plain` (pointers on every cell, term) at the block sizes the
kernels take (8 or 16 warps' worth of lanes; a warp a lane: 8 and 16
lanes, and 32 for mea_multi at one row a thread), Wp 24 and 48, both staging layouts
of mea_multi, over lane counts that are no multiple of the block,
on packed batches (a lane of one problem beside lanes of several, a partial
last tile) and on random streams (starts and terminals on tile edges, rows
past the band, lanes with no valid cell); and to the JAX package's
`banded_nw_pallas_multi` / `banded_mea_pallas_multi` in interpret mode, as
tests/test_torch_multi.py runs them: pointers exact on valid cells, scores
within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops import fb_pallas as fp
from marginalign_trna_tpu.ops.wavefront_pallas import (
    banded_mea_pallas_multi, banded_nw_pallas_multi,
)
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf

from test_torch_mea_warp_tiles import max_argmax3, stage_plane, swizzled
from test_torch_multi import NW_PARAMS, _problems
from test_torch_warp_tiles import byte_stride, stage_bytes

F32 = torch.float32
NEG = -1e30
NW_KT = 8


def pack_steps(st, fk, fd):
    """csrc/common.cuh `mk::pack_steps`."""
    row = (fd >= 0) & (fk >= 0) & (fk < 0xffff)
    return np.where(row, fk, 0xffff) | np.where(st != 0, 0x10000, 0)


def stage_records(a, d0, n, kt, b0, lpb):
    """A [D1, B] int stream's records [LPB][KT] for the tile at d0 (lanes
    past B and diagonals past the tile 0: never read)."""
    nl = min(lpb, a.shape[1] - b0)
    t = np.zeros((lpb, kt), np.int64)
    t[:nl, :n] = a[d0:d0 + n, b0:b0 + nl].T
    return t


def tile_steps(start, fink, find, d0, n, kt, b0, lpb):
    """[LPB, KT]: each warp's packed start flag and terminal row of the
    tile's diagonals, from the start byte tile and the fink / find
    records."""
    S = byte_stride(lpb)
    st_t = stage_bytes(start, d0, n, b0, lpb)
    fk = stage_records(fink, d0, n, kt, b0, lpb)
    fd = stage_records(find, d0, n, kt, b0, lpb)
    st = np.zeros((lpb, kt), np.int64)
    for kb in range(n):
        st[:, kb] = st_t[kb * S + np.arange(lpb)]
    return torch.from_numpy(pack_steps(st, fk, fd))


def roll(v, t, wp, rpt):
    """mk::WarpRows::roll over a block: v [LPB, T, RPT] (thread kk of a
    lane's T holds rows rpt kk + r), t [LPB] the move of each lane; the
    edge row's shuffle stays among the lane's T threads."""
    T = v.shape[1]
    kk = torch.arange(T)
    last, rlast = (wp - 1) // rpt, (wp - 1) % rpt
    up_src = torch.where(kk == last, 0, (kk + 1) & (T - 1))
    dn_src = torch.where(kk == 0, last, kk - 1)
    top = torch.where(kk == last, rlast, rpt - 1)
    down = v.gather(2, top[None, :, None].expand(v.shape[0], T, 1))[..., 0]
    tt = t[:, None]
    send = torch.where(tt > 0, v[..., 0], down)
    src = torch.where(tt > 0, up_src, torch.where(tt < 0, dn_src, kk))
    edge = send.gather(1, src)
    out = torch.empty_like(v)
    for r in range(rpt):
        up = torch.where((r == top) | (r == rpt - 1), edge,
                         v[..., min(r + 1, rpt - 1)])
        dn = edge if r == 0 else v[..., r - 1]
        out[..., r] = torch.where(tt > 0, up, torch.where(tt < 0, dn,
                                                           v[..., r]))
    return out


def tile_diagonals(rpt, T):
    """csrc/mea.cu `mea_kt_rpt`: 8 where the rows cover at most 64."""
    return 8 if rpt * T <= 64 else 4


def moves(t1, t2):
    """mk::GapMove and mk::diag_move of each lane's s1, s2 ([LPB])."""
    left = (t1 == 1) | (t1 == -1)
    up = (t1 == 0) | (t1 == 2)
    by = torch.where(left, t1, torch.where(up, t1 - 1, 0))
    dm = torch.where((t2 == 0) | (t2 == 2), t2 - 1, 0)
    return left[:, None, None], up[:, None, None], by, dm


def flush(ptr, out, term, rec, d0, n, wp, b0, nl, S):
    """mk::flush_bytes and mk::flush_records: the tile's pointer rows and
    terminal records of the block's live lanes."""
    for ww in range(nl):
        ptr[d0 * wp:(d0 + n) * wp, b0 + ww] = out[np.arange(n * wp) * S + ww]
        term[:, d0:d0 + n, b0 + ww] = rec[:, :n, ww]


def nw_multi_tiles(params, xb, yb, valid, s1, s2, start, fink, find,
                   lpb=8, T=32):
    """(pointers uint8 [D1, Wp, B], term [3, D1, B]) as nw_kernel<RPT, LPB,
    true, T> computes them, block by block."""
    match, mismatch, gap_open, gap_extend = (float(p) for p in params)
    D1, wp, B = xb.shape
    rpt = -(-wp // T)
    S = byte_stride(lpb)
    rowsof = [a.numpy().reshape(D1 * wp, B).view(np.uint8)
              for a in (xb, yb, valid)]
    st_rows = start.numpy().view(np.uint8)
    s1n, s2n, fkn, fdn = (a.numpy() for a in (s1, s2, fink, find))
    ptr = np.zeros((D1 * wp, B), np.uint8)
    term = np.full((3, D1, B), np.nan, np.float32)
    kk = torch.arange(T)
    rows = (rpt * kk[:, None] + torch.arange(rpt)[None, :])[None]
    k = rows.clamp(max=wp - 1)
    w = torch.arange(lpb)[:, None, None]
    shape = (lpb, T, rpt)
    for b0 in range(0, B, lpb):
        nl = min(lpb, B - b0)
        m1, x1, y1, b1, b2 = (torch.full(shape, NEG, dtype=F32)
                              for _ in range(5))
        a1 = torch.zeros(shape, dtype=torch.int64)
        a2 = a1.clone()
        for d0 in range(0, D1, NW_KT):
            n = min(NW_KT, D1 - d0)
            x_t, y_t, v_t = (stage_bytes(r, d0 * wp, n * wp, b0, lpb)
                             for r in rowsof)
            s1_t = torch.from_numpy(stage_records(s1n, d0, n, NW_KT, b0, lpb))
            s2_t = torch.from_numpy(stage_records(s2n, d0, n, NW_KT, b0, lpb))
            steps = tile_steps(st_rows, fkn, fdn, d0, n, NW_KT, b0, lpb)
            out = np.zeros(NW_KT * wp * S, np.uint8)
            rec = np.full((3, NW_KT, lpb), np.nan, np.float32)
            rec[:, :, :nl] = NEG
            for kb in range(n):
                q = ((kb * wp + k) * S + w).numpy()
                x = torch.from_numpy(x_t[q].view(np.int8).astype(np.int64))
                y = torch.from_numpy(y_t[q].view(np.int8).astype(np.int64))
                v = torch.from_numpy(v_t[q] != 0)
                left, up, by, tb = moves(s1_t[:, kb], s2_t[:, kb])
                gs = torch.where(left, x1, y1)
                mr, gr = roll(m1, by, wp, rpt), roll(gs, by, wp, rpt)
                bs, as_ = roll(b2, tb, wp, rpt), roll(a2, tb, wp, rpt)
                sub = torch.where((x == y) & (x < 4), match, torch.where(
                    (x >= 4) | (y >= 4), 0.0, mismatch)).to(F32)
                mval = bs + sub
                io = torch.where(left, mr, m1) + gap_open
                ie = torch.where(left, gr, x1) + gap_extend
                vo = torch.where(up, mr, m1) + gap_open
                ve = torch.where(up, gr, y1) + gap_extend
                nm = torch.where(v, mval, NEG).to(F32)
                nx = torch.where(v, torch.maximum(io, ie), NEG).to(F32)
                ny = torch.where(v, torch.maximum(vo, ve), NEG).to(F32)
                pt = as_ | ((ie > io).long() << 2) | ((ve > vo).long() << 3)
                sp = steps[:, kb][:, None, None]
                seed = ((sp >> 16) != 0) & (rows == 0)
                nm = torch.where(seed, 0.0, nm).to(F32)
                nx = torch.where(seed, NEG, nx).to(F32)
                ny = torch.where(seed, NEG, ny).to(F32)
                pt = torch.where(seed, 0, pt)
                at = (rows < wp).expand(shape)
                cell = ((kb * wp + rows) * S + w).expand(shape)
                out[cell[at].numpy()] = pt[at].numpy().astype(np.uint8)
                hold = ((sp & 0xffff) == rows) & (rows < wp)
                for lane, th, r in hold.nonzero().tolist():
                    for p, val in enumerate((nm, nx, ny)):
                        rec[p, kb, lane] = max(val[lane, th, r].item(), NEG)
                b2, a2 = b1, a1
                b1, a1 = max_argmax3(nm, nx, ny)
                m1, x1, y1 = nm, nx, ny
            flush(ptr, out, term, rec, d0, n, wp, b0, nl, S)
    return (torch.from_numpy(ptr.reshape(D1, wp, B)), torch.from_numpy(term))


def mea_multi_tiles(wdiag, wup, wleft, valid, s1, s2, start, fink, find,
                    lpb=8, tma=True, T=32):
    """(pointers uint8 [D1, Wp, B], term [D1, B]) as mea_warp_kernel<RPT,
    LPB, TMA, true, T> computes them, block by block."""
    D1, wp, B = wdiag.shape
    rpt = -(-wp // T)
    kt = tile_diagonals(rpt, T)
    S = byte_stride(lpb)
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    st_rows = start.numpy().view(np.uint8)
    s1n, s2n, fkn, fdn = (a.numpy() for a in (s1, s2, fink, find))
    ptr = np.zeros((D1 * wp, B), np.uint8)
    term = np.full((1, D1, B), np.nan, np.float32)
    kk = torch.arange(T)
    rows = (rpt * kk[:, None] + torch.arange(rpt)[None, :])[None]
    k = rows.clamp(max=wp - 1)
    w = torch.arange(lpb)[:, None, None]
    shape = (lpb, T, rpt)
    for b0 in range(0, B, lpb):
        nl = min(lpb, B - b0)
        a1 = torch.full(shape, NEG, dtype=F32)
        a2 = a1.clone()
        for d0 in range(0, D1, kt):
            n = min(kt, D1 - d0)
            planes = [stage_plane(x, d0, kt, b0, lpb, tma)
                      for x in (wdiag, wup, wleft)]
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            s1_t = torch.from_numpy(stage_records(s1n, d0, n, kt, b0, lpb))
            s2_t = torch.from_numpy(stage_records(s2n, d0, n, kt, b0, lpb))
            steps = tile_steps(st_rows, fkn, fdn, d0, n, kt, b0, lpb)
            out = np.zeros(kt * wp * S, np.uint8)
            rec = np.full((1, kt, lpb), np.nan, np.float32)
            rec[:, :n, :nl] = NEG
            for kb in range(n):
                q = kb * wp + k
                o = swizzled(q, w, lpb) if tma else w * (kt * wp + 1) + q
                wd, wu, wl = (p[o] for p in planes)
                v = torch.from_numpy(v_t[(q * S + w).numpy()] != 0)
                left, up, by, dm = moves(s1_t[:, kb], s2_t[:, kb])
                ar, dg = roll(a1, by, wp, rpt), roll(a2, dm, wp, rpt)
                val, am = max_argmax3(dg + wd, torch.where(left, ar, a1) + wl,
                                      torch.where(up, ar, a1) + wu)
                na = torch.where(v, val, NEG).to(F32)
                sp = steps[:, kb][:, None, None]
                seed = ((sp >> 16) != 0) & (rows == 0)
                na = torch.where(seed, 0.0, na).to(F32)
                am = torch.where(seed, 0, am)
                at = (rows < wp).expand(shape)
                cell = ((kb * wp + rows) * S + w).expand(shape)
                out[cell[at].numpy()] = am[at].numpy().astype(np.uint8)
                hold = ((sp & 0xffff) == rows) & (rows < wp)
                for lane, th, r in hold.nonzero().tolist():
                    rec[0, kb, lane] = max(na[lane, th, r].item(), NEG)
                a2, a1 = a1, na
            flush(ptr, out, term, rec, d0, n, wp, b0, nl, S)
    return (torch.from_numpy(ptr.reshape(D1, wp, B)),
            torch.from_numpy(term[0]))


# ------------------------------------------------------------------ inputs


def packed(width, lanes, seed, pad_steps_to=100):
    """A multi batch of 14 noisy pairs of 8-40 bases, one whose guide path
    moves the band, a 2 x 3 pair and a pair of ~45 bases alone in its lane
    (JAX's packing and the port's), its lanes repeated to `lanes` (None:
    the batch's own) for the port; D1 = 100 (a partial last tile)."""
    rng = np.random.default_rng(seed)
    reads, refs, paths = _problems(rng, 14)
    ref = rng.integers(0, 4, 45).astype(np.int8)
    reads.append(np.delete(ref, [20]))
    refs.append(ref)
    paths.append(None)
    kw = dict(width=width, paths=paths, pad_steps_to=pad_steps_to)
    jmb = jband.pack_multi_banded_batch(reads, refs, **kw)
    tmb = tband.pack_multi_banded_batch(reads, refs, **kw)
    per_lane = np.bincount([p.lane for p in tmb.problems])
    assert per_lane.min() == 1 and per_lane.max() > 1, per_lane
    lanes = lanes or tmb.xb.shape[-1]

    def rep(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        reps = -(-lanes // t.shape[-1])
        return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :lanes] \
            .contiguous()

    streams = (rep(tmb.xb, np.int8), rep(tmb.yb, np.int8),
               rep(tmb.valid, np.bool_), rep(tmb.s1, np.int32),
               rep(tmb.s2, np.int32), rep(tmb.start, np.int8),
               rep(tmb.fink_steps, np.int32), rep(tmb.find, np.int32))
    return jmb, tmb, streams


def random_streams(D1, wp, B, seed):
    """Random multi streams: codes 0-4, 80% valid cells (none in every
    fifth lane), s1 in {-1, 0, 1, 2}, s2 in {-1, ..., 3}, starts on 10% of
    diagonals and on every tile's first (d % 8 == 0) of lane 1, terminals on
    20% (every tile's last diagonal of lane 2), rows over [-1, Wp + 3)
    (rows past the band and -1 write nothing)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((D1, wp, B)) < 0.8
    valid[..., ::5] = False
    start = (rng.random((D1, B)) < 0.1).astype(np.int8)
    start[::8, 1 % B] = 1
    find = np.where(rng.random((D1, B)) < 0.2, 0, -1).astype(np.int32)
    find[7::8, 2 % B] = 0
    fink = rng.integers(-1, wp + 3, (D1, B)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        rng.integers(0, 5, (D1, wp, B)).astype(np.int8),
        rng.integers(0, 5, (D1, wp, B)).astype(np.int8), valid,
        rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05],
                   size=(D1, B)).astype(np.int32),
        rng.integers(-1, 4, (D1, B)).astype(np.int32), start, fink, find))


def weights(shape, seed):
    """mea_multi's weights at random: wdiag in [0, 1) with 20% NEG, wup and
    wleft in [0, 0.5)."""
    rng = np.random.default_rng(seed)
    wdiag = rng.random(shape).astype(np.float32)
    wdiag[rng.random(shape) < 0.2] = NEG
    return (torch.from_numpy(wdiag),
            torch.from_numpy((rng.random(shape) * 0.5).astype(np.float32)),
            torch.from_numpy((rng.random(shape) * 0.5).astype(np.float32)))


def assert_equal(got, want):
    for g, r in zip(got, want):
        assert torch.equal(g, r), (g.double() - r.double()).abs().max()


# ------------------------------------------------------------------- tests


# (threads a lane, lanes a block) of csrc/nw.cu `nw_setup` for nw_multi:
# a quarter of a warp a lane (32 or 64 lanes) up to Wp 24, half (16 or 32)
# up to Wp 48; a warp (8 or 16) above.
_NW_BLOCKS = [(8, 32), (8, 64), (16, 16), (16, 32), (32, 8), (32, 16)]


@pytest.mark.parametrize("T,lpb", _NW_BLOCKS,
                         ids=["%d-%d" % b for b in _NW_BLOCKS])
@pytest.mark.parametrize("width", [21, 40], ids=["Wp24", "Wp48"])
def test_nw_tiles_match_plain(width, T, lpb):
    """Packed lanes repeated to 37 (a partial block at every size) and
    random streams over 21 lanes: the model bit-equal to nw_multi_plain,
    at a quarter of a warp a lane (the kernel's layout at Wp 24), half (at
    Wp 48) and a warp (above Wp 48), each here at both bands."""
    _, _, (xb, yb, valid, s1, s2, start, fink, find) = packed(width, 37,
                                                              seed=width)
    args = (NW_PARAMS, xb, yb, valid, s1, s2, start, fink, find)
    assert_equal(nw_multi_tiles(*args, lpb=lpb, T=T),
                 wf.nw_multi_plain(*args))
    wp = xb.shape[1]
    rargs = (NW_PARAMS, *random_streams(21, wp, 21, seed=wp + lpb + T))
    assert_equal(nw_multi_tiles(*rargs, lpb=lpb, T=T),
                 wf.nw_multi_plain(*rargs))


# (Wp, threads a lane, lanes a block, TMA) of csrc/mea.cu `mea_setup` for
# mea_multi: half a warp a lane (16 or 32 lanes) up to Wp 32; a warp (8 or
# 16, 32 at one row a thread) above, and at Wp 24 as K4 lays it out.
_MEA_CASES = [(w, T, lpb, tma) for w in (21, 40) for T, lpb in (
    (16, 16), (16, 32), (32, 8), (32, 16), (32, 32)) for tma in (True, False)
    if (T == 16 and w == 21) or (T == 32 and (lpb < 32 or w == 21))]


@pytest.mark.parametrize("width,T,lpb,tma", _MEA_CASES, ids=[
    "Wp%d-%d-%d-%s" % (24 if w == 21 else 48, T, lpb,
                       "tma" if t else "cp_async")
    for w, T, lpb, t in _MEA_CASES])
def test_mea_tiles_match_plain(width, T, lpb, tma):
    """Packed lanes repeated to 37 and random streams over 21 lanes (no
    multiple of the block), both staging layouts (TMA as csrc/mea.cu
    `mea_tma` takes it up to Wp 64), at half a warp a lane (Wp 24) and a
    warp a lane (32 lanes a block only at one row a thread): the model
    bit-equal to mea_multi_plain."""
    _, _, (_, _, valid, s1, s2, start, fink, find) = packed(width, 37,
                                                            seed=width + 1)
    args = (*weights(tuple(valid.shape), seed=lpb), valid, s1, s2, start,
            fink, find)
    assert_equal(mea_multi_tiles(*args, lpb=lpb, tma=tma, T=T),
                 wf.mea_multi_plain(*args))
    wp = valid.shape[1]
    _, _, rvalid, rs1, rs2, rstart, rfink, rfind = random_streams(
        21, wp, 21, seed=wp + lpb + T)
    rargs = (*weights((21, wp, 21), seed=lpb + 1), rvalid, rs1, rs2, rstart,
             rfink, rfind)
    assert_equal(mea_multi_tiles(*rargs, lpb=lpb, tma=tma, T=T),
                 wf.mea_multi_plain(*rargs))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("width", [21, 40], ids=["Wp24", "Wp48"])
def test_tiles_match_pallas(width, wide):
    """On the packed batch's own lanes, both models in the kernels' layouts
    at this Wp (nw_multi a quarter of a warp a lane at Wp 24, 32 or 64
    lanes a block, half at Wp 48, 16 or 32; mea_multi half a warp at Wp
    24, 16 or 32 lanes, a warp at Wp 48, 8 or 16) against the JAX package's multi Pallas functions in interpret
    mode: pointers exact on valid cells; nw_multi's per-problem score (the
    best of the three states at the problem's terminal) within 1e-5 and
    its final state equal, mea_multi's score within 1e-5."""
    jmb, tmb, (xb, yb, valid, s1, s2, start, fink, find) = packed(
        width, None, seed=width)
    pf = np.asarray(tmb.final_d)
    pl_ = np.array([p.lane for p in tmb.problems])
    jdev = fp.multi_device_batch(jmb)
    T = 8 if width == 21 else 16
    ptr, term = nw_multi_tiles(NW_PARAMS, xb, yb, valid, s1, s2, start,
                               fink, find, lpb=(32 // T) * (16 if wide else 8),
                               T=T)
    jres = banded_nw_pallas_multi(jnp.asarray(NW_PARAMS, jnp.float32), jdev)
    vmask = tmb.valid
    assert np.array_equal(ptr.numpy()[vmask], np.asarray(jres.pointers)[vmask])
    states = term.numpy()[:, pf, pl_]
    assert np.abs(states.max(0) - np.asarray(jres.score)).max() <= 1e-5
    assert np.array_equal(states.argmax(0), np.asarray(jres.final_state))

    wd, wu, wl = weights(tuple(valid.shape), seed=width)
    T = 16 if width == 21 else 32
    ptr, term = mea_multi_tiles(wd, wu, wl, valid, s1, s2, start, fink,
                                find, lpb=(32 // T) * (16 if wide else 8),
                                T=T)
    jm = banded_mea_pallas_multi(
        *(jnp.asarray(t.numpy()) for t in (wd, wu, wl)),
        jnp.asarray(jmb.valid), jnp.asarray(jmb.s1), jnp.asarray(jmb.s2),
        jnp.asarray(jmb.start), jnp.asarray(jmb.find),
        jnp.asarray(jmb.fink_steps), jnp.asarray(jmb.final_d),
        jnp.asarray(pl_.astype(np.int32)))
    assert np.array_equal(ptr.numpy()[vmask], np.asarray(jm.pointers)[vmask])
    assert np.abs(term.numpy()[pf, pl_] - np.asarray(jm.score)).max() <= 1e-5


def test_pack_steps():
    """The packed record: the terminal row where find >= 0 and the row is
    in [0, 0xffff), else 0xffff (no row); the start flag at bit 16."""
    st = np.array([0, 1, 0, 1, 0])
    fk = np.array([3, 0, -1, 5, 70000])
    fd = np.array([0, 4, 2, -1, 1])
    got = pack_steps(st, fk, fd)
    assert list(got & 0xffff) == [3, 0, 0xffff, 0xffff, 0xffff]
    assert list(got >> 16) == [0, 1, 0, 1, 0]
