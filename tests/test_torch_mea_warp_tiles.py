"""The tile scheme of K4's CUDA kernel, checked where there is no card:
csrc/mea.cu `mea_warp_kernel` (banded_mea, the MEA decode over weight
bands).

The kernel gives a lane a warp, `ceil(Wp / 32)` consecutive band rows a
thread (mk::WarpRows: a one-row move of the band is one shuffle of the
edge row, the band wrapping at Wp), both score generations in registers.
A block of LPB lanes stages tiles of KT diagonals (8, or 4 at three or
four rows a thread) of its lanes in shared memory: the three weight bands
either as the tensor memory accelerator copies them (the box [KT][Wp][LPB]
lanes fastest, zeros out of bounds, 16-byte pieces swizzled by bits 7.. of
their offset; B a multiple of 4, Wp <= 64) or by cp.async (per-lane rows
at an odd stride), the valid band as a byte tile lanes fastest at
`byte_stride(LPB)`, s1 and s2 as [LPB][KT]; the pointers leave through a
byte tile of the same layout.
Its bit-equality with the plain version rests on those offsets, on the
shuffles' source rows and on the order of the arithmetic.  Here the scheme
runs in torch (float32, the kernel's order of operations), a block of LPB
lanes at a time with the lanes past B idle, each warp's 32 threads as a
tensor axis.

The model is held bit for bit to the plain version (pointers on every cell,
scores) at one to four rows a thread, 8 and 16 lanes a block, both
staging layouts, over lane counts that are no multiple of either, on
random weights and shifts (every row move of the plain version's `shift`),
terminals at d = 0 and lanes with no valid cell; and, on packed batches of
synthetic reads, to the JAX package's `banded_mea_pallas` in interpret
mode, pointers and scores exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.wavefront_pallas import banded_mea_pallas
from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf
from marginalign_trna_tpu_torch.ops.fb import device_batch
from marginalign_trna_tpu_torch.ops.mea import mea_weights

from test_torch_warp_tiles import byte_stride, stage_bytes

F32 = torch.float32
NEG = -1e30


def tile_diagonals(rpt):
    """csrc/mea.cu `mea_kt_rpt`."""
    return 8 if rpt <= 2 else 4


def swizzled(q, w, lpb):
    """csrc/common.cuh `mk::swizzled`: the float offset of row q, lane w in a
    TMA weight plane (the map's 32, 64 or 128-byte swizzle at LPB 8, 16,
    32)."""
    m = {8: 1, 16: 3, 32: 7}[lpb]
    o = (q * lpb + w) * 4
    return (o ^ (((o >> 7) & m) << 4)) >> 2


def stage_plane(band, d0, kt, b0, lpb, tma):
    """One weight plane of a stage: TMA, the box [kt][Wp][lpb] at (d0, 0,
    b0) with zeros out of bounds, each float at its swizzled offset;
    cp.async, lane w's rows of the tile's n diagonals at w * (kt Wp + 1)
    (lanes past B and rows past the tile hold NaN: never read)."""
    D1, wp, B = band.shape
    n, nl = min(kt, D1 - d0), min(lpb, B - b0)
    if tma:
        box = torch.zeros(kt * wp, lpb, dtype=F32)
        box[:n * wp, :nl] = band[d0:d0 + n, :, b0:b0 + nl].reshape(n * wp, nl)
        q = torch.arange(kt * wp)[:, None]
        w = torch.arange(lpb)[None, :]
        plane = torch.full((kt * wp * lpb,), float("nan"), dtype=F32)
        plane[swizzled(q, w, lpb).reshape(-1)] = box.reshape(-1)
        return plane
    stride = kt * wp + 1
    plane = torch.full((lpb * stride,), float("nan"), dtype=F32)
    for w in range(nl):
        plane[w * stride:w * stride + n * wp] = band[d0:d0 + n, :, b0 + w] \
            .reshape(-1)
    return plane


def roll(v, t, wp, rpt):
    """mk::WarpRows::roll over a block: v [LPB, 32, RPT] (thread kk holds
    rows rpt kk + r), t [LPB] the move of each lane's warp."""
    kk = torch.arange(32)
    last, rlast = (wp - 1) // rpt, (wp - 1) % rpt
    up_src = torch.where(kk == last, 0, (kk + 1) & 31)
    dn_src = torch.where(kk == 0, last, kk - 1)
    top = torch.where(kk == last, rlast, rpt - 1)
    down = v.gather(2, top[None, :, None].expand(v.shape[0], 32, 1))[..., 0]
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


def max_argmax3(v0, v1, v2):
    """mk::max_argmax3: first max wins, in the order diag, left, up."""
    m01 = torch.maximum(v0, v1)
    arg = torch.where(v2 > m01, 2, torch.where(v1 > v0, 1, 0))
    return torch.maximum(m01, v2), arg


def mea_warp_tiles(wdiag, wup, wleft, valid, s1, s2, final_d, final_k,
                   lpb=8, tma=True):
    """(pointers uint8 [D1, Wp, B], score [B]) as mea_warp_kernel computes
    them, block by block."""
    D1, wp, B = wdiag.shape
    rpt = (wp + 31) // 32
    kt = tile_diagonals(rpt)
    S = byte_stride(lpb)
    valid_rows = valid.numpy().reshape(D1 * wp, B).view(np.uint8)
    s1n, s2n = s1.numpy(), s2.numpy()
    ptr = np.zeros((D1 * wp, B), np.uint8)
    score = torch.full((B,), float("nan"), dtype=F32)
    kk = torch.arange(32)
    rows = (rpt * kk[:, None] + torch.arange(rpt)[None, :])[None]  # [1,32,R]
    k = rows.clamp(max=wp - 1)
    w = torch.arange(lpb)[:, None, None]
    for b0 in range(0, B, lpb):
        nl = min(lpb, B - b0)
        fd = torch.full((lpb, 1, 1), -1)
        fk = torch.full((lpb, 1, 1), -1)
        fd[:nl, 0, 0] = final_d[b0:b0 + nl].long()
        fk[:nl, 0, 0] = final_k[b0:b0 + nl].long()
        a1 = torch.zeros(lpb, 32, rpt, dtype=F32)
        a2 = a1.clone()
        tscore = torch.full((lpb, 32, rpt), NEG, dtype=F32)
        hit = torch.zeros(lpb, 32, rpt, dtype=torch.bool)
        for d0 in range(0, D1, kt):
            n = min(kt, D1 - d0)
            planes = [stage_plane(x, d0, kt, b0, lpb, tma)
                      for x in (wdiag, wup, wleft)]
            v_t = stage_bytes(valid_rows, d0 * wp, n * wp, b0, lpb)
            s1_t = np.zeros((lpb, kt), np.int64)
            s2_t = np.zeros((lpb, kt), np.int64)
            s1_t[:nl, :n] = s1n[d0:d0 + n, b0:b0 + nl].T
            s2_t[:nl, :n] = s2n[d0:d0 + n, b0:b0 + nl].T
            out = np.zeros(kt * wp * S, np.uint8)
            for kb in range(n):
                d = d0 + kb
                if d == 0:
                    # d = 0 is pure initialisation: 0 at row 0.
                    na = torch.where(rows == 0, 0.0, NEG).to(F32).expand(
                        lpb, 32, rpt).clone()
                    a2 = torch.full_like(na, NEG)
                    am = torch.zeros(lpb, 32, rpt, dtype=torch.int64)
                else:
                    q = kb * wp + k
                    o = (swizzled(q, w, lpb) if tma
                         else w * (kt * wp + 1) + q)
                    wd, wu, wl = (p[o] for p in planes)
                    vv = torch.from_numpy(
                        v_t[(q * S + w).numpy()].astype(bool))
                    t1 = torch.from_numpy(s1_t[:, kb])
                    t2 = torch.from_numpy(s2_t[:, kb])
                    left_m = (t1 == 1) | (t1 == -1)
                    up_m = (t1 == 0) | (t1 == 2)
                    by = torch.where(left_m, t1, torch.where(up_m, t1 - 1, 0))
                    dm = torch.where((t2 == 0) | (t2 == 2), t2 - 1, 0)
                    ar = roll(a1, by, wp, rpt)
                    dg = roll(a2, dm, wp, rpt)
                    diag = dg + wd
                    left = torch.where(left_m[:, None, None], ar, a1) + wl
                    up = torch.where(up_m[:, None, None], ar, a1) + wu
                    val, am = max_argmax3(diag, left, up)
                    na = torch.where(vv, val, NEG).to(F32)
                    a2 = a1
                at = (rows < wp).expand(lpb, 32, rpt)
                cell = ((kb * wp + rows) * S + w).expand(lpb, 32, rpt)
                out[cell[at].numpy()] = am[at].numpy().astype(np.uint8)
                a1 = na
                now = (d == fd) & (rows == fk) & (fk < wp)
                tscore = torch.where(now, na, tscore)
                hit = hit | now
            # mk::flush_bytes: the tile's rows of the block's lanes.
            for ww in range(nl):
                ptr[d0 * wp:(d0 + n) * wp, b0 + ww] = \
                    out[np.arange(n * wp) * S + ww]
        any_hit = hit.flatten(1).any(1)
        kept = torch.where(hit, tscore, NEG).flatten(1).max(1).values
        score[b0:b0 + nl] = torch.where(any_hit, torch.clamp(kept, min=NEG),
                                        NEG)[:nl]
    return torch.from_numpy(ptr.reshape(D1, wp, B)), score


def random_inputs(D1, wp, B, seed, final_d=None, invalid_lanes=()):
    """K4's inputs at random: wdiag in [0, 1) with 20% NEG, wup / wleft in
    [0, 0.5), 80% valid cells (none in `invalid_lanes`), s1 in {-1, 0, 1,
    2} and s2 in {-1, ..., 3}, terminals on any diagonal (every fifth at
    d = 0, every eleventh past the band) and any row, or all at final_d."""
    rng = np.random.default_rng(seed)
    wdiag = rng.random((D1, wp, B)).astype(np.float32)
    wdiag[rng.random(wdiag.shape) < 0.2] = NEG
    valid = rng.random((D1, wp, B)) < 0.8
    valid[..., list(invalid_lanes)] = False
    if final_d is None:
        fd = rng.integers(0, D1, B)
        fd[::5] = 0
        fd[3::11] = D1 + 3
    else:
        fd = np.full(B, final_d)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        wdiag, (rng.random((D1, wp, B)) * 0.5).astype(np.float32),
        (rng.random((D1, wp, B)) * 0.5).astype(np.float32), valid,
        rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05],
                   size=(D1, B)).astype(np.int32),
        rng.integers(-1, 4, (D1, B)).astype(np.int32),
        fd.astype(np.int32), rng.integers(0, wp, B).astype(np.int32)))


def assert_plain(args, lpb, tma):
    ptr, score = mea_warp_tiles(*args, lpb=lpb, tma=tma)
    rptr, rscore = wf.banded_mea_plain(*args)
    assert torch.equal(ptr, rptr)
    assert torch.equal(score, rscore), (score - rscore).abs().max()


@pytest.mark.parametrize("lpb", [8, 16])
@pytest.mark.parametrize("wp,tma", [(24, True), (24, False), (48, True),
                                    (48, False), (96, False), (128, False)],
                         ids=["24-tma", "24-cp_async", "48-tma",
                              "48-cp_async", "96-cp_async", "128-cp_async"])
def test_tiles_match_plain_random(wp, tma, lpb):
    """One to four rows a thread (tiles of 8, 8, 4 and 4 diagonals; TMA at
    up to two rows a thread, as csrc/mea.cu `mea_tma` takes it), 19 lanes
    (a partial block), 21 diagonals (a partial last tile)."""
    assert_plain(random_inputs(21, wp, 19, seed=wp + lpb), lpb, tma)


@pytest.mark.parametrize("lpb", [8, 16])
def test_tiles_edges(lpb):
    """Every terminal at d = 0; a third of the lanes with no valid cell;
    one and two diagonals."""
    assert_plain(random_inputs(12, 24, 13, seed=1, final_d=0), lpb, True)
    assert_plain(random_inputs(12, 24, 13, seed=2,
                               invalid_lanes=range(0, 13, 3)), lpb, False)
    for D1 in (1, 2):
        assert_plain(random_inputs(D1, 24, 9, seed=D1), lpb, True)


def test_swizzle_is_a_permutation():
    """Each swizzle maps a plane's rows and lanes one to one onto its
    floats, 16-byte pieces intact, and puts the 32 rows of one lane on 8
    banks (4-way conflicts) where the unswizzled layout puts them on
    32 / LPB."""
    for lpb in (8, 16, 32):
        q = torch.arange(64)[:, None]
        w = torch.arange(lpb)[None, :]
        o = swizzled(q, w, lpb)
        assert torch.equal(o.reshape(-1).sort().values,
                           torch.arange(64 * lpb))
        assert torch.equal(o // 4, swizzled(q, (w // 4) * 4, lpb) // 4)
        for lane in range(lpb):
            banks = (swizzled(torch.arange(32), lane, lpb) % 32).unique()
            assert len(banks) == 8


def _packed(seed, n_lanes):
    """A width-21 batch of synthetic reads (one with a deletion), random
    in-band posteriors, and K4's inputs from them (ops/mea.py
    `mea_weights`, gapGamma 0.5, matchGamma 0)."""
    rng = np.random.default_rng(seed)
    reads, refs, paths = [], [], []
    for i in range(n_lanes):
        ref = rng.integers(0, 4, int(rng.integers(30, 90))).astype(np.int8)
        cut = len(ref) // 2
        read = np.concatenate([ref[:cut], ref[cut + 4:]])
        reads.append(read)
        refs.append(ref)
        paths.append(path_from_cigar([(0, cut), (2, 4),
                                      (0, len(ref) - cut - 4)]))
    batch = pack_banded_batch(reads, refs, width=21, paths=paths)
    post = (rng.random(batch.xb.shape) * batch.valid * 0.6).astype(np.float32)
    dev = device_batch(batch, "cpu")
    wup, wleft = mea_weights(torch.from_numpy(post), dev.valid,
                             torch.from_numpy(batch.lo), 0.5,
                             int(batch.m.max()), int(batch.n.max()))
    wdiag = torch.where(torch.from_numpy(post) > 0, torch.from_numpy(post),
                        NEG)
    return (wdiag, wup, wleft, dev.valid, dev.s1, dev.s2, dev.final_d,
            dev.final_k)


@pytest.mark.parametrize("lpb", [8, 16])
def test_tiles_match_pallas(lpb):
    """On packed synthetic reads (11 lanes: a partial block at either
    size), the model's pointers and scores equal the JAX package's Pallas
    kernel in interpret mode and the plain version's, with TMA staging and
    with cp.async."""
    args = _packed(seed=lpb, n_lanes=11)
    ref = banded_mea_pallas(*(jnp.asarray(a.numpy()) for a in args))
    for tma in (True, False):
        ptr, score = mea_warp_tiles(*args, lpb=lpb, tma=tma)
        assert np.array_equal(ptr.numpy(), np.asarray(ref.pointers))
        assert np.array_equal(score.numpy(), np.asarray(ref.score))
    assert_plain(args, lpb, True)
