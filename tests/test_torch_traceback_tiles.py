"""The tile scheme of the nw_moves and mea_moves CUDA kernels
(csrc/traceback.cu `moves_kernel`), checked where there is no card.

A block owns LPB lanes (the kernel takes 32; the scheme is held at 16
too).  Its top is min(D1 - 1, the largest m + n of its lanes); tile t
holds the diagonals t KT + 1 .. t KT + KT (KT a multiple of 4, so a tile's
bytes of the move stream are whole), and the block walks tiles
ceil(top / KT) - 1 .. 0, each staged into a ring of S stages of the
block's shared memory before the walking warp reads it: the band's slab
ptrs[d, 0:Wp, b0:b0 + LPB] as a byte tile and lo[d, b0:b0 + LPB] as an
int32 tile.  The bytes of the stream above the top tile are 0xFF.  Two
copy routes lay the byte tile out:
  tma      the box [KT][Wp][LPB], rows of LPB bytes, zeros past D1 or B;
  shifted  rows at byte_stride(LPB), the aligned words that hold the
           row's lanes below B (rows past D1 not copied: stale from an
           earlier tile), which the walker reads at the row's byte shift
           ((d Wp + k) B + band address) mod 4.
The walker is the kernel's `walk_step`: it reads only the block's shared
memory, at `at`, the offset of its lane's pointer byte in the stage's byte
tile or of a zero word where the row k = i - lo[d] lies outside [0, Wp).
`at` is found from the staged lo at each tile's top diagonal and after
that one diagonal ahead: before the pointer of d is read, the two offsets
of d - 1 (after no move of i and after one) are formed, and the move picks
one.  A lane whose m + n lies past D1 - 1 starts on diagonal -1 and never
moves, as in the scans.

Here the scheme runs in numpy, the band placed at a byte shift inside a
buffer of garbage (so that a read outside the copied words shows), the
shared memory and the ring's stages filled with garbage at the start and
the stages reused.  Its streams are held byte for byte to
`nw_moves_plain` / `mea_moves_plain` and to the JAX package's
`nw_moves_device` / `mea_moves_device` + `pack_moves`, at LPB 16 and 32,
KT 8 and 16, on B = 33, 36, 37 and 48 lanes (no multiple of LPB) with
D1 - 1 = 123 (no multiple of 4 or KT), lanes sorted by m + n so that block
tops fall on tile edges (32, 64) and far below D1 - 1, lanes with m = 0,
n = 0 and m = n = 0, lanes with m + n = D1 and D1 + 5 (past D1 - 1),
random pointers (walks that leave the band, every NW bit pattern) and the
pointers of the plain K1 and K4, and NW walks from each of the three final
states.  MEA pointer 3 is held to the native traceback, which reads it as
I with i alone decremented, as tests/test_torch_traceback_device.py
`test_mea_pointer_three_follows_native` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops.traceback_device import (
    mea_moves_device, nw_moves_device, pack_moves as jpack_moves,
)
from marginalign_trna_tpu_torch import native
from marginalign_trna_tpu_torch.ops import traceback_device as tb
from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
from marginalign_trna_tpu_torch.ops.fb import device_batch
from marginalign_trna_tpu_torch.ops.mea import NEG, mea_weights
from marginalign_trna_tpu_torch.ops.wavefront_cuda import (
    banded_mea_plain, banded_nw_plain,
)

NW_PARAMS = (1.0, -2.0, -3.0, -1.0)
D1 = 124  # D1 - 1 = 123: no multiple of 4, 8 or 16
STAGES = 3
# csrc/traceback.cu: the zero word and the ring's start in the block's
# shared memory.
TB_ZERO, TB_RING = 128, 256
# (route, B, the band's address mod 4)
CASES = [("tma", 48, 0), ("shifted", 36, 0), ("shifted", 33, 1),
         ("shifted", 37, 3), ("shifted", 36, 2)]
CASE_IDS = ["%s_B%d_at%d" % c for c in CASES]


def byte_stride(lpb):
    """csrc/common.cuh `mk::byte_stride`."""
    return 4 * ((lpb // 4) | 1)


def lane_sizes(B, seed):
    """(m, n) of B lanes sorted by m + n: m = n = 0, n = 0 and m = 0 first,
    then lanes up to m + n = 32, 64 and D1 - 1 = 123, each bound reached
    by the last lane below it, so that blocks of 16 lanes top out at 32,
    64 and 123 and blocks of 32 at 64 and 123."""
    rng = np.random.default_rng(seed)

    def split(s):
        m = int(rng.integers(0, s + 1))
        return m, s - m

    sizes = [(0, 0), (6, 0), (0, 5)]
    for lo_s, hi_s, last in ((2, 32, 15), (33, 64, 31), (65, 123, B - 1)):
        count = last + 1 - len(sizes)
        sums = sorted(int(x) for x in rng.integers(lo_s, hi_s, count - 1))
        sizes += [split(s) for s in sums] + [split(hi_s)]
    assert len(sizes) == B
    return sizes


def lanes_batch(B, width, seed):
    """A batch of B random pairs of `lane_sizes` at D1 = 124."""
    rng = np.random.default_rng(seed + 1)
    sizes = lane_sizes(B, seed)
    reads = [rng.integers(0, 4, m).astype(np.int8) for m, _ in sizes]
    refs = [rng.integers(0, 4, n).astype(np.int8) for _, n in sizes]
    return pack_banded_batch(reads, refs, width=width, pad_batch_to=B,
                             pad_steps_to=D1)


def stage(smem, base, ptile, mem, shift, ptrs, lo, d0, kt, b0, lpb, route):
    """Stages the tile of diagonals d0 .. d0 + kt - 1 into the stage at
    `base` of the block's shared memory `smem`: the byte tile, then from
    `ptile` on the int32 tile of lo, as the route's producer does."""
    D1_, Wp, B = ptrs.shape
    nd = min(kt, D1_ - d0)
    nl = min(lpb, B - b0)
    lot = smem[base + ptile:base + ptile + 4 * kt * lpb].view(np.int32)
    if route == "tma":
        box = np.zeros((kt, Wp, lpb), np.uint8)
        box[:nd, :, :nl] = ptrs[d0:d0 + nd, :, b0:b0 + nl]
        smem[base:base + box.size] = box.reshape(-1)
        lbox = np.zeros((kt, lpb), np.int32)
        lbox[:nd, :nl] = lo[d0:d0 + nd, b0:b0 + nl]
        lot[:] = lbox.reshape(-1)
        return
    S = byte_stride(lpb)
    for dd in range(nd):
        for k in range(Wp):
            row = base + (dd * Wp + k) * S
            first = shift + ((d0 + dd) * Wp + k) * B + b0
            for c in range(lpb // 4 + 1):
                word = (first & ~3) + 4 * c
                if word <= first + nl - 1:
                    smem[row + 4 * c:row + 4 * c + 4] = mem[word:word + 4]
        lot[dd * lpb:dd * lpb + nl] = lo[d0 + dd, b0:b0 + nl]


def walk_step(smem, w, act, nxt, c1, lo1, sh0, sh1, Wp, RS, lo_at, hi_at,
              nw):
    """csrc/traceback.cu `walk_step` over the lanes of a block: the move
    (NO_MOVE where not `act`), the position and state after it and, where
    `nxt`, `at` for the next diagonal, chosen after the move from the two
    candidate offsets found before the pointer was read (row 0 of the next
    diagonal at c1 less lo1 rows; sh0 / sh1 the byte shifts after no move /
    a move of i).  Every read lies in the stage's byte tile [lo_at, hi_at)
    or on the zero word."""
    at = w["at"]
    assert np.all((at == TB_ZERO) | ((at >= lo_at) & (at < hi_at)))
    p = smem[at].astype(np.int64)
    i, j = w["i"], w["j"]
    zi, zj = i == 0, j == 0
    if nw:
        state = w["state"]
        e0 = state == 0
        st = np.where(e0 & zi, 1, np.where(e0 & zj, 2, state))
        m, x = st == 0, st == 1
        mv = np.where(m, 0, np.where(x, 2, 1))
        di, dj = ~x, m | x
        ns = np.where(m, p & 3, np.where(x, (p >> 2) & 1, ((p >> 3) & 1) * 2))
        w["state"] = np.where(act, ns, state)
    else:
        di = ~zi & (zj | (p != 1))
        dj = zi | (~zj & (p <= 1))
        mv = np.where(zi, 2, np.where(zj, 1, np.where(
            p == 0, 0, np.where(p == 1, 2, 1))))
    if nxt:
        k0 = i - lo1
        c = c1 - lo1 * RS + w["irs"]
        a0 = np.where((k0 >= 0) & (k0 < Wp), c + sh0, TB_ZERO)
        a1 = np.where((k0 - 1 >= 0) & (k0 - 1 < Wp), c - RS + sh1, TB_ZERO)
        w["at"] = np.where(act & di, a1, a0)
    step = act & di
    w["i"] = i - step
    w["irs"] = w["irs"] - np.where(step, RS, 0)
    w["j"] = j - (act & dj)
    return np.where(act, mv, tb.NO_MOVE)


def tile_moves(ptrs, lo, m, n, final_state, lpb, kt, route, shift,
               seed=0):
    """The packed move stream [ceil((D1 - 1) / 4), B] of the block scheme
    (NW where final_state is given, else MEA), walked as the kernel walks:
    a lane whose m + n lies past D1 - 1 starts on diagonal -1 (i = 0,
    j = -1), `at` is found from lo at each tile's top diagonal and then one
    diagonal ahead."""
    D1_, Wp, B = ptrs.shape
    T, P, KB = D1_ - 1, (D1_ - 1 + 3) // 4, kt // 4
    rng = np.random.default_rng(seed)
    mem = rng.integers(0, 256, shift + ptrs.size + 8).astype(np.uint8)
    mem[shift:shift + ptrs.size] = ptrs.reshape(-1)
    RS = lpb if route == "tma" else byte_stride(lpb)
    ptile = (kt * Wp * RS + 127) // 128 * 128
    stage_bytes = ptile + kt * lpb * 4
    smem = rng.integers(0, 256, TB_RING + STAGES * stage_bytes).astype(
        np.uint8)
    smem[TB_ZERO:TB_ZERO + 4] = 0

    def shift_of(d, k):  # the byte shift of row k at diagonal d
        return (shift + (d * Wp + k) * B) % 4 if route == "shifted" else 0

    nw = final_state is not None
    out = np.full((P, B), 0x5A, np.uint8)
    tops = []
    for b0 in range(0, B, lpb):
        lane = np.arange(lpb)
        b = b0 + lane
        live = b < B
        bc = np.minimum(b, B - 1)
        size = np.where(live, m[bc] + n[bc], 0).astype(np.int64)
        top = max(0, min(T, int(size.max())))
        tops.append(top)
        tiles = (top + kt - 1) // kt
        out[tiles * KB:, b[live]] = 0xFF
        walks = live & (size <= T)
        i = np.where(walks, m[bc], 0).astype(np.int64)
        w = {"i": i, "j": np.where(walks, n[bc], -1).astype(np.int64),
             "irs": i * RS, "at": np.full(lpb, TB_ZERO, np.int64),
             "state": np.where(walks, final_state[bc], 0).astype(np.int64)
             if nw else None}
        for it in range(tiles):
            t = tiles - 1 - it
            base = TB_RING + (it % STAGES) * stage_bytes
            stage(smem, base, ptile, mem, shift, ptrs, lo, t * kt + 1, kt,
                  b0, lpb, route)
            lod = smem[base + ptile:base + ptile + 4 * kt * lpb].view(
                np.int32).reshape(kt, lpb).astype(np.int64)
            dd = kt - 1
            k = w["i"] - lod[dd]
            w["at"] = np.where((k >= 0) & (k < Wp),
                               base + (dd * Wp + k) * RS + lane
                               + shift_of(t * kt + 1 + dd, k), TB_ZERO)
            for qb in range(KB - 1, -1, -1):
                q = t * KB + qb
                byte = np.zeros(lpb, np.int64)
                for s4 in range(3, -1, -1):
                    dd = 4 * qb + s4
                    d = t * kt + 1 + dd
                    d1 = max(dd - 1, 0)
                    i = w["i"]
                    mv = walk_step(smem, w, i + w["j"] == d, dd > 0,
                                   base + d1 * Wp * RS + lane, lod[d1],
                                   shift_of(d - 1, i - lod[d1]),
                                   shift_of(d - 1, i - 1 - lod[d1]), Wp, RS,
                                   base, base + ptile, nw)
                    byte |= mv << (2 * s4)
                if q < P:
                    out[q, b[live]] = byte[live]
    return out, tops


def lanes_of(batch):
    """lo, m, n of `batch`, its last lane lengthened to m + n = D1 + 5 and,
    where it lies in the last block of 16 lanes, the one before it to
    m + n = D1: lanes past D1 - 1, which never move (the block tops stay
    those of `lane_sizes`)."""
    lo, m, n = (np.array(a, np.int32) for a in (batch.lo, batch.m, batch.n))
    B = m.size
    for b, size in ((B - 1, D1 + 5), (B - 2, D1)):
        if b >= 32:
            m[b] = size - n[b]
    return lo, m, n


def plain_nw(ptrs, lo, m, n, fs):
    return tb.nw_moves_plain(*(torch.from_numpy(a) for a in
                               (ptrs, lo, m, n, fs))).numpy()


def plain_mea(ptrs, lo, m, n):
    return tb.mea_moves_plain(*(torch.from_numpy(a) for a in
                                (ptrs, lo, m, n))).numpy()


def jax_nw(ptrs, lo, m, n, fs):
    return np.asarray(jpack_moves(nw_moves_device(
        *(jnp.asarray(a) for a in (ptrs, lo, m, n, fs)))))


def jax_mea(ptrs, lo, m, n):
    return np.asarray(jpack_moves(mea_moves_device(
        *(jnp.asarray(a) for a in (ptrs, lo, m, n)))))


def check_tops(tops, lpb):
    assert tops == ([32, 64, 123] if lpb == 16 else [64, 123])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("kt", [8, 16])
@pytest.mark.parametrize("lpb", [16, 32])
def test_nw_tiles_random_pointers(lpb, kt, case):
    """Random pointers (every NW bit pattern, walks leaving the band) and
    final states M, Ix, Iy lane by lane: the block scheme's stream equals
    the plain version's and the JAX scan's byte for byte."""
    route, B, shift = case
    batch = lanes_batch(B, 40, seed=B + lpb)
    lo, m, n = lanes_of(batch)
    Wp = batch.valid.shape[1]
    ptrs = np.random.default_rng(kt + B).integers(
        0, 16, (D1, Wp, B)).astype(np.uint8)
    fs = (np.arange(B) % 3).astype(np.int32)
    got, tops = tile_moves(ptrs, lo, m, n, fs, lpb, kt, route, shift)
    check_tops(tops, lpb)
    assert np.array_equal(got, plain_nw(ptrs, lo, m, n, fs))
    assert np.array_equal(got, jax_nw(ptrs, lo, m, n, fs))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("lpb", [16, 32])
def test_nw_tiles_k1_pointers(lpb, case):
    """The plain K1's pointers and final states (the guide's inputs): the
    block scheme at KT 16 equals the plain version and the JAX scan."""
    route, B, shift = case
    batch = lanes_batch(B, 40, seed=7 * B)
    dev = device_batch(batch, "cpu")
    ptr, _, state = banded_nw_plain(NW_PARAMS, dev.xb, dev.yb, dev.valid,
                                    dev.s1, dev.s2, dev.final_d, dev.final_k)
    ptrs, fs = ptr.numpy(), state.numpy().astype(np.int32)
    lo, m, n = lanes_of(batch)
    got, _ = tile_moves(ptrs, lo, m, n, fs, lpb, 16, route, shift)
    assert np.array_equal(got, plain_nw(ptrs, lo, m, n, fs))
    assert np.array_equal(got, jax_nw(ptrs, lo, m, n, fs))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("kt", [8, 16])
@pytest.mark.parametrize("lpb", [16, 32])
def test_mea_tiles_random_pointers(lpb, kt, case):
    """Random MEA pointers 0-2 (walks leaving the band): the block scheme
    equals the plain version and the JAX scan byte for byte."""
    route, B, shift = case
    batch = lanes_batch(B, 21, seed=3 * B + lpb)
    lo, m, n = lanes_of(batch)
    Wp = batch.valid.shape[1]
    ptrs = np.random.default_rng(kt * B).integers(
        0, 3, (D1, Wp, B)).astype(np.uint8)
    got, tops = tile_moves(ptrs, lo, m, n, None, lpb, kt, route, shift)
    check_tops(tops, lpb)
    assert np.array_equal(got, plain_mea(ptrs, lo, m, n))
    assert np.array_equal(got, jax_mea(ptrs, lo, m, n))


def k4_pointers(batch, seed):
    """The plain K4's pointers over a random posterior band of `batch`."""
    dev = device_batch(batch, "cpu")
    lo, m, n = lanes_of(batch)
    post = torch.from_numpy(np.random.default_rng(seed).random(
        batch.valid.shape).astype(np.float32)) * dev.valid
    wup, wleft = mea_weights(post, dev.valid, torch.from_numpy(lo), 0.5,
                             int(m.max()), int(n.max()))
    ptr, _ = banded_mea_plain(torch.where(post > 0, post, NEG), wup, wleft,
                              dev.valid, dev.s1, dev.s2, dev.final_d,
                              dev.final_k)
    return ptr.numpy()


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("lpb", [16, 32])
def test_mea_tiles_k4_pointers(lpb, case):
    """The plain K4's pointers over a random posterior band: the block
    scheme at KT 16 equals the plain version and the JAX scan."""
    route, B, shift = case
    batch = lanes_batch(B, 21, seed=5 * B)
    ptrs = k4_pointers(batch, B)
    lo, m, n = lanes_of(batch)
    got, _ = tile_moves(ptrs, lo, m, n, None, lpb, 16, route, shift)
    assert np.array_equal(got, plain_mea(ptrs, lo, m, n))
    assert np.array_equal(got, jax_mea(ptrs, lo, m, n))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("lpb", [16, 32])
def test_mea_tiles_pointer_three_follows_native(lpb, case):
    """The plain K4's pointers with every second up move (2) of the walks
    turned into 3: the block scheme at KT 8 equals the plain version, and
    every lane's ops equal the native MEA traceback's, which reads 3 as I
    with i alone decremented (the JAX scan takes j too); the lanes past
    D1 - 1 make no move."""
    route, B, shift = case
    batch = lanes_batch(B, 21, seed=11 * B)
    ptrs = k4_pointers(batch, 13 * B)
    lo, m, n = lanes_of(batch)
    clean = tb.mea_walk_plain(*(torch.from_numpy(a) for a in
                                (ptrs, lo, m, n))).numpy()
    hit = 0
    for b in range(B):
        i, j = int(m[b]), int(n[b])
        for op in clean[::-1, b]:
            if op == tb.NO_MOVE:
                continue
            d = i + j
            k = i - int(lo[d, b])
            if op == 1 and i > 0 and j > 0 and ptrs[d, k, b] == 2:
                hit += 1
                if hit % 2:
                    ptrs[d, k, b] = 3
            i -= op != 2
            j -= op != 1
    assert hit > 4
    got, _ = tile_moves(ptrs, lo, m, n, None, lpb, 8, route, shift)
    assert np.array_equal(got, plain_mea(ptrs, lo, m, n))
    moves = tb.unpack_moves(got, D1 - 1)
    assert np.array_equal(moves, clean.astype(np.uint8))
    for b in range(B):
        if m[b] + n[b] > D1 - 1:  # past the band: the lane never moves
            assert tb.ops_from_moves(moves, b) == [], "lane %d" % b
            continue
        want = native.mea_traceback(ptrs, lo[:, b], b, int(m[b]), int(n[b]))
        assert want is not None, "native traceback unavailable (lane %d)" % b
        assert tb.ops_from_moves(moves, b) == want, "lane %d" % b
    assert not np.array_equal(got, jax_mea(ptrs, lo, m, n))
