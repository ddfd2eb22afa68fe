"""Band geometry and host-side packing for the banded pair DP.

A copy of the host packers of marginalign_trna_tpu/ops/band.py (numpy
only), so the port runs without the JAX package; behaviour is unchanged.
`band_masks` and `circ_mw_streams` are the torch counterparts of that
module's device helpers: closed forms of the band offsets, evaluated on
whatever device the offsets live on.

The DP grid is in *prefix coordinates*: cell (i, j) means "i read symbols and
j ref symbols emitted", i in [0, m], j in [0, n].  Anti-diagonal d = i + j runs
from 0 to m+n.  For each d the band is a fixed-width window of W consecutive
i-values [lo(d), lo(d)+W); lo is monotone non-decreasing with increments in
{0, 1}, so band motion between diagonals is a per-lane shift by 0 or 1 row.

Packing: a batch of reads becomes dense [D+1, Wp, B] arrays with the band
window (Wp = W + guard rows) in the middle dimension and reads in the lane
dimension (BandedBatch), several short problems per lane separated by
SPACER empty diagonals (MultiBandedBatch, `pack_multi_banded_batch`), or
only the band offsets and the packed sequences, from which the band streams
are derived on the device (CompactBandedBatch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

GUARD = 2  # minimum guard rows so rolls wrap into masked cells


def padded_band_width(width: int) -> int:
    """Band + guard rows, rounded up to a sublane multiple (8) for TPU
    tiling; the extra rows are permanently invalid."""
    return -(-(width + GUARD) // 8) * 8


def path_from_cigar(
    ops: Sequence[Tuple[int, int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix-coordinate path (d_t, i_t) of an alignment cigar.

    ops are (op, length) with 0=M, 1=I (read-only), 2=D (ref-only), relative
    to the aligned region (no clips).  Returns strictly-increasing d values
    and the corresponding i values, starting at (0, 0).
    """
    if not len(ops):
        return np.zeros(1, np.int64), np.zeros(1, np.int64)
    # Fully vectorised over runs AND bases (a per-run Python loop still
    # cost ~1.4ms/record at realign corpus sizes, e2e profile round 5):
    # each M run emits one (d, i) entry per base, I/D runs one entry at
    # the run end; within-run offsets come from one arange minus the
    # repeated exclusive run starts.
    arr = np.asarray(ops, dtype=np.int64).reshape(-1, 2)
    opv, ln = arr[:, 0], arr[:, 1]
    if opv.size and (opv.min() < 0 or opv.max() > 2):
        raise ValueError(
            "Unexpected op %d in aligned cigar" % int(
                opv[(opv < 0) | (opv > 2)][0])
        )
    i_end = np.cumsum(np.where(opv != 2, ln, 0))
    j_end = np.cumsum(np.where(opv != 1, ln, 0))
    i0 = i_end - np.where(opv != 2, ln, 0)
    j0 = j_end - np.where(opv != 1, ln, 0)
    counts = np.where(opv == 0, ln, 1)
    starts = np.cumsum(counts) - counts
    rep = np.repeat(np.arange(len(opv)), counts)
    t = np.arange(int(counts.sum()), dtype=np.int64) - starts[rep] + 1
    is_m = opv[rep] == 0
    d = np.where(is_m, i0[rep] + j0[rep] + 2 * t, i_end[rep] + j_end[rep])
    iv = np.where(is_m, i0[rep] + t, i_end[rep])
    z = np.zeros(1, np.int64)
    return np.concatenate([z, d]), np.concatenate([z, iv])


def band_offsets(
    m: int,
    n: int,
    width: int,
    path_d: Optional[np.ndarray] = None,
    path_i: Optional[np.ndarray] = None,
) -> np.ndarray:
    """lo(d) for d in [0, m+n]: the band's first i-index per anti-diagonal.

    If no guide path is given, the band follows the main diagonal (global
    alignment of similar-length sequences).  Guarantees lo(0)=0, monotone
    increments in {0, 1}, and that the band contains (0,0) and (m,n).
    """
    D = m + n
    dr = np.arange(D + 1, dtype=np.float64)
    if path_d is None:
        center = dr * (m / max(1, D))
    else:
        center = np.interp(dr, path_d.astype(np.float64), path_i.astype(np.float64))
    lo = np.floor(center).astype(np.int64) - width // 2
    hi_cap = max(0, m + 1 - width)
    lo = np.clip(lo, 0, hi_cap)
    # floor() of a <=1-slope monotone function keeps increments in {0,1}.
    steps = np.diff(lo)
    assert np.all((steps >= 0) & (steps <= 1)), "band offsets must step by 0/1"
    return lo


@dataclass
class BandedBatch:
    """A device-ready batch of banded read/ref pairs.

    Shapes: D1 = max(m+n)+1 over the batch, Wp = width + GUARD, B = batch.
      xb      [D1, Wp, B] int8   ref code at cell (d, k)   (x index j-1)
      yb      [D1, Wp, B] int8   read code at cell (d, k)  (y index i-1)
      valid   [D1, Wp, B] bool   cell inside grid and band
      s1      [D1, B]     int32  lo(d) - lo(d-1)   (0 for padded steps)
      s2      [D1, B]     int32  lo(d) - lo(d-2)
      lo      [D1, B]     int32  band offsets (for unpacking results)
      final_d [B]         int32  d of terminal cell (m, n)
      final_k [B]         int32  band index of terminal cell
      m, n    [B]         int32  sequence lengths
    """

    xb: np.ndarray
    yb: np.ndarray
    valid: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    lo: np.ndarray
    final_d: np.ndarray
    final_k: np.ndarray
    m: np.ndarray
    n: np.ndarray
    width: int

    @property
    def num_steps(self) -> int:
        return self.xb.shape[0]

    @property
    def batch(self) -> int:
        return self.xb.shape[2]

    @property
    def wp(self) -> int:
        return self.xb.shape[1]

    def dp_cells(self) -> int:
        """Number of in-band DP cells (for throughput accounting)."""
        return int(self.valid.sum())


def pack_banded_batch(
    reads: Sequence[np.ndarray],
    refs: Sequence[np.ndarray],
    width: int,
    paths: Optional[Sequence[Optional[Tuple[np.ndarray, np.ndarray]]]] = None,
    pad_batch_to: Optional[int] = None,
    pad_steps_to: Optional[int] = None,
    quantize: bool = False,
) -> BandedBatch:
    """Pack encoded read/ref code arrays into a BandedBatch.

    reads[b], refs[b]: int8 code arrays (A=0..T=3, N=4).  paths[b] is an
    optional (path_d, path_i) guide path in prefix coordinates.  With
    quantize=True, the step count rounds up a geometric ladder (powers of
    two from 128 to 1024, multiples of 1024 beyond) and the lane count to
    a power of two, so repeated calls reuse compiled kernels while
    short-read (tRNA-scale) batches stop paying ~5x step padding.
    """
    B0 = len(reads)
    assert len(refs) == B0
    ms = np.array([len(r) for r in reads], dtype=np.int64)
    ns = np.array([len(r) for r in refs], dtype=np.int64)
    D1 = int((ms + ns).max()) + 1
    if pad_steps_to is not None:
        assert pad_steps_to >= D1
        D1 = pad_steps_to
    elif quantize:
        if D1 <= 1024:
            D1 = max(128, 1 << (D1 - 1).bit_length())
        else:
            D1 = -(-D1 // 1024) * 1024
    B = pad_batch_to if pad_batch_to is not None else B0
    if pad_batch_to is None and quantize:
        B = 1 << max(3, (B0 - 1).bit_length())
    assert B >= B0
    Wp = padded_band_width(width)

    xb = np.zeros((D1, Wp, B), dtype=np.int8)
    yb = np.zeros((D1, Wp, B), dtype=np.int8)
    valid = np.zeros((D1, Wp, B), dtype=bool)
    s1 = np.zeros((D1, B), dtype=np.int32)
    s2 = np.zeros((D1, B), dtype=np.int32)
    lo_all = np.zeros((D1, B), dtype=np.int32)
    final_d = np.zeros(B, dtype=np.int32)
    final_k = np.zeros(B, dtype=np.int32)
    m_arr = np.zeros(B, dtype=np.int32)
    n_arr = np.zeros(B, dtype=np.int32)

    ks = np.arange(Wp, dtype=np.int64)[None, :]  # [1, Wp]
    from .. import native as _native

    use_native = _native.available() and B == xb.shape[2]

    for b in range(B0):
        m, n = int(ms[b]), int(ns[b])
        D = m + n
        if paths is not None and paths[b] is not None:
            pd, pi = paths[b]
            lo = band_offsets(m, n, width, pd, pi)
        else:
            lo = band_offsets(m, n, width)

        if use_native and _native.pack_band_lane(
            reads[b], refs[b], lo, width, xb, yb, valid, b
        ):
            pass
        else:
            dcol = np.arange(D + 1, dtype=np.int64)[:, None]  # [D+1, 1]
            i_idx = lo[:, None] + ks  # [D+1, Wp]
            j_idx = dcol - i_idx
            ok = (
                (ks < width)
                & (i_idx >= 0)
                & (i_idx <= m)
                & (i_idx <= dcol)
                & (j_idx >= 0)
                & (j_idx <= n)
            )
            # Emission symbol indices (invalid cells are masked anyway).
            y_sym = np.clip(i_idx - 1, 0, max(0, m - 1))
            x_sym = np.clip(j_idx - 1, 0, max(0, n - 1))
            yb[: D + 1, :, b] = reads[b][y_sym] if m > 0 else 4
            xb[: D + 1, :, b] = refs[b][x_sym] if n > 0 else 4
            valid[: D + 1, :, b] = ok
        lo_all[: D + 1, b] = lo
        lo_all[D + 1 :, b] = lo[-1]
        s1[1 : D + 1, b] = np.diff(lo)
        s2[2 : D + 1, b] = lo[2:] - lo[:-2]
        final_d[b] = D
        final_k[b] = m - lo[-1]
        m_arr[b] = m
        n_arr[b] = n

    return BandedBatch(
        xb=xb, yb=yb, valid=valid, s1=s1, s2=s2, lo=lo_all,
        final_d=final_d, final_k=final_k, m=m_arr, n=n_arr, width=width,
    )


SPACER = 2  # zero-valid diagonals between packed problems: enough to clear
# both DP frontier generations (d-1 and d-2) before the next start injection


@dataclass
class PackedProblem:
    """Where one read/ref pair lives inside a MultiBandedBatch."""

    lane: int
    d0: int        # global step of the problem's local d = 0
    final_d: int   # global step of its terminal cell (m, n)
    final_k: int   # band row of the terminal cell
    m: int
    n: int


@dataclass
class MultiBandedBatch(BandedBatch):
    """Several problems per lane, separated by SPACER invalid diagonals.

    Short-read workloads (tRNA: D ~ 200) waste most of a quantized
    [D1, Wp, B] batch on step padding; packing ~D1/D problems per lane
    recovers that utilisation with the same kernels.  The per-step streams
    gain in-stream semantics:
      start [D1, B] int8   1 at each problem's local d=0 (forward inits by
                           injecting the start distribution there)
      find  [D1, B] int32  d at each problem's terminal step, else -1 (the
                           backward injects/reset-scales there)
      fink  [D1, B] int32  terminal band row at terminal steps, else -1
    BandedBatch.final_d/final_k are per-problem arrays here ([P] not [B]).
    """

    start: np.ndarray = None
    find: np.ndarray = None
    fink_steps: np.ndarray = None
    problems: List[PackedProblem] = None
    # Per-problem step->problem-final map for the device L stream:
    step_final: np.ndarray = None  # [D1, B] int32: final_d of owning
    # problem for every in-problem step (self otherwise)
    dloc: np.ndarray = None  # [D1, B] int32: local diagonal d - d0 of the
    # owning problem (0 at spacers/padding), for local (i, j) coordinates


def pack_multi_banded_batch(
    reads: Sequence[np.ndarray],
    refs: Sequence[np.ndarray],
    width: int,
    paths: Optional[Sequence[Optional[Tuple[np.ndarray, np.ndarray]]]] = None,
    pad_steps_to: int = 1024,
    pad_batch_to: Optional[int] = None,
) -> MultiBandedBatch:
    """Pack problems several-per-lane into [D1, Wp, B] streams.

    Greedy first-fit by descending size; D1 = pad_steps_to (problems longer
    than that get a lane of their own with D1 raised to fit them)."""
    P = len(reads)
    assert len(refs) == P
    sizes = [len(reads[p]) + len(refs[p]) + 1 for p in range(P)]
    order = sorted(range(P), key=lambda p: -sizes[p])
    D1 = max(pad_steps_to, max(sizes) if sizes else 1)

    # Best-fit decreasing into lanes of capacity D1 (+SPACER: the trailing
    # spacer is free).  A sorted (remaining, lane) list with bisect keeps
    # this O(P log B) — the earlier first-fit scan was O(P x B), which is
    # minutes of host time at the tens of thousands of problems produced
    # by anchor splitting.
    import bisect

    cap = D1 + SPACER
    free: List[Tuple[int, int]] = []  # (remaining, lane_idx), sorted
    assign: List[List[int]] = []
    for p in order:
        need = sizes[p] + SPACER
        k = bisect.bisect_left(free, (need, -1))
        if k < len(free):
            rem, li = free.pop(k)
            assign[li].append(p)
            rem -= need
            if rem > 0:
                bisect.insort(free, (rem, li))
        else:
            li = len(assign)
            assign.append([p])
            rem = cap - need
            if rem > 0:
                bisect.insort(free, (rem, li))
    B0 = len(assign)
    B = pad_batch_to if pad_batch_to is not None else (
        1 << max(3, (B0 - 1).bit_length())
    )
    assert B >= B0
    Wp = padded_band_width(width)

    xb = np.zeros((D1, Wp, B), dtype=np.int8)
    yb = np.zeros((D1, Wp, B), dtype=np.int8)
    valid = np.zeros((D1, Wp, B), dtype=bool)
    s1 = np.zeros((D1, B), dtype=np.int32)
    s2 = np.zeros((D1, B), dtype=np.int32)
    lo_all = np.zeros((D1, B), dtype=np.int32)
    start = np.zeros((D1, B), dtype=np.int8)
    find = np.full((D1, B), -1, dtype=np.int32)
    fink_steps = np.full((D1, B), -1, dtype=np.int32)
    step_final = np.zeros((D1, B), dtype=np.int32)
    dloc = np.zeros((D1, B), dtype=np.int32)

    ks = np.arange(Wp, dtype=np.int64)[None, :]
    problems: List[Optional[PackedProblem]] = [None] * P
    for li, plist in enumerate(assign):
        cursor = 0
        for p in plist:
            m, n = len(reads[p]), len(refs[p])
            D = m + n
            if paths is not None and paths[p] is not None:
                pd, pi = paths[p]
                lo = band_offsets(m, n, width, pd, pi)
            else:
                lo = band_offsets(m, n, width)
            d0 = cursor
            sl = slice(d0, d0 + D + 1)
            dcol = np.arange(D + 1, dtype=np.int64)[:, None]
            i_idx = lo[:, None] + ks
            j_idx = dcol - i_idx
            ok = (
                (ks < width)
                & (i_idx >= 0) & (i_idx <= m) & (i_idx <= dcol)
                & (j_idx >= 0) & (j_idx <= n)
            )
            y_sym = np.clip(i_idx - 1, 0, max(0, m - 1))
            x_sym = np.clip(j_idx - 1, 0, max(0, n - 1))
            yb[sl, :, li] = reads[p][y_sym] if m > 0 else 4
            xb[sl, :, li] = refs[p][x_sym] if n > 0 else 4
            valid[sl, :, li] = ok
            lo_all[sl, li] = lo
            s1[d0 + 1 : d0 + D + 1, li] = np.diff(lo)
            s2[d0 + 2 : d0 + D + 1, li] = lo[2:] - lo[:-2]
            start[d0, li] = 1
            find[d0 + D, li] = d0 + D
            fink_steps[d0 + D, li] = m - lo[-1]
            step_final[sl, li] = d0 + D
            dloc[sl, li] = np.arange(D + 1, dtype=np.int32)
            problems[p] = PackedProblem(
                lane=li, d0=d0, final_d=d0 + D, final_k=int(m - lo[-1]),
                m=m, n=n,
            )
            cursor = d0 + D + 1 + SPACER

    probs = [pr for pr in problems if pr is not None]
    assert len(probs) == P
    return MultiBandedBatch(
        xb=xb, yb=yb, valid=valid, s1=s1, s2=s2, lo=lo_all,
        final_d=np.array([problems[p].final_d for p in range(P)], np.int32),
        final_k=np.array([problems[p].final_k for p in range(P)], np.int32),
        m=np.array([problems[p].m for p in range(P)], np.int32),
        n=np.array([problems[p].n for p in range(P)], np.int32),
        width=width,
        start=start, find=find, fink_steps=fink_steps,
        problems=[problems[p] for p in range(P)],
        step_final=step_final, dloc=dloc,
    )


def unpack_problem(
    values: np.ndarray, mb: MultiBandedBatch, p: int, fill: float = 0.0
) -> np.ndarray:
    """Dense [m, n] pair matrix for problem p of a MultiBandedBatch."""
    pr = mb.problems[p]
    m, n = pr.m, pr.n
    vals = values[:, :, pr.lane] if values.ndim == 3 else values
    out = np.full((m, n), fill, dtype=vals.dtype)
    ks = np.arange(mb.wp)
    for dl in range(1, m + n + 1):
        d = pr.d0 + dl
        lo = int(mb.lo[d, pr.lane])
        i = lo + ks
        j = dl - i
        ok = mb.valid[d, :, pr.lane] & (i >= 1) & (j >= 1) & (i <= m) & (j <= n)
        out[i[ok] - 1, j[ok] - 1] = vals[d, ok]
    return out


def band_masks(lo: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
               width: int, Wp: int):
    """(valid [D1, Wp, B] bool, s1 [D1, B] int32, s2 [D1, B] int32) from
    the [D1, B] band offsets and the lengths m, n [B]: the closed forms
    pack_banded_batch evaluates on the host, on lo's device
    (marginalign_trna_tpu/ops/band.py `band_masks_device`).  Padded lanes
    (m = n = 0) are invalid everywhere."""
    lo = lo.int()
    D1, B = lo.shape
    d = torch.arange(D1, dtype=torch.int32, device=lo.device)[:, None, None]
    k = torch.arange(Wp, dtype=torch.int32, device=lo.device)[None, :, None]
    i = lo[:, None, :] + k
    j = d - i
    m3 = m.int()[None, None, :]
    n3 = n.int()[None, None, :]
    valid = ((k < width) & (i >= 0) & (i <= m3) & (i <= d) & (j >= 0)
             & (j <= n3) & (m3 + n3 > 0))
    s1 = torch.zeros_like(lo)
    s2 = torch.zeros_like(lo)
    s1[1:] = lo[1:] - lo[:-1]
    s2[2:] = lo[2:] - lo[:-2]
    return valid, s1, s2


def circ_mw_streams(lo: torch.Tensor, width: int, Wp: int, d1k: int):
    """(fr, frr, lom) [d1k, B] int32 from the [D1, B] band offsets
    (edge-replicated to d1k), on lo's device
    (marginalign_trna_tpu/ops/band.py `circ_mw_streams_device` and its
    host twins circ_flush_rows, circ_row_flush_rows, circ_lo_mod_rows):
      fr   the circular row of the reference position j that completes at
           diagonal d, i.e. where gu = d - lo first reaches j + width, which
           is where lo does not step: (lo + width) mod Wp, else -1;
      frr  the circular row of the read position that leaves the band
           where lo steps: (lo - 1) mod Wp, else -1;
      lom  lo mod Wp, the rotation from circular to band-relative rows."""
    lo = lo.int()
    D1, B = lo.shape
    if d1k > D1:
        lo = torch.cat([lo, lo[-1:].expand(d1k - D1, B)], dim=0)
    moved = torch.zeros_like(lo, dtype=torch.bool)
    moved[1:] = lo[1:] != lo[:-1]
    still = ~moved
    still[0] = False
    fr = torch.where(still, (lo + width) % Wp, -1)
    frr = torch.where(moved, (lo - 1) % Wp, -1)
    return fr.int(), frr.int(), (lo % Wp).int()


def circular_streams(batch: BandedBatch):
    """(xb, yb, valid, fink) in the circular layout
    (marginalign_trna_tpu/ops/band.py `circular_streams`): row r of
    diagonal d holds the cell whose read prefix index is i = r (mod Wp),
    i.e. circ[d, r] = rel[d, (r - lo(d)) mod Wp], so the band moves between
    diagonals by an unconditional roll.  fink[b] = m[b] mod Wp is the
    terminal cell's (fixed) circular row.  Chunked along d to bound the
    index scratch.  The host form of what ops/fb.py `circ_device_batch`
    does on the device (`rel_to_circ_device`)."""
    D1, Wp, B = batch.xb.shape
    xb_c = np.empty_like(batch.xb)
    yb_c = np.empty_like(batch.yb)
    valid_c = np.empty_like(batch.valid)
    rows = np.arange(Wp, dtype=np.int32)[None, :, None]
    CH = 512
    for d0 in range(0, D1, CH):
        sl = slice(d0, min(d0 + CH, D1))
        lo = batch.lo[sl][:, None, :].astype(np.int32)
        idx = (rows - lo) % Wp  # rel row k feeding circ row r
        xb_c[sl] = np.take_along_axis(batch.xb[sl], idx, axis=1)
        yb_c[sl] = np.take_along_axis(batch.yb[sl], idx, axis=1)
        valid_c[sl] = np.take_along_axis(batch.valid[sl], idx, axis=1)
    fink = (batch.m % Wp).astype(np.int32)
    return xb_c, yb_c, valid_c, fink


def circ_to_rel(values_c: np.ndarray, batch: BandedBatch) -> np.ndarray:
    """A circular-layout [D1, Wp, B] per-cell array (e.g. the posterior
    band) in the band-relative layout: rel[d, k] = circ[d, (lo(d) + k) mod
    Wp] (marginalign_trna_tpu/ops/band.py `circ_to_rel`)."""
    D1, Wp, B = values_c.shape
    out = np.empty_like(values_c)
    rows = np.arange(Wp, dtype=np.int32)[None, :, None]
    CH = 512
    for d0 in range(0, D1, CH):
        sl = slice(d0, min(d0 + CH, D1))
        lo = batch.lo[sl][:, None, :].astype(np.int32)
        idx = (rows + lo) % Wp
        out[sl] = np.take_along_axis(values_c[sl], idx, axis=1)
    return out


# Cells per gather of the device rotations: bounds their int64 index
# scratch (8 B a cell) to 128 MB whatever the band.
_ROTATE_CELLS = 1 << 24


def _rotate_rows_device(values: torch.Tensor, lo: torch.Tensor, sign: int):
    """out[d, k] = values[d, (k + sign * lo(d)) mod Wp] per lane: a
    torch.gather along the rows per block of diagonals."""
    D1, Wp, B = values.shape
    out = torch.empty_like(values)
    rows = torch.arange(Wp, device=values.device)[None, :, None]
    step = max(1, _ROTATE_CELLS // (Wp * B))
    for d0 in range(0, D1, step):
        d1 = min(d0 + step, D1)
        idx = (rows + sign * lo[d0:d1, None, :].long()) % Wp
        out[d0:d1] = values[d0:d1].gather(1, idx)
    return out


def circ_to_rel_device(values_c: torch.Tensor, lo: torch.Tensor):
    """circ_to_rel on values_c's device (marginalign_trna_tpu/ops/band.py
    `circ_to_rel_device`); lo [D1, B] int on the same device."""
    return _rotate_rows_device(values_c, lo, 1)


def rel_to_circ_device(values: torch.Tensor, lo: torch.Tensor):
    """The inverse of circ_to_rel_device: a band-relative [D1, Wp, B]
    array in the circular layout, circ[d, r] = rel[d, (r - lo(d)) mod Wp],
    as circular_streams rotates the code and valid streams on the host."""
    return _rotate_rows_device(values, lo, -1)


@dataclass
class CompactBandedBatch:
    """Band geometry + packed sequences; no [D1, Wp, B] arrays.

    Duck-type compatible with BandedBatch for every consumer that reads
    only lo/m/n/final_d/final_k/width (the fused serving, assembly, MEA
    and traceback paths)."""

    lo: np.ndarray        # [D1, B] int32, edge-replicated past each lane
    m: np.ndarray         # [B] int32
    n: np.ndarray         # [B] int32
    final_d: np.ndarray   # [B] int32
    final_k: np.ndarray   # [B] int32
    width: int
    reads_p: np.ndarray   # [Mp, B] int8 packed read codes
    refs_p: np.ndarray    # [Np, B] int8 packed ref codes
    x_init: np.ndarray    # [Wp, B] int8 d=0 circular ref-code window
    y_init: np.ndarray    # [Wp, B] int8 d=0 circular read-code window

    @property
    def num_steps(self) -> int:
        return self.lo.shape[0]

    @property
    def batch(self) -> int:
        return self.lo.shape[1]

    @property
    def wp(self) -> int:
        return padded_band_width(self.width)

    def dp_cells(self) -> int:
        """In-band cell count, computed analytically from the offsets
        (matches BandedBatch.dp_cells = valid.sum())."""
        lo = self.lo.astype(np.int64)
        D1, B = lo.shape
        d = np.arange(D1, dtype=np.int64)[:, None]
        m = self.m.astype(np.int64)[None, :]
        n = self.n.astype(np.int64)[None, :]
        low = np.maximum(lo, d - n)
        high = np.minimum(np.minimum(lo + self.width - 1, m), d)
        cnt = np.clip(high - low + 1, 0, None)
        cnt = np.where((m + n) > 0, cnt, 0)
        return int(cnt.sum())


def pack_compact_batch(
    reads: Sequence[np.ndarray],
    refs: Sequence[np.ndarray],
    width: int,
    paths: Optional[Sequence[Optional[Tuple[np.ndarray, np.ndarray]]]] = None,
    pad_batch_to: Optional[int] = None,
    pad_steps_to: Optional[int] = None,
    quantize: bool = False,
) -> CompactBandedBatch:
    """pack_banded_batch's geometry without the band-shaped arrays.

    Same quantization ladder; packed sequence buffers round up to 512
    rows so repeated buckets reuse compiled executables."""
    B0 = len(reads)
    assert len(refs) == B0
    ms = np.array([len(r) for r in reads], dtype=np.int64)
    ns = np.array([len(r) for r in refs], dtype=np.int64)
    D1 = int((ms + ns).max()) + 1 if B0 else 1
    if pad_steps_to is not None:
        assert pad_steps_to >= D1
        D1 = pad_steps_to
    elif quantize:
        if D1 <= 1024:
            D1 = max(128, 1 << (D1 - 1).bit_length())
        else:
            D1 = -(-D1 // 1024) * 1024
    B = pad_batch_to if pad_batch_to is not None else B0
    if pad_batch_to is None and quantize:
        B = 1 << max(3, (B0 - 1).bit_length())
    assert B >= B0
    Wp = padded_band_width(width)
    Mp = -(-(int(ms.max(initial=0)) + Wp + 1) // 512) * 512
    Np = -(-(int(ns.max(initial=0)) + Wp + 1) // 512) * 512

    lo_all = np.zeros((D1, B), dtype=np.int32)
    final_d = np.zeros(B, dtype=np.int32)
    final_k = np.zeros(B, dtype=np.int32)
    m_arr = np.zeros(B, dtype=np.int32)
    n_arr = np.zeros(B, dtype=np.int32)
    reads_p = np.zeros((Mp, B), dtype=np.int8)
    refs_p = np.zeros((Np, B), dtype=np.int8)
    y_init = np.zeros((Wp, B), dtype=np.int8)
    x_init = np.zeros((Wp, B), dtype=np.int8)
    rows = np.arange(Wp, dtype=np.int64)

    for b in range(B0):
        m, n = int(ms[b]), int(ns[b])
        D = m + n
        if paths is not None and paths[b] is not None:
            pd, pi = paths[b]
            lo = band_offsets(m, n, width, pd, pi)
        else:
            lo = band_offsets(m, n, width)
        lo_all[: D + 1, b] = lo
        lo_all[D + 1 :, b] = lo[-1]
        final_d[b] = D
        final_k[b] = m - lo[-1]
        m_arr[b] = m
        n_arr[b] = n
        reads_p[:m, b] = reads[b]
        refs_p[:n, b] = refs[b]
        # d=0 circular windows: row r holds i = r (lo(0) = 0), so the
        # read window is reads[clip(r-1, 0, m-1)] and the ref window is
        # refs[clip(j-1, .)] = refs[0] everywhere (j = -r <= 0) — the
        # same clip conventions pack_banded_batch uses (band.py:222-225).
        if m > 0:
            y_init[:, b] = reads[b][np.clip(rows - 1, 0, m - 1)]
        if n > 0:
            x_init[:, b] = refs[b][0]

    return CompactBandedBatch(
        lo=lo_all, m=m_arr, n=n_arr, final_d=final_d, final_k=final_k,
        width=width, reads_p=reads_p, refs_p=refs_p,
        x_init=x_init, y_init=y_init,
    )

