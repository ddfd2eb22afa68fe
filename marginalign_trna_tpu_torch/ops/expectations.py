"""Assembly of per-position sums from the fused passes' flushed streams.

Port of the fused-kernel assembly of marginalign_trna_tpu/ops/
expectations.py (`fused_flush_jmaps_device`, `fused_row_jmaps_device`,
`band_expectations_cx` on its scatter path).  The cx_forward pass
(ops/fb_circ.py) flushes each completed reference position's four totals
at one diagonal and leaves the last window's positions in its accumulator
tails; every such value has one global target position, derived here from
the band offsets, and the scatter_lanesum kernel (ops/bucket_scatter.py)
adds them over lanes into a dense [rg, 4] tensor.  The mw_forward pass
flushes column and row posterior sums the same way; their targets are
local positions (`fused_flush_jmaps` at offset 0, `fused_row_jmaps`), kept
per lane by the scatter_lanes kernel (ops/mea.py
`rowcol_sums_from_flushed`).  The JAX package pads the flush rows to its TPU
kernels' 128-row groups before the tails; the card's scatters have no row
groups, so here the tails follow the flush rows directly.

A model whose gap emissions are not flat cannot run the fused passes; its
posterior band (ops/fb_generic_cuda.py) is summed per reference position by
`band_expectations`, plain torch ops on the band's device (the JAX package's
XLA `_expectations_device`).

Multi-problem lanes (ops/band.py `pack_multi_banded_batch`) give every
packed problem a disjoint window of a per-lane virtual position space
(`_lane_virtual_offsets`); `expectations_multi` sums the posterior band
into it on the device as the JAX package's XLA
`_expectations_multi_device` does (a banded monotone segment sum: cumulative
sums along the diagonals, gathered at the boundaries of each position), one
read code at a time so memory stays at one cumulative band, and
`multi_band_expectations` adds each problem's window into the global
per-position counts on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .band import BandedBatch, CompactBandedBatch, MultiBandedBatch
from .bucket_scatter import (
    scatter_lanes_cuda, scatter_lanes_plain, scatter_lanesum_cuda,
    scatter_lanesum_plain,
)
from .dispatch import use_kernel
from .fb import DeviceBatch, FbTables, MultiDeviceBatch
from .fb_circ import (
    STEP_BLOCK, CompactCircBatch, posteriors_expectations_compact,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_flush_jmaps(lo: torch.Tensor, off: torch.Tensor, n: torch.Tensor,
                      width: int, Wp: int, d1k: int):
    """(jmap [d1k, B], jtail [Wp, B]) int32 global target positions of the
    flushed stream and of the tail rows (-1 = none).  Reference position j
    (1-based, local to the lane) completes at the first diagonal where
    gu = d - lo(d) reaches j + width, which is a diagonal where lo does not
    step; positions the last window still holds sit at tail row
    (d1k - 1 - j) mod Wp."""
    lo = lo.long()
    D1, B = lo.shape
    if d1k > D1:
        lo = torch.cat([lo, lo[-1:].expand(d1k - D1, B)], dim=0)
    off = off.long()[None, :]
    n = n.long()[None, :]
    d = torch.arange(d1k, device=lo.device)[:, None]
    gu = d - lo
    stepped = torch.cat([torch.zeros_like(lo[:1], dtype=torch.bool),
                         lo[1:] == lo[:-1]], dim=0)
    j = gu - width
    jmap = torch.where(stepped & (j >= 1) & (j <= n), off + j - 1, -1)
    gu_end = gu[-1:]
    lo_t = torch.clamp(gu_end - width + 1, min=1)
    hi_t = torch.minimum(n, gu_end)
    r = torch.arange(Wp, device=lo.device)[:, None]
    j_r = lo_t + torch.remainder(d1k - 1 - r - lo_t, Wp)
    jtail = torch.where((j_r >= lo_t) & (j_r <= hi_t), off + j_r - 1, -1)
    return jmap.to(torch.int32), jtail.to(torch.int32)


def fused_row_jmaps(lo: torch.Tensor, m: torch.Tensor, Wp: int, d1k: int):
    """(jmap [d1k, B], jtail [Wp, B]) int32 local read-position targets
    (0-based, i - 1) of the mw pass's row flush stream and row tails
    (-1 = none).  Read position i leaves the band at the first diagonal
    where lo(d) = i + 1, a diagonal where lo steps; the positions the last
    window still holds, [max(1, lo_end), m], sit at their circular row
    i mod Wp."""
    lo = lo.long()
    D1, B = lo.shape
    if d1k > D1:
        lo = torch.cat([lo, lo[-1:].expand(d1k - D1, B)], dim=0)
    m = m.long()[None, :]
    stepped = torch.cat([torch.zeros_like(lo[:1], dtype=torch.bool),
                         lo[1:] != lo[:-1]], dim=0)
    i = lo - 1
    jmap = torch.where(stepped & (i >= 1) & (i <= m), i - 1, -1)
    s = torch.clamp(lo[-1:], min=1)
    r = torch.arange(Wp, device=lo.device)[:, None]
    i_r = s + torch.remainder(r - s, Wp)
    jtail = torch.where((i_r >= s) & (i_r <= m), i_r - 1, -1)
    return jmap.to(torch.int32), jtail.to(torch.int32)


def concat_flush_tails(fl: torch.Tensor, tails: torch.Tensor,
                       jmap: torch.Tensor, jtail: torch.Tensor):
    """(vals [..., d1k + Wp, B], jm [d1k + Wp, B]): the flushed values
    fl [..., d1k, B] then the tails [..., Wp, B], beside their targets."""
    return torch.cat([fl, tails], dim=-2), torch.cat([jmap, jtail], dim=0)


def scatter_lanesum(vals: torch.Tensor, jm: torch.Tensor,
                    rg: int) -> torch.Tensor:
    """[rg, C] lane sums: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if use_kernel(vals):
        return scatter_lanesum_cuda(vals, jm, rg)
    return scatter_lanesum_plain(vals, jm, rg)


def scatter_lanes(vals: torch.Tensor, jm: torch.Tensor,
                  rg: int) -> torch.Tensor:
    """[rg, B] per-lane sums: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if use_kernel(vals):
        return scatter_lanes_cuda(vals, jm, rg)
    return scatter_lanes_plain(vals, jm, rg)


def band_expectations_cx(
    tables: FbTables,
    batch: CompactBandedBatch,
    comp: CompactCircBatch,
    ref_offsets: np.ndarray,
    total_ref_len: int,
) -> np.ndarray:
    """[total_ref_len, 4] expected base counts of one bucket.
    ref_offsets[b] is the global start of lane b's reference window; padded
    lanes (n = 0) add nothing."""
    rg = _round_up(max(total_ref_len, 1), 512)
    d1k = _round_up(batch.num_steps, STEP_BLOCK)
    _, fl, tails = posteriors_expectations_compact(tables, comp, batch.width)
    off = torch.from_numpy(np.asarray(ref_offsets, np.int64)).to(
        comp.lo.device)
    jmap, jtail = fused_flush_jmaps(comp.lo, off, comp.n, batch.width,
                                    batch.wp, d1k)
    vals, jm = concat_flush_tails(fl, tails, jmap, jtail)
    return scatter_lanesum(vals, jm, rg).cpu().numpy()[:total_ref_len]


def run_boundaries(lo: torch.Tensor, width: int) -> torch.Tensor:
    """E1[v, b] = #{d : gl(d, b) <= v} for v in [0, D1 + width], int64, on
    lo's device: gl(d, b) = d - lo(d, b) is lane b's local reference
    position after the cells of diagonal d, non-decreasing in d (the JAX
    package's `run_boundaries` in lane-local coordinates)."""
    D1, B = lo.shape
    gl = torch.arange(D1, device=lo.device)[None, :] - lo.long().T
    vs = torch.arange(D1 + width + 1, device=lo.device).expand(B, -1)
    return torch.searchsorted(gl.contiguous(), vs.contiguous(),
                              right=True).T


def band_expectations(post: torch.Tensor, batch: BandedBatch,
                      dev: DeviceBatch, ref_offsets: np.ndarray,
                      total_ref_len: int, n_real: int) -> np.ndarray:
    """[total_ref_len, 4] expected base counts of one posterior band
    [D1, Wp, B] on dev's device (marginalign_trna_tpu/ops/expectations.py
    `band_expectations`).  Cell (d, k) of lane b targets local reference
    position gl(d, b) - k - 1 = j - 1, so for a fixed band row every
    position collects a contiguous run of diagonals: per read base code, a
    cumulative sum along the diagonals and, per band row, its differences
    at the run boundaries (`run_boundaries`), summed over rows.  Each
    lane's D1 local sums are then added at ref_offsets[b] + j - 1, so
    memory grows with the band, not with total_ref_len x lanes.  Lanes
    >= n_real are padding.  Cells with i = 0 or j = 0 are boundary cells
    and emit nothing."""
    D1, Wp, _ = post.shape
    device = post.device
    post = post[:, :, :n_real]
    lo = torch.from_numpy(np.ascontiguousarray(batch.lo[:, :n_real])).to(
        device)
    e1 = run_boundaries(lo, batch.width)
    d = torch.arange(D1, device=device, dtype=lo.dtype)[:, None, None]
    i = lo[:, None, :] + torch.arange(Wp, device=device,
                                      dtype=lo.dtype)[None, :, None]
    ok = dev.valid[:, :, :n_real] & (i >= 1) & (d - i >= 1)
    del i
    yb = dev.yb[:, :, :n_real]
    zero = post.new_zeros(())
    local = post.new_zeros((D1, n_real, 4))
    for c in range(4):
        wc = torch.where(ok & (yb == c), post, zero)
        sp = torch.cat([post.new_zeros((1, Wp, n_real)),
                        torch.cumsum(wc, dim=0)])
        del wc
        acc = post.new_zeros((D1, n_real))
        for k in range(batch.width):
            gk = torch.gather(sp[:, k, :], 0, e1[k:k + D1 + 1])
            acc = acc + (gk[1:] - gk[:-1])
        local[:, :, c] = acc
        del sp
    off = torch.from_numpy(np.asarray(ref_offsets[:n_real], np.int64)).to(
        device)
    target = off[None, :] + torch.arange(D1, device=device)[:, None]
    keep = target < total_ref_len
    out = post.new_zeros((max(total_ref_len, 1), 4))
    out.index_add_(0, target[keep], local[keep])
    return out.cpu().numpy()[:total_ref_len]


# ----------------------- multi-problem lanes (short-read packing) ---------


def _lane_virtual_offsets(mb: MultiBandedBatch, per_problem_size):
    """Assign each packed problem a disjoint window in a per-lane virtual
    space, in lane (d0) order.  per_problem_size(p) -> window size needed
    (plus the band-width slack the held gu value can reach)."""
    by_lane = {}
    for p, pr in enumerate(mb.problems):
        by_lane.setdefault(pr.lane, []).append(p)
    voff = np.zeros(len(mb.problems), dtype=np.int64)
    vmax = 1
    for lane, plist in by_lane.items():
        plist.sort(key=lambda q: mb.problems[q].d0)
        cur = 0
        for p in plist:
            voff[p] = cur
            cur += per_problem_size(p) + mb.width + 1
        vmax = max(vmax, cur)
    return voff, vmax


def _multi_gu(mb: MultiBandedBatch, voff, coord: str) -> np.ndarray:
    """Monotone per-lane virtual-position stream gu [D1, B]:
    coord='ref':  voff_p + dloc - lo   (position j at band row -k-1 shift)
    coord='read': voff_p + lo          (position i at band row +k shift)
    Values hold across spacers (voff spacing keeps them monotone)."""
    D1, B = mb.lo.shape
    gu = np.zeros((D1, B), dtype=np.int64)
    by_lane = {}
    for p, pr in enumerate(mb.problems):
        by_lane.setdefault(pr.lane, []).append(p)
    for lane, plist in by_lane.items():
        plist.sort(key=lambda q: mb.problems[q].d0)
        prev_end = 0
        held = 0
        for p in plist:
            pr = mb.problems[p]
            sl = slice(pr.d0, pr.final_d + 1)
            lo = mb.lo[sl, lane].astype(np.int64)
            if coord == "ref":
                seg = voff[p] + mb.dloc[sl, lane].astype(np.int64) - lo
            else:
                seg = voff[p] + lo
            gu[prev_end : pr.d0, lane] = held
            gu[sl, lane] = seg
            held = seg[-1]
            prev_end = pr.final_d + 1
        gu[prev_end:, lane] = held
    return gu


def _multi_boundaries(gu: np.ndarray, tmin: int, tmax: int) -> np.ndarray:
    """E1[t - tmin, b] = #{d : gu(d, b) <= t} for t in [tmin, tmax], int32."""
    D1, B = gu.shape
    e1 = np.zeros((tmax - tmin + 1, B), dtype=np.int32)
    ts = np.arange(tmin, tmax + 1, dtype=np.int64)
    for b in range(B):
        e1[:, b] = np.searchsorted(gu[:, b], ts, side="right")
    return e1


def banded_segment_sums(w: torch.Tensor, e1: torch.Tensor, first: int,
                        width: int, rg: int, stride: int) -> torch.Tensor:
    """[rg, B] sums of the band w [D1, Wp, B] per virtual position: the
    cumulative sums of each band row along the diagonals, differenced at
    the boundaries e1 [*, B] (`_multi_boundaries`), band row kk reading
    rows first + stride * kk .. + rg of e1 (marginalign_trna_tpu/ops/
    expectations.py and mea.py, the loops over kk of
    `_expectations_multi_device` and `_mea_weights_multi_jit`)."""
    D1, Wp, B = w.shape
    sp = torch.cat([w.new_zeros((1, Wp, B)), torch.cumsum(w, dim=0)])
    acc = w.new_zeros((rg, B))
    e1 = e1.long()
    for kk in range(width):
        lo = first + stride * kk
        g = sp[:, kk, :].gather(0, e1[lo : lo + rg + 1])
        acc = acc + (g[1:] - g[:-1])
    return acc


def _multi_ok(mdev: MultiDeviceBatch):
    """(i, j, valid cells with i >= 1 and j >= 1) of every band cell in the
    problems' local coordinates."""
    Wp = mdev.valid.shape[1]
    k = torch.arange(Wp, dtype=torch.int32, device=mdev.lo.device)
    i = mdev.lo[:, None, :] + k[None, :, None]
    j = mdev.dloc[:, None, :] - i
    return i, j, mdev.valid & (i >= 1) & (j >= 1)


def expectations_multi(post: torch.Tensor, mdev: MultiDeviceBatch,
                       e1: torch.Tensor, width: int, rg: int
                       ) -> torch.Tensor:
    """[4, rg, B] per-lane expected base counts over the per-lane virtual
    reference spaces (marginalign_trna_tpu/ops/expectations.py
    `_expectations_multi_device`), plain torch on post's device, one read
    code at a time."""
    _, _, ok = _multi_ok(mdev)
    out = []
    for code in range(4):
        wc = torch.where(ok & (mdev.yb == code), post, 0.0)
        out.append(banded_segment_sums(wc, e1, 0, width, rg, 1))
    return torch.stack(out)


def multi_band_expectations(
    post: torch.Tensor,
    mb: MultiBandedBatch,
    mdev: MultiDeviceBatch,
    prob_ref_starts: np.ndarray,
    exp_global: np.ndarray,
) -> None:
    """Accumulate expected base counts from a multi-problem posterior band
    (on mdev's device) into exp_global [total_ref_len, 4] (in place).

    prob_ref_starts[p] = global position of problem p's reference window."""
    voff, vmax = _lane_virtual_offsets(
        mb, lambda p: mb.problems[p].n
    )
    rg = _round_up(max(int(vmax), 1), 256)
    gu = _multi_gu(mb, voff, "ref")
    e1 = torch.from_numpy(_multi_boundaries(gu, 0, rg + mb.width)).to(
        post.device)
    out = expectations_multi(post, mdev, e1, mb.width, rg).cpu().numpy()
    for p, pr in enumerate(mb.problems):
        g0 = int(prob_ref_starts[p])
        exp_global[g0 : g0 + pr.n, :] += out[:, voff[p] : voff[p] + pr.n,
                                             pr.lane].T
