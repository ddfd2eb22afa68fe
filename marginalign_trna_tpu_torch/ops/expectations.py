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
"""
from __future__ import annotations

import numpy as np
import torch

from .band import BandedBatch, CompactBandedBatch
from .bucket_scatter import (
    scatter_lanes_cuda, scatter_lanes_plain, scatter_lanesum_cuda,
    scatter_lanesum_plain,
)
from .dispatch import use_kernel
from .fb import DeviceBatch, FbTables
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
