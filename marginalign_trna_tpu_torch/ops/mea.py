"""Maximum-expected-accuracy (AMAP) realignment decode.

Port of marginalign_trna_tpu/ops/mea.py.  Objective over a monotone
alignment path:
    sum_{matched (i,j)} p(i,j) + gapGamma * sum_{skipped read i} (1 - r_i)
                              + gapGamma * sum_{skipped ref j} (1 - c_j)
where p is the posterior match probability and r_i / c_j its row and
column sums.  Pairs with p < matchGamma are disallowed.  Two paths:

  fused (`mea_decode_fused`, the default): r and c come from the mw pass's
    flushed sums (`rowcol_sums_from_flushed`, the scatter_lanes kernel) and
    the mea_dl kernel derives every weight from the posterior band and the
    sums itself;
  REL (`mea_decode`): the gap weights are plain torch bands over the
    posterior (`mea_weights`) and the DP is the banded_mea kernel;
  multi-problem lanes (`mea_decode_multi`): the gap weights are plain
    torch bands over each lane's virtual position spaces
    (`mea_weights_multi`) and the DP is the mea_multi kernel.

The plain versions run for CPU tensors.  On the fused and REL paths the
traceback walks the uint8 pointer band where it lies and only the 2-bit
move stream comes to the host (ops/traceback_device.py); over
multi-problem lanes the band comes to the host and the native host
traceback walks each problem, as in the JAX package.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import native as _native
from .band import BandedBatch, CompactBandedBatch, MultiBandedBatch
from .dispatch import use_kernel
from .expectations import (
    _lane_virtual_offsets, _multi_boundaries, _multi_gu, _multi_ok,
    _round_up, banded_segment_sums, concat_flush_tails, fused_flush_jmaps,
    fused_row_jmaps, scatter_lanes,
)
from .fb import DeviceBatch, MultiDeviceBatch
from .fb_circ import CompactCircBatch
from .traceback_device import mea_lane_ops
from .wavefront_cuda import (
    NEG, banded_mea_cuda, banded_mea_plain, mea_dl_cuda, mea_dl_plain,
    mea_multi_cuda, mea_multi_plain,
)


class MeaResult(NamedTuple):
    pointers: torch.Tensor  # [D1, Wp, B] uint8 (0=diag, 1=left/ref, 2=up/read)
    score: torch.Tensor     # [B]


def mea_weights(
    post: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
    gap_gamma: float, max_m: int, max_n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell gap weights (wup, wleft) [D1, Wp, B] from banded posteriors.
    wup[d,k,b] applies to the move that skips read symbol i-1, wleft to the
    move skipping ref symbol j-1; both are gapGamma * (1 - posterior mass of
    that row / column), clipped to [0, gapGamma].  lo is the [D1, B] band
    offset stream; max_m / max_n bound the read / ref lengths."""
    D1, Wp, B = post.shape
    dev = post.device
    d = torch.arange(D1, device=dev, dtype=torch.int64)[:, None]
    lo64 = lo.to(torch.int64)
    rows = torch.zeros((max(max_m, 1), B), dtype=post.dtype, device=dev)
    cols = torch.zeros((max(max_n, 1), B), dtype=post.dtype, device=dev)
    # Band row by band row: i = lo + k, j = d - i; each row scatters one
    # [D1, B] slab into the per-position sums.
    for k in range(Wp):
        i = lo64 + k
        j = d - i
        ok = valid[:, k, :] & (i >= 1) & (j >= 1)
        w = torch.where(ok, post[:, k, :], 0.0)
        rows.scatter_add_(0, (i - 1).clamp(0, rows.shape[0] - 1), w)
        cols.scatter_add_(0, (j - 1).clamp(0, cols.shape[0] - 1), w)
    g_read = gap_gamma * torch.clamp(1.0 - rows, 0.0, 1.0)
    g_ref = gap_gamma * torch.clamp(1.0 - cols, 0.0, 1.0)
    wup = torch.zeros_like(post)
    wleft = torch.zeros_like(post)
    for k in range(Wp):
        i = lo64 + k
        j = d - i
        vk = valid[:, k, :]
        gu = g_read.gather(0, (i - 1).clamp(0, g_read.shape[0] - 1))
        gl = g_ref.gather(0, (j - 1).clamp(0, g_ref.shape[0] - 1))
        wup[:, k, :] = torch.where(vk & (i >= 1), gu, 0.0)
        wleft[:, k, :] = torch.where(vk & (j >= 1), gl, 0.0)
    return wup, wleft


def banded_mea(wdiag, wup, wleft, valid, s1, s2, final_d,
               final_k) -> MeaResult:
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fn = banded_mea_cuda if use_kernel(wdiag) else banded_mea_plain
    return MeaResult(*fn(wdiag, wup, wleft, valid, s1, s2, final_d, final_k))


def mea_decode(
    post: torch.Tensor,
    batch: BandedBatch,
    dev: DeviceBatch,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
) -> List[List[Tuple[int, int]]]:
    """Realigned ops [(op, len)] (0=M, 1=I, 2=D spanning the full (m, n)
    region) for every lane of the batch.  post is the [D1, Wp, B] posterior
    match band on dev's device; batch is the host packing of dev.  The
    weights, the DP and the traceback stay on that device; only the move
    stream comes to the host (marginalign_trna_tpu/ops/mea.py:372-390)."""
    lo = torch.from_numpy(np.ascontiguousarray(batch.lo)).to(post.device)
    wup, wleft = mea_weights(post, dev.valid, lo, gap_gamma,
                             int(batch.m.max()), int(batch.n.max()))
    wdiag = torch.where((post >= match_gamma) & (post > 0), post, NEG)
    res = banded_mea(wdiag, wup, wleft, dev.valid, dev.s1, dev.s2,
                     dev.final_d, dev.final_k)
    return mea_lane_ops(res.pointers, lo, _lanes(batch.m, post.device),
                        _lanes(batch.n, post.device))


def _lanes(a: np.ndarray, device) -> torch.Tensor:
    """A host [B] array as an int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def rowcol_sums_from_flushed(
    comp: CompactBandedBatch, dev: CompactCircBatch, flc: torch.Tensor,
    flr: torch.Tensor, tc: torch.Tensor, tr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(accr [rgm, B], accc [rgn, B]) per-position posterior row and column
    sums of every lane from the mw pass's flush streams and tails (ops/
    fb_circ.py `posteriors_weights_compact`), rgm / rgn the longest read /
    reference rounded up to 256 (marginalign_trna_tpu/ops/mea.py
    `rowcol_sums_from_flushed`, scatter branch)."""
    d1k, B = flc.shape
    rgm = _round_up(max(int(comp.m.max()), 1), 256)
    rgn = _round_up(max(int(comp.n.max()), 1), 256)
    zero = torch.zeros(B, dtype=torch.int32, device=flc.device)
    jmap, jtail = fused_flush_jmaps(dev.lo, zero, dev.n, comp.width,
                                    comp.wp, d1k)
    accc = scatter_lanes(*concat_flush_tails(flc, tc, jmap, jtail), rgn)
    jmap, jtail = fused_row_jmaps(dev.lo, dev.m, comp.wp, d1k)
    accr = scatter_lanes(*concat_flush_tails(flr, tr, jmap, jtail), rgm)
    return accr, accc


def mea_decode_fused(
    post: torch.Tensor,
    comp: CompactBandedBatch,
    dev: CompactCircBatch,
    accr: torch.Tensor,
    accc: torch.Tensor,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
) -> List[List[Tuple[int, int]]]:
    """Realigned ops of every lane from the band-relative posterior band
    [D1, Wp, B] and the per-position sums (`rowcol_sums_from_flushed`),
    through the mea_dl kernel (its plain version for CPU tensors) and the
    mea_moves traceback on the same device (marginalign_trna_tpu/ops/
    mea.py:296-318)."""
    fn = mea_dl_cuda if use_kernel(post) else mea_dl_plain
    ptr, _ = fn(post, dev.lo, dev.m, dev.n, comp.width, dev.final_d,
                dev.final_k, accr, accc, gap_gamma, match_gamma)
    return mea_lane_ops(ptr, dev.lo, dev.m, dev.n)


def _traceback_one(
    pointers: np.ndarray, batch: BandedBatch, b: int
) -> List[Tuple[int, int]]:
    return _traceback_arrays(pointers, batch.lo[:, b], b, int(batch.m[b]),
                             int(batch.n[b]))


def _traceback_arrays(
    pointers: np.ndarray, lo: np.ndarray, b: int, m: int, n: int
) -> List[Tuple[int, int]]:
    nat = _native.mea_traceback(pointers, lo, b, m, n)
    if nat is not None:
        return nat
    i, j = m, n
    ops_rev: List[int] = []
    while not (i == 0 and j == 0):
        if i == 0:
            ops_rev.append(2)
            j -= 1
            continue
        if j == 0:
            ops_rev.append(1)
            i -= 1
            continue
        d = i + j
        k = i - int(lo[d])
        p = int(pointers[d, k, b])
        if p == 0:
            ops_rev.append(0)
            i -= 1
            j -= 1
        elif p == 1:
            ops_rev.append(2)
            j -= 1
        else:
            ops_rev.append(1)
            i -= 1
        assert i >= 0 and j >= 0
    ops_rev.reverse()
    out: List[Tuple[int, int]] = []
    for op in ops_rev:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out


# ------------------------ multi-problem lanes (short-read packing) --------


def mea_weights_multi(post: torch.Tensor, mdev: MultiDeviceBatch, e1r, e1c,
                      ibase, jbase, gap_gamma: float, width: int, rgm: int,
                      rgn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wup, wleft) [D1, Wp, B] over multi-problem lanes: per-lane virtual
    read / ref position spaces (each problem owns a disjoint window), the
    banded segment sums of the posterior gathered back per cell
    (marginalign_trna_tpu/ops/mea.py `_mea_weights_multi_jit`), plain
    torch on post's device.  e1r / e1c are the read / ref boundaries
    (expectations.py `_multi_boundaries`), ibase / jbase [D1, B] each
    cell's virtual read / ref position at band row 0, less one."""
    D1, Wp, B = post.shape
    i, j, ok = _multi_ok(mdev)
    w = torch.where(ok, post, 0.0)
    accr = banded_segment_sums(w, e1r, width, width, rgm, -1)
    accc = banded_segment_sums(w, e1c, 0, width, rgn, 1)
    g_read = gap_gamma * torch.clamp(1.0 - accr, 0.0, 1.0)
    g_ref = gap_gamma * torch.clamp(1.0 - accc, 0.0, 1.0)
    k = torch.arange(Wp, dtype=torch.int64, device=post.device)[:, None]
    iu = (ibase.long()[:, None, :] + k).clamp(0, rgm - 1)
    ju = (jbase.long()[:, None, :] - k).clamp(0, rgn - 1)
    wup = torch.where(mdev.valid & (i >= 1),
                      g_read.gather(0, iu.reshape(D1 * Wp, B))
                      .reshape(D1, Wp, B), 0.0)
    wleft = torch.where(mdev.valid & (j >= 1),
                        g_ref.gather(0, ju.reshape(D1 * Wp, B))
                        .reshape(D1, Wp, B), 0.0)
    return wup, wleft


def banded_mea_multi(wdiag, wup, wleft, mdev: MultiDeviceBatch) -> MeaResult:
    """Pointers and per-problem scores [P] of the MEA decode over
    multi-problem lanes (marginalign_trna_tpu/ops/wavefront_pallas.py
    `banded_mea_pallas_multi`): the mea_multi kernel for CUDA tensors, its
    plain version for CPU tensors."""
    fn = mea_multi_cuda if use_kernel(wdiag) else mea_multi_plain
    ptr, term = fn(wdiag, wup, wleft, mdev.valid, mdev.s1, mdev.s2,
                   mdev.start, mdev.fink, mdev.find)
    return MeaResult(ptr, term[mdev.p_final_d.long(), mdev.p_lane.long()])


def _traceback_problem(pointers: np.ndarray, mb: MultiBandedBatch,
                       p: int) -> List[Tuple[int, int]]:
    """MEA traceback of problem p: its step range and lane slice out to an
    ordinary single-problem view."""
    pr = mb.problems[p]
    ptr = np.ascontiguousarray(
        pointers[pr.d0 : pr.final_d + 1, :, pr.lane : pr.lane + 1]
    )
    lo = np.ascontiguousarray(mb.lo[pr.d0 : pr.final_d + 1, pr.lane])
    return _traceback_arrays(ptr, lo, 0, pr.m, pr.n)


def mea_decode_multi(
    post: torch.Tensor,
    mb: MultiBandedBatch,
    mdev: MultiDeviceBatch,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
) -> List[List[Tuple[int, int]]]:
    """Realigned ops of every problem of a multi-problem batch
    (marginalign_trna_tpu/ops/mea.py `mea_decode_multi`); post is the
    posterior band on mdev's device, which the weights and the DP stay on;
    only the pointers come to the host."""
    voffr, vmaxr = _lane_virtual_offsets(mb, lambda p: mb.problems[p].m)
    voffc, vmaxc = _lane_virtual_offsets(mb, lambda p: mb.problems[p].n)
    rgm = _round_up(max(int(vmaxr), 1), 256)
    rgn = _round_up(max(int(vmaxc), 1), 256)
    e1r = _multi_boundaries(_multi_gu(mb, voffr, "read"), -mb.width, rgm)
    e1c = _multi_boundaries(_multi_gu(mb, voffc, "ref"), 0, rgn + mb.width)

    D1, B = mb.lo.shape
    ibase = np.zeros((D1, B), dtype=np.int32)
    jbase = np.zeros((D1, B), dtype=np.int32)
    for p, pr in enumerate(mb.problems):
        sl = slice(pr.d0, pr.final_d + 1)
        lo = mb.lo[sl, pr.lane].astype(np.int64)
        ibase[sl, pr.lane] = voffr[p] + lo - 1
        jbase[sl, pr.lane] = (
            voffc[p] + mb.dloc[sl, pr.lane].astype(np.int64) - lo - 1
        )

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(post.device)

    wup, wleft = mea_weights_multi(post, mdev, up(e1r), up(e1c), up(ibase),
                                   up(jbase), gap_gamma, mb.width, rgm, rgn)
    wdiag = torch.where((post >= match_gamma) & (post > 0), post, NEG)
    res = banded_mea_multi(wdiag, wup, wleft, mdev)
    pointers = np.ascontiguousarray(res.pointers.cpu().numpy())
    return [_traceback_problem(pointers, mb, p)
            for p in range(len(mb.problems))]
