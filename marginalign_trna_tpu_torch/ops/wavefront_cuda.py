"""Max-plus banded wavefronts (guide Viterbi and MEA decode): the CUDA
kernels (csrc/nw.cu, csrc/mea.cu) and their plain PyTorch versions.

Port of marginalign_trna_tpu/ops/wavefront_pallas.py `banded_nw_pallas`
(K1), `banded_mea_pallas` (K4, weights given as bands), `_mea_dl_jit`
(D, weights derived from the posterior band and the per-position row and
column posterior sums), and over lanes that hold several problems
(ops/band.py `pack_multi_banded_batch`) `banded_nw_pallas_multi`
(nw_multi) and `banded_mea_pallas_multi` (mea_multi): their frontiers start
at NEG, each problem's first diagonal seeds row 0, and the score at each
problem's terminal cell leaves on its terminal diagonal (term, NEG
elsewhere).  On the card nw_multi and mea_multi are the multi instances of
K1's and K4's kernels (a lane on a warp, or on a half or a quarter of one
at narrow bands).  Max-plus scores need no rescaling, so both versions
only shift, add and compare; with the same order of operations (circular
row shifts, first-max-wins ties) they agree bit for bit.

Pointer encodings (read by the native host tracebacks):
  NW:  uint8  ptrM (2 bits) | ptrIx << 2 | ptrIy << 3
  MEA: uint8  0 = diag, 1 = left (ref skip), 2 = up (read skip)
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from ._build import check_tensor
from .band import band_masks
from .fb import shift

NEG = -1e30


def _max_argmax3(v0, v1, v2) -> Tuple[torch.Tensor, torch.Tensor]:
    m01 = torch.maximum(v0, v1)
    p01 = (v1 > v0).to(torch.uint8)
    p = torch.where(v2 > m01, torch.full_like(p01, 2), p01)
    return torch.maximum(m01, v2), p


def _terminal(vals, final_d, final_k, d, term):
    """Keep each lane's (max(value, NEG)) at band row final_k on its
    terminal diagonal final_d."""
    lanes = torch.arange(final_k.shape[0], device=final_k.device)
    at = torch.stack([v[final_k.long(), lanes] for v in vals])
    at = torch.clamp(at, min=NEG)
    return torch.where((final_d == d)[None, :], at, term)


# ------------------------------------------------------------------------ NW


def banded_nw_plain(params, xb, yb, valid, s1, s2, final_d, final_k):
    """Plain version of the banded_nw kernel: (pointers uint8 [D1, Wp, B],
    score [B], final_state int32 [B]).  params = (match, mismatch,
    gap_open, gap_extend)."""
    match, mismatch, gap_open, gap_extend = (float(p) for p in params)
    D1, Wp, B = xb.shape
    dev = xb.device
    neg = torch.full((Wp, B), NEG, dtype=torch.float32, device=dev)
    m1 = neg.clone()
    m1[0] = 0.0
    x1, y1 = neg, neg
    best1, arg1 = _max_argmax3(m1, x1, y1)              # generation d - 1
    best2, arg2 = neg, torch.zeros_like(arg1)           # generation d - 2
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    ptr[0] = 0
    term = _terminal((m1, x1, y1), final_d, final_k, 0,
                     torch.full((3, B), NEG, device=dev))
    for d in range(1, D1):
        x, y, v = xb[d], yb[d], valid[d]
        t1, t2 = s1[d], s2[d]
        sub = torch.where(
            (x == y) & (x < 4), match,
            torch.where((x >= 4) | (y >= 4), 0.0, mismatch),
        ).to(torch.float32)
        mv = shift(best2, t2 - 1) + sub
        mp = shift(arg2, t2 - 1)
        io = shift(m1, t1) + gap_open
        ie = shift(x1, t1) + gap_extend
        vo = shift(m1, t1 - 1) + gap_open
        ve = shift(y1, t1 - 1) + gap_extend
        nm = torch.where(v, mv, NEG)
        nx = torch.where(v, torch.maximum(io, ie), NEG)
        ny = torch.where(v, torch.maximum(vo, ve), NEG)
        ptr[d] = (mp | ((ie > io).to(torch.uint8) << 2)
                  | ((ve > vo).to(torch.uint8) << 3))
        term = _terminal((nm, nx, ny), final_d, final_k, d, term)
        best2, arg2 = best1, arg1
        best1, arg1 = _max_argmax3(nm, nx, ny)
        m1, x1, y1 = nm, nx, ny
    best, st = _max_argmax3(term[0], term[1], term[2])
    return ptr, best, st.to(torch.int32)


def banded_nw_cuda(params, xb, yb, valid, s1, s2, final_d, final_k):
    """The banded_nw kernel (csrc/nw.cu); same outputs as the plain
    version."""
    D1, Wp, B = xb.shape
    dev = xb.device
    for t, dt in ((xb, torch.int8), (yb, torch.int8), (valid, torch.bool)):
        check_tensor(t, dt, (D1, Wp, B), dev)
    check_tensor(s1, torch.int32, (D1, B), dev)
    check_tensor(s2, torch.int32, (D1, B), dev)
    check_tensor(final_d, torch.int32, (B,), dev)
    check_tensor(final_k, torch.int32, (B,), dev)
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    state = torch.empty((B,), dtype=torch.int32, device=dev)
    match, mismatch, gap_open, gap_extend = (float(p) for p in params)
    _build.launch(
        "banded_nw", dev, xb.data_ptr(), yb.data_ptr(), valid.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), final_d.data_ptr(), final_k.data_ptr(),
        D1, Wp, B, match, mismatch, gap_open, gap_extend,
        ptr.data_ptr(), score.data_ptr(), state.data_ptr(),
    )
    return ptr, score, state


def warp_lane_resources(name: str, device: torch.device, wp: int,
                        B: int) -> Dict[str, int]:
    """What a launch of the warp-per-lane kernel `name` (banded_nw,
    nw_multi, banded_mea, mea_multi or mea_dl) over B lanes at band width
    `wp` gets on `device`: registers per thread, shared memory per block,
    blocks per SM, threads per block, local memory per thread (spills), the
    lanes a block, which csrc/common.cuh `warp_lanes` (K4 and mea_multi:
    csrc/mea.cu `mea_lanes`) chooses from B, the SM count and the shared
    memory a block may take, and the threads a lane (32, or 16 and 8
    where nw_multi and mea_multi put two or four lanes in a warp)."""
    out = (ctypes.c_int * 6)()
    _build.query(name + "_info", device, wp, B, ctypes.addressof(out))
    res = dict(zip(("registers", "smem_per_block", "blocks_per_sm",
                    "threads_per_block", "local_bytes", "lanes_per_block"),
                   out))
    return {**res, "threads_per_lane":
            res["threads_per_block"] // res["lanes_per_block"]}


def _multi_terminal(vals, fink, find):
    """[len(vals), B]: each value at row fink where find marks a terminal
    diagonal, as max(value, NEG); NEG elsewhere."""
    Wp = vals[0].shape[0]
    fk = fink.long()
    at = torch.stack([v.gather(0, fk.clamp(0, Wp - 1)[None, :])[0]
                      for v in vals])
    hit = (find >= 0) & (fk >= 0) & (fk < Wp)
    return torch.where(hit[None, :], torch.clamp(at, min=NEG), NEG)


def nw_multi_plain(params, xb, yb, valid, s1, s2, start, fink, find):
    """Plain version of the nw_multi kernel: (pointers uint8 [D1, Wp, B],
    term [3, D1, B], the M / X / Y scores at each terminal cell on its
    terminal diagonal, NEG elsewhere).  params = (match, mismatch,
    gap_open, gap_extend)."""
    match, mismatch, gap_open, gap_extend = (float(p) for p in params)
    D1, Wp, B = xb.shape
    dev = xb.device
    neg = torch.full((Wp, B), NEG, dtype=torch.float32, device=dev)
    m1 = x1 = y1 = neg                                  # generation d - 1
    best1, arg1 = neg, torch.zeros((Wp, B), dtype=torch.uint8, device=dev)
    best2, arg2 = best1, arg1                           # generation d - 2
    row0 = torch.arange(Wp, device=dev)[:, None] == 0
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    term = torch.empty((3, D1, B), dtype=torch.float32, device=dev)
    for d in range(D1):
        x, y, v = xb[d], yb[d], valid[d]
        t1, t2 = s1[d], s2[d]
        sub = torch.where(
            (x == y) & (x < 4), match,
            torch.where((x >= 4) | (y >= 4), 0.0, mismatch),
        ).to(torch.float32)
        mv = shift(best2, t2 - 1) + sub
        mp = shift(arg2, t2 - 1)
        io = shift(m1, t1) + gap_open
        ie = shift(x1, t1) + gap_extend
        vo = shift(m1, t1 - 1) + gap_open
        ve = shift(y1, t1 - 1) + gap_extend
        seed = row0 & (start[d] != 0)[None, :]
        nm = torch.where(seed, 0.0, torch.where(v, mv, NEG))
        nx = torch.where(seed, NEG, torch.where(v, torch.maximum(io, ie),
                                                NEG))
        ny = torch.where(seed, NEG, torch.where(v, torch.maximum(vo, ve),
                                                NEG))
        p = (mp | ((ie > io).to(torch.uint8) << 2)
             | ((ve > vo).to(torch.uint8) << 3))
        ptr[d] = torch.where(seed, 0, p).to(torch.uint8)
        term[:, d] = _multi_terminal((nm, nx, ny), fink[d], find[d])
        best2, arg2 = best1, arg1
        best1, arg1 = _max_argmax3(nm, nx, ny)
        m1, x1, y1 = nm, nx, ny
    return ptr, term


def nw_multi_cuda(params, xb, yb, valid, s1, s2, start, fink, find):
    """The nw_multi kernel (csrc/nw.cu); same outputs as the plain
    version."""
    D1, Wp, B = xb.shape
    dev = xb.device
    for t, dt in ((xb, torch.int8), (yb, torch.int8), (valid, torch.bool)):
        check_tensor(t, dt, (D1, Wp, B), dev)
    for t in (s1, s2, fink, find):
        check_tensor(t, torch.int32, (D1, B), dev)
    check_tensor(start, torch.int8, (D1, B), dev)
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    term = torch.empty((3, D1, B), dtype=torch.float32, device=dev)
    match, mismatch, gap_open, gap_extend = (float(p) for p in params)
    _build.launch(
        "nw_multi", dev, xb.data_ptr(), yb.data_ptr(), valid.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), start.data_ptr(), fink.data_ptr(),
        find.data_ptr(), D1, Wp, B, match, mismatch, gap_open, gap_extend,
        ptr.data_ptr(), term.data_ptr(),
    )
    return ptr, term


# ----------------------------------------------------------------------- MEA


def banded_mea_plain(wdiag, wup, wleft, valid, s1, s2, final_d, final_k):
    """Plain version of the banded_mea kernel: (pointers uint8 [D1, Wp, B],
    score [B])."""
    D1, Wp, B = wdiag.shape
    dev = wdiag.device
    a2 = torch.full((Wp, B), NEG, dtype=torch.float32, device=dev)
    a1 = a2.clone()
    a1[0] = 0.0
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    ptr[0] = 0
    term = _terminal((a1,), final_d, final_k, 0,
                     torch.full((1, B), NEG, device=dev))
    for d in range(1, D1):
        t1, t2 = s1[d], s2[d]
        diag = shift(a2, t2 - 1) + wdiag[d]
        left = shift(a1, t1) + wleft[d]
        up = shift(a1, t1 - 1) + wup[d]
        a, p = _max_argmax3(diag, left, up)
        a = torch.where(valid[d], a, NEG)
        ptr[d] = p
        term = _terminal((a,), final_d, final_k, d, term)
        a2, a1 = a1, a
    return ptr, term[0]


def banded_mea_cuda(wdiag, wup, wleft, valid, s1, s2, final_d, final_k):
    """The banded_mea kernel (csrc/mea.cu); same outputs as the plain
    version."""
    D1, Wp, B = wdiag.shape
    dev = wdiag.device
    for t in (wdiag, wup, wleft):
        check_tensor(t, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    check_tensor(s1, torch.int32, (D1, B), dev)
    check_tensor(s2, torch.int32, (D1, B), dev)
    check_tensor(final_d, torch.int32, (B,), dev)
    check_tensor(final_k, torch.int32, (B,), dev)
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "banded_mea", dev, wdiag.data_ptr(), wup.data_ptr(),
        wleft.data_ptr(), valid.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        final_d.data_ptr(), final_k.data_ptr(), D1, Wp, B, ptr.data_ptr(),
        score.data_ptr(),
    )
    return ptr, score


def mea_multi_plain(wdiag, wup, wleft, valid, s1, s2, start, fink, find):
    """Plain version of the mea_multi kernel: (pointers uint8 [D1, Wp, B],
    term [D1, B], the score at each terminal cell on its terminal diagonal,
    NEG elsewhere)."""
    D1, Wp, B = wdiag.shape
    dev = wdiag.device
    a1 = a2 = torch.full((Wp, B), NEG, dtype=torch.float32, device=dev)
    row0 = torch.arange(Wp, device=dev)[:, None] == 0
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    term = torch.empty((D1, B), dtype=torch.float32, device=dev)
    for d in range(D1):
        t1, t2 = s1[d], s2[d]
        diag = shift(a2, t2 - 1) + wdiag[d]
        left = shift(a1, t1) + wleft[d]
        up = shift(a1, t1 - 1) + wup[d]
        a, p = _max_argmax3(diag, left, up)
        seed = row0 & (start[d] != 0)[None, :]
        a = torch.where(seed, 0.0, torch.where(valid[d], a, NEG))
        ptr[d] = torch.where(seed, 0, p).to(torch.uint8)
        term[d] = _multi_terminal((a,), fink[d], find[d])[0]
        a2, a1 = a1, a
    return ptr, term


def mea_multi_cuda(wdiag, wup, wleft, valid, s1, s2, start, fink, find):
    """The mea_multi kernel (csrc/mea.cu); same outputs as the plain
    version."""
    D1, Wp, B = wdiag.shape
    dev = wdiag.device
    for t in (wdiag, wup, wleft):
        check_tensor(t, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    for t in (s1, s2, fink, find):
        check_tensor(t, torch.int32, (D1, B), dev)
    check_tensor(start, torch.int8, (D1, B), dev)
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    term = torch.empty((D1, B), dtype=torch.float32, device=dev)
    _build.launch(
        "mea_multi", dev, wdiag.data_ptr(), wup.data_ptr(), wleft.data_ptr(),
        valid.data_ptr(), s1.data_ptr(), s2.data_ptr(), start.data_ptr(),
        fink.data_ptr(), find.data_ptr(), D1, Wp, B, ptr.data_ptr(),
        term.data_ptr(),
    )
    return ptr, term


def _gap_weights(sums: torch.Tensor, gap_gamma: float) -> torch.Tensor:
    """gapGamma * clip(1 - posterior mass of a position, 0, 1)."""
    return gap_gamma * torch.clamp(1.0 - sums, 0.0, 1.0)


def mea_dl_plain(post, lo, m, n, width: int, final_d, final_k, accr, accc,
                 gap_gamma: float, match_gamma: float):
    """Plain version of the mea_dl kernel: (pointers uint8 [D1, Wp, B],
    score [B]) of the MEA decode with weights derived from the posterior
    band post [D1, Wp, B] (band-relative) and the per-position sums
    accr [rgm, B] (read) / accc [rgn, B] (ref): wdiag = post where
    post >= match_gamma and post > 0, else NEG; wup = gap weight of read
    position i - 1 (0 at i = 0); wleft = gap weight of ref position j - 1
    (0 at j <= 0).  valid, s1 and s2 come from lo, m, n (ops/band.py
    `band_masks`); the DP is banded_mea_plain's."""
    Wp = post.shape[1]
    valid, s1, s2 = band_masks(lo, m, n, width, Wp)
    wdiag = torch.where((post >= match_gamma) & (post > 0), post, NEG)
    return banded_mea_plain(wdiag, *mea_dl_gap_bands(lo, accr, accc,
                                                     gap_gamma, Wp),
                            valid, s1, s2, final_d, final_k)


def mea_dl_gap_bands(lo, accr, accc, gap_gamma: float, Wp: int):
    """(wup, wleft) [D1, Wp, B]: the gap weights of every band cell, the
    closed form that the mea_dl kernel's delay line holds: wup = gap weight
    of read position i - 1 (0 at i < 1), wleft = that of ref position j - 1
    (0 at j < 1), positions clipped to the sums' last rows (i = lo(d) + k,
    j = d - i)."""
    D1, B = lo.shape
    i = lo.long()[:, None, :] + torch.arange(Wp, device=lo.device)[:, None]
    j = torch.arange(D1, device=lo.device)[:, None, None] - i

    def gap_band(sums, pos):
        g = _gap_weights(sums, gap_gamma)
        at = g.gather(0, (pos - 1).clamp(0, g.shape[0] - 1).reshape(-1, B))
        return torch.where(pos >= 1, at.reshape(D1, Wp, B), 0.0)

    return gap_band(accr, i), gap_band(accc, j)


def mea_dl_cuda(post, lo, m, n, width: int, final_d, final_k, accr, accc,
                gap_gamma: float, match_gamma: float):
    """The mea_dl kernel (csrc/mea.cu); same outputs as the plain
    version."""
    D1, Wp, B = post.shape
    dev = post.device
    rgm, rgn = accr.shape[0], accc.shape[0]
    check_tensor(post, torch.float32, (D1, Wp, B), dev)
    check_tensor(lo, torch.int32, (D1, B), dev)
    for t in (m, n, final_d, final_k):
        check_tensor(t, torch.int32, (B,), dev)
    check_tensor(accr, torch.float32, (rgm, B), dev)
    check_tensor(accc, torch.float32, (rgn, B), dev)
    ptr = torch.empty((D1, Wp, B), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "mea_dl", dev, post.data_ptr(), lo.data_ptr(), m.data_ptr(),
        n.data_ptr(), accr.data_ptr(), accc.data_ptr(), final_d.data_ptr(),
        final_k.data_ptr(), D1, Wp, B, width, rgm, rgn, float(gap_gamma),
        float(match_gamma), ptr.data_ptr(), score.data_ptr(),
    )
    return ptr, score
