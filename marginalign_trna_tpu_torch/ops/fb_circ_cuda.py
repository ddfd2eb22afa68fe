"""The pair-HMM passes over compact batches in the circular band layout:
the CUDA kernels E, R, S, C and M (csrc/expand.cu, csrc/fb_circ.cu) and
their plain PyTorch versions.

Circular layout: row r of a [d1k, Wp, B] band holds the cell whose read
prefix index is i = r (mod Wp), so the band's motion between diagonals is
an unconditional roll by one row (no per-lane shift streams).

  E  expand_streams  <- marginalign_trna_tpu/ops/fb_pallas.py
                        `_expand_streams` (and the `monotone_gather` feeding
                        its delay line, ops/bucket_scatter.py): the signed
                        match-emission stream es (Ematch[ref, read] on valid
                        cells, -1 elsewhere), the read-code stream yb (when
                        asked for) and the per-diagonal flush row fr, from
                        packed sequences and band offsets.
  R  expand_rel      <- fb_pallas `expand_rel_codes`
                        (`_make_expand_rel_kernel`): the guide's int8 code
                        bands xb, yb in the BAND-RELATIVE layout (row k holds
                        i = lo(d) + k), from the same packed sequences.
  S  sv_backward     <- fb_pallas `_sv_backward_call`
                        (`_make_bwd_kernel_circ_sv`): the scaled backward
                        from es; bm [d1k, Wp, B], the cumulative log-scales
                        bls [d1k, B] and logZ [B].
  C  cx_forward      <- fb_pallas `_cx_from_es` (`_make_fwd_kernel_circ_cx`):
                        the scaled forward; the posterior of each cell adds
                        into one of four rolling per-reference-position
                        accumulators (by read code), a position's totals
                        leave when it completes (fl [4, d1k, B]) and what is
                        left after the last diagonal leaves as tails
                        [4, Wp, B].  No posterior band is written.
  M  mw_forward      <- fb_pallas `_mw_from_es` (`_make_fwd_kernel_circ_mw`):
                        the same forward for realignment; it writes the
                        posterior band in the band-relative layout
                        (rel[k] = circ[(k + lo) mod Wp]) and the per-position
                        posterior column sums (rolling, flushed at fr) and
                        row sums (row-stable, flushed at frr) the MEA gap
                        weights need: flc, flr [d1k, B], tails tc, tr [Wp, B].
C and M share the forward recursion (`_forward_generations` here, the
`circ_forward` template in csrc/fb_circ.cu).

The model comes in at run time as one coefficient vector (`COEF_*` offsets,
built by ops/fb_circ.py `circ_coefficients`) with two branches: the
gap-chain form every shipped model takes, and the generic 5x5 mix.  Scaling
is the TPU kernels': rescale by the band max at d % 8 == 0 going backward
and d % 8 == 7 going forward, factor 1 for a step with no mass, and the d-2
term divided by the previous factor on the step after a rescale.  The plain
versions follow the kernels' arithmetic step for step (the kernels build
with -fmad=false).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from ._build import check_tensor

_RESCALE_PERIOD = 8
_TINY = 1e-30

# Offsets into the coefficient vector (csrc/fb_circ.cu `CircCoef`).
COEF_A = 0       # [25] generic branch: A[s][u] = T[s][u] * g_u
COEF_T00 = 25    # gap-chain branch: T[0][0]
COEF_M0 = 26     # [4] backward match-row coefficients of the gap states
COEF_CB = 30     # [4] backward gap self coefficients
COEF_R = 34      # [4] backward terminal injection of the gap states
COEF_TZ = 38     # [4] T[s][0]: gap states' share of the start mass (logZ)
COEF_PI = 42     # [4] forward start values of the scaled gap states
COEF_MC = 46     # [4] forward match-mix coefficients of the gap states
COEF_C = 50      # [4] forward gap self coefficients
N_COEF = 54


def _roll_up(a: torch.Tensor) -> torch.Tensor:
    """out[k] = a[k + 1] over the row dimension (circular)."""
    return torch.roll(a, -1, dims=0)


def _roll_down(a: torch.Tensor) -> torch.Tensor:
    """out[k] = a[k - 1] over the row dimension (circular)."""
    return torch.roll(a, 1, dims=0)


def _coef(coef: np.ndarray) -> np.ndarray:
    """The coefficient vector as the kernels take it (float32 [N_COEF])."""
    c = np.ascontiguousarray(coef, np.float32)
    if c.shape != (N_COEF,):
        raise ValueError("expected %d coefficients, got %s"
                         % (N_COEF, c.shape))
    return c


def _floats(coef: np.ndarray) -> list:
    return [float(v) for v in np.asarray(coef, np.float32)]


# --------------------------------------------------------- E: expand streams


def expand_streams_plain(ematch: Sequence[float], reads, refs, lo, m, n,
                         width: int, Wp: int, d1k: int, want_yb: bool = True):
    """Plain version of the expand_streams kernel.

    ematch: the 25 match emissions Ematch[ref][read] (row-major); reads
    [Mp, B] / refs [Np, B] int8 packed codes; lo [D1, B] int32 band offsets
    (edge-replicated past D1); m, n [B] int32.  Returns (es [d1k, Wp, B]
    f32, yb [d1k, Wp, B] int8 or None without want_yb, fr [d1k, B]
    int32)."""
    D1, B = lo.shape
    dev = lo.device
    d = torch.arange(d1k, device=dev)
    lo_g = lo.long()[d.clamp(max=D1 - 1)]                  # [d1k, B]
    krel = (torch.arange(Wp, device=dev)[None, :, None]
            - lo_g[:, None, :] % Wp) % Wp                  # [d1k, Wp, B]
    i = lo_g[:, None, :] + krel
    j = d[:, None, None] - i
    m3 = m.long()[None, None, :]
    n3 = n.long()[None, None, :]
    valid = ((krel < width) & (i <= m3) & (i <= d[:, None, None])
             & (j >= 0) & (j <= n3) & (m3 + n3 > 0))
    # The gathers of marginalign_trna_tpu's monotone_gather, as direct
    # loads: the read code of row i is reads[i - 1], the ref code refs[j - 1],
    # clipped into the sequence as the host packer clips.
    yi = torch.minimum((i - 1).clamp(min=0), (m3 - 1).clamp(min=0))
    xj = torch.minimum((j - 1).clamp(min=0), (n3 - 1).clamp(min=0))
    y = reads.long().gather(0, yi.reshape(d1k * Wp, B)).reshape(d1k, Wp, B)
    x = refs.long().gather(0, xj.reshape(d1k * Wp, B)).reshape(d1k, Wp, B)
    table = torch.tensor(list(ematch), dtype=torch.float32, device=dev)
    es = torch.where(valid, table[x * 5 + y], torch.full_like(table[:1], -1.0))
    s1 = torch.cat([torch.zeros_like(lo_g[:1]), lo_g[1:] - lo_g[:-1]])
    fr = torch.where((s1 == 0) & (d[:, None] > 0), (lo_g + width) % Wp,
                     torch.full_like(lo_g, -1))
    return es, y.to(torch.int8) if want_yb else None, fr.to(torch.int32)


def _check_compact(reads, refs, lo, m, n):
    """Argument check of the kernels that read a compact batch; returns
    (Mp, Np, D1, B, device)."""
    Mp, B = reads.shape
    Np = refs.shape[0]
    D1 = lo.shape[0]
    dev = lo.device
    check_tensor(reads, torch.int8, (Mp, B), dev)
    check_tensor(refs, torch.int8, (Np, B), dev)
    check_tensor(lo, torch.int32, (D1, B), dev)
    check_tensor(m, torch.int32, (B,), dev)
    check_tensor(n, torch.int32, (B,), dev)
    return Mp, Np, D1, B, dev


def expand_streams_cuda(ematch: Sequence[float], reads, refs, lo, m, n,
                        width: int, Wp: int, d1k: int, want_yb: bool = True):
    """The expand_streams kernel (csrc/expand.cu); same outputs as the plain
    version."""
    Mp, Np, D1, B, dev = _check_compact(reads, refs, lo, m, n)
    es = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    yb = (torch.empty((d1k, Wp, B), dtype=torch.int8, device=dev)
          if want_yb else None)
    fr = torch.empty((d1k, B), dtype=torch.int32, device=dev)
    table = np.ascontiguousarray(ematch, np.float32)
    if table.shape != (25,):
        raise ValueError("expected 25 match emissions, got %s"
                         % (table.shape,))
    _build.launch(
        "expand_streams", dev, reads.data_ptr(), refs.data_ptr(),
        lo.data_ptr(), m.data_ptr(), n.data_ptr(), table.ctypes.data,
        Mp, Np, D1, d1k, Wp, B, width,
        es.data_ptr(), yb.data_ptr() if want_yb else None, fr.data_ptr(),
    )
    return es, yb, fr


# ------------------------------------------------- R: band-relative codes


def expand_rel_plain(reads, refs, lo, m, n, Wp: int, d1k: int):
    """Plain version of the expand_rel kernel: (xb, yb) [d1k, Wp, B] int8,
    the ref and read codes of every band-relative cell (row k holds read
    prefix i = lo(d) + k and ref prefix j = d - i): refs[j - 1] and
    reads[i - 1], indices clipped into the sequence as the host band packer
    clips, so every in-band cell equals pack_banded_batch's xb / yb.  lo is
    edge-replicated past its D1 rows."""
    D1, B = lo.shape
    dev = lo.device
    d = torch.arange(d1k, device=dev)
    lo_g = lo.long()[d.clamp(max=D1 - 1)]
    i = lo_g[:, None, :] + torch.arange(Wp, device=dev)[None, :, None]
    j = d[:, None, None] - i
    m3 = m.long()[None, None, :]
    n3 = n.long()[None, None, :]
    yi = torch.minimum((i - 1).clamp(min=0), (m3 - 1).clamp(min=0))
    xj = torch.minimum((j - 1).clamp(min=0), (n3 - 1).clamp(min=0))
    yb = reads.gather(0, yi.reshape(d1k * Wp, B)).reshape(d1k, Wp, B)
    xb = refs.gather(0, xj.reshape(d1k * Wp, B)).reshape(d1k, Wp, B)
    return xb, yb


def expand_rel_cuda(reads, refs, lo, m, n, Wp: int, d1k: int):
    """The expand_rel kernel (csrc/expand.cu); same outputs as the plain
    version."""
    Mp, Np, D1, B, dev = _check_compact(reads, refs, lo, m, n)
    xb = torch.empty((d1k, Wp, B), dtype=torch.int8, device=dev)
    yb = torch.empty((d1k, Wp, B), dtype=torch.int8, device=dev)
    _build.launch(
        "expand_rel", dev, reads.data_ptr(), refs.data_ptr(), lo.data_ptr(),
        m.data_ptr(), n.data_ptr(), Mp, Np, D1, d1k, Wp, B,
        xb.data_ptr(), yb.data_ptr(),
    )
    return xb, yb


# ------------------------------------------------------------ S: backward


def sv_backward_plain(coef: np.ndarray, chain: bool, es, fink, find):
    """Plain version of the sv_backward kernel: (bm [d1k, Wp, B],
    bls [d1k, B], logZ [B]) from es [d1k, Wp, B], the terminal row fink and
    diagonal find [B]."""
    d1k, Wp, B = es.shape
    dev = es.device
    c = _floats(coef)
    A = [[c[COEF_A + 5 * s + u] for u in range(5)] for s in range(5)]
    kidx = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    b1 = [zero] * 5          # states at d+1
    b2 = [zero] * 5          # states at d+2
    e1 = e2 = zero           # match emissions at d+1, d+2
    bls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)
    bm = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    bls_out = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    fink = fink.long()[None, :]
    for d in range(d1k - 1, -1, -1):
        esd = es[d]
        valid = (esd >= 0).float()
        q0 = _roll_up(e2 * b2[0])
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            q0 = q0 / cprev
        q = [q0, b1[1], _roll_up(b1[2]), b1[3], _roll_up(b1[4])]
        e2, e1 = e1, esd.clamp(min=0.0)
        mask = (kidx == fink) & (find == d)[None, :]
        if chain:
            acc0 = c[COEF_T00] * q[0]
            for s in range(1, 5):
                acc0 = acc0 + c[COEF_M0 + s - 1] * q[s]
            new = [torch.where(mask, 1.0, acc0) * valid]
            for s in range(1, 5):
                accs = q[0] + c[COEF_CB + s - 1] * q[s]
                new.append(torch.where(mask, c[COEF_R + s - 1], accs) * valid)
        else:
            inj = mask.float()
            new = []
            for s in range(5):
                acc = q[0] * A[s][0]
                for u in range(1, 5):
                    acc = acc + q[u] * A[s][u]
                new.append((acc + inj) * valid)
        if d % _RESCALE_PERIOD == 0:
            bmax = torch.stack(new).amax(dim=(0, 1))
            cf = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
            inv = 1.0 / cf
            bls = bls + torch.log(cf)
            cprev = cf
            new = [x * inv for x in new]
        bm[d] = new[0]
        bls_out[d] = bls
        b2, b1 = b1, new
    if chain:
        zr = b1[0][0]
        for s in range(1, 5):
            zr = zr + c[COEF_TZ + s - 1] * b1[s][0]
    else:
        zr = (((b1[0][0] + b1[1][0]) + b1[2][0]) + b1[3][0]) + b1[4][0]
    logZ = torch.log(torch.clamp(0.2 * zr, min=_TINY)) + bls
    return bm, bls_out, logZ


def sv_backward_cuda(coef: np.ndarray, chain: bool, es, fink, find):
    """The sv_backward kernel (csrc/fb_circ.cu); same outputs as the plain
    version."""
    d1k, Wp, B = es.shape
    dev = es.device
    check_tensor(es, torch.float32, (d1k, Wp, B), dev)
    check_tensor(fink, torch.int32, (B,), dev)
    check_tensor(find, torch.int32, (B,), dev)
    bm = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    bls = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    logZ = torch.empty((B,), dtype=torch.float32, device=dev)
    c = _coef(coef)
    _build.launch(
        "sv_backward", dev, es.data_ptr(), fink.data_ptr(), find.data_ptr(),
        c.ctypes.data, int(chain), d1k, Wp, B,
        bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(),
    )
    return bm, bls, logZ


# ------------------------------------------------------------- C: forward


def _forward_generations(coef: np.ndarray, chain: bool, es, bm, bls, logZ):
    """The scaled forward shared by C and M: yields (d, post [Wp, B]) for
    every diagonal, post = f_M * b_M * exp(ls + bls - logZ) in the circular
    layout.  At d = 0 the frontier is the start distribution (row 0 holds
    the origin cell; post there is NOT zeroed here)."""
    d1k, Wp, B = es.shape
    dev = es.device
    c = _floats(coef)
    A = [[c[COEF_A + 5 * s + u] for u in range(5)] for s in range(5)]
    row0 = torch.arange(Wp, device=dev)[:, None] == 0
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    pi = [0.2] + [c[COEF_PI + s] if chain else 0.2 for s in range(4)]
    f1 = [torch.where(row0, p, zero) for p in pi]   # the start distribution
    f2 = [zero] * 5
    ls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)

    def mix(vals, t):
        out = vals[0] * A[0][t]
        for s in range(1, 5):
            out = out + vals[s] * A[s][t]
        return out

    for d in range(d1k):
        if d == 0:
            cur = f1            # generation 0 is the start distribution
        else:
            esd = es[d]
            e = esd.clamp(min=0.0)
            valid = (esd >= 0).float()
            if chain:
                mix_m = c[COEF_T00] * f2[0]
                for s in range(1, 5):
                    mix_m = mix_m + c[COEF_MC + s - 1] * f2[s]
                mix_g = [f1[0] + c[COEF_C + t - 1] * f1[t]
                         for t in range(1, 5)]
            else:
                mix_m = mix(f2, 0)
                mix_g = [mix(f1, t) for t in range(1, 5)]
            if d % _RESCALE_PERIOD == 0:
                mix_m = mix_m / cprev
            cur = [e * _roll_down(mix_m), mix_g[0] * valid,
                   _roll_down(mix_g[1]) * valid, mix_g[2] * valid,
                   _roll_down(mix_g[3]) * valid]
            if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
                fmax = torch.stack(cur).amax(dim=(0, 1))
                cf = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
                inv = 1.0 / cf
                cur = [x * inv for x in cur]
                ls = ls + torch.log(cf)
                cprev = cf
            f2 = f1
        f1 = cur
        alpha = torch.exp(ls + bls[d] - logZ)
        yield d, cur[0] * bm[d] * alpha


def _emitted(d: int, post: torch.Tensor) -> torch.Tensor:
    """post without the origin cell, which holds the start distribution
    and emits nothing (circular row 0 of diagonal 0)."""
    if d > 0:
        return post
    return torch.where(torch.arange(post.shape[0], device=post.device)
                       [:, None] == 0, 0.0, post)


def cx_forward_plain(coef: np.ndarray, chain: bool, es, yb, fr, bm, bls,
                     logZ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the cx_forward kernel: (fl [4, d1k, B] totals of
    the reference position completing at each diagonal, tails [4, Wp, B]
    the accumulators after the last diagonal)."""
    d1k, Wp, B = es.shape
    dev = es.device
    kidx = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    acc = [zero] * 4
    fl = torch.empty((4, d1k, B), dtype=torch.float32, device=dev)
    for d, post in _forward_generations(coef, chain, es, bm, bls, logZ):
        post = _emitted(d, post)
        fmask = kidx == fr[d].long()[None, :]
        code = yb[d].long()
        for ch in range(4):
            rolled = _roll_down(acc[ch])
            fl[ch, d] = torch.where(fmask, rolled, zero).sum(dim=0)
            acc[ch] = (torch.where(fmask, zero, rolled)
                       + torch.where(code == ch, post, zero))
    return fl, torch.stack(acc)


def cx_forward_cuda(coef: np.ndarray, chain: bool, es, yb, fr, bm, bls,
                    logZ):
    """The cx_forward kernel (csrc/fb_circ.cu); same outputs as the plain
    version."""
    d1k, Wp, B = es.shape
    dev = es.device
    check_tensor(es, torch.float32, (d1k, Wp, B), dev)
    check_tensor(yb, torch.int8, (d1k, Wp, B), dev)
    check_tensor(fr, torch.int32, (d1k, B), dev)
    check_tensor(bm, torch.float32, (d1k, Wp, B), dev)
    check_tensor(bls, torch.float32, (d1k, B), dev)
    check_tensor(logZ, torch.float32, (B,), dev)
    fl = torch.empty((4, d1k, B), dtype=torch.float32, device=dev)
    tails = torch.empty((4, Wp, B), dtype=torch.float32, device=dev)
    c = _coef(coef)
    _build.launch(
        "cx_forward", dev, es.data_ptr(), yb.data_ptr(), fr.data_ptr(),
        bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(), c.ctypes.data,
        int(chain), d1k, Wp, B, fl.data_ptr(), tails.data_ptr(),
    )
    return fl, tails


# ------------------------------------------------------------- M: forward


def mw_forward_plain(coef: np.ndarray, chain: bool, es, fr, frr, lom, bm,
                     bls, logZ):
    """Plain version of the mw_forward kernel: (post [d1k, Wp, B] the
    posterior band in the band-relative layout, flc / flr [d1k, B] the
    column / row sums of the reference / read position that leaves at each
    diagonal, tc / tr [Wp, B] the column / row accumulators after the last
    diagonal).  fr, frr, lom: ops/band.py `circ_mw_streams`.  The origin
    cell counts in neither sum but stays in the band."""
    d1k, Wp, B = es.shape
    dev = es.device
    kidx = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    accc = accr = zero
    post_rel = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    flc = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    flr = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    for d, post in _forward_generations(coef, chain, es, bm, bls, logZ):
        post_rel[d] = post.gather(0, (kidx + lom[d].long()[None, :]) % Wp)
        pm = _emitted(d, post)
        fmask = kidx == fr[d].long()[None, :]
        rolled = _roll_down(accc)
        flc[d] = torch.where(fmask, rolled, zero).sum(dim=0)
        accc = torch.where(fmask, zero, rolled) + pm
        rmask = kidx == frr[d].long()[None, :]
        flr[d] = torch.where(rmask, accr, zero).sum(dim=0)
        accr = torch.where(rmask, zero, accr) + pm
    return post_rel, flc, flr, accc, accr


def mw_forward_cuda(coef: np.ndarray, chain: bool, es, fr, frr, lom, bm,
                    bls, logZ):
    """The mw_forward kernel (csrc/fb_circ.cu); same outputs as the plain
    version."""
    d1k, Wp, B = es.shape
    dev = es.device
    check_tensor(es, torch.float32, (d1k, Wp, B), dev)
    for t in (fr, frr, lom):
        check_tensor(t, torch.int32, (d1k, B), dev)
    check_tensor(bm, torch.float32, (d1k, Wp, B), dev)
    check_tensor(bls, torch.float32, (d1k, B), dev)
    check_tensor(logZ, torch.float32, (B,), dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    flc = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    flr = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    tc = torch.empty((Wp, B), dtype=torch.float32, device=dev)
    tr = torch.empty((Wp, B), dtype=torch.float32, device=dev)
    c = _coef(coef)
    _build.launch(
        "mw_forward", dev, es.data_ptr(), fr.data_ptr(), frr.data_ptr(),
        lom.data_ptr(), bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(),
        c.ctypes.data, int(chain), d1k, Wp, B, post.data_ptr(),
        flc.data_ptr(), flr.data_ptr(), tc.data_ptr(), tr.data_ptr(),
    )
    return post, flc, flr, tc, tr
