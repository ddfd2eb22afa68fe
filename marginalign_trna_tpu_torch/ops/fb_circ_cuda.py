"""The pair-HMM passes over compact batches in the circular band layout:
the CUDA kernels E, R, S, C and M (csrc/expand.cu, csrc/fb_circ.cu), the
serving kernels (csrc/fb_serve.cu) and the checkpoint pair
(csrc/fb_ckpt.cu), and their plain PyTorch versions.

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
C and M share the forward recursion (`_forward_generations` here); on the
card both run it as csrc/fb_circ.cu's `WarpForward` (one warp per lane,
8 or 16 lanes a block), each in a kernel of its own with its own sink.
S runs the backward of `_CircBackward` as a kernel of its own in the same
layout, and the serving modes' backwards run S's walk over their emission
sources (`serve_backward_kernel`), their posterior forwards M's recursion
with a sink that writes the circular band (`serve_post_kernel`); the
checkpoint backward is S's walk over the codes writing a checkpoint per
block of KB diagonals, its posterior pass per block S's recursion
replayed from the checkpoint, then M's over the replayed band, in a
replay warp and a forward warp per lane one block apart, or in one warp
where the lanes outnumber what the card holds (`ckpt_backward_kernel`,
`ckpt_post_kernel`).  R and E take a thread per lane (E) or per four
lanes (R) and a tile of diagonals.

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

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ._build import check_tensor

_RESCALE_PERIOD = 8
_TINY = 1e-30

# Offsets into the coefficient vector (csrc/common.cuh `FlatGapCoef`).
COEF_A = 0       # [25] generic branch: A[s][u] = T[s][u] * g_u
COEF_T00 = 25    # gap-chain branch: T[0][0]
COEF_M0 = 26     # [4] backward match-row coefficients of the gap states
COEF_CB = 30     # [4] backward gap self coefficients
COEF_R = 34      # [4] backward terminal injection of the gap states
COEF_TZ = 38     # [4] T[s][0]: gap states' share of the start mass (logZ)
COEF_PI = 42     # [4] forward start values of the scaled gap states
COEF_MC = 46     # [4] forward match-mix coefficients of the gap states
COEF_C = 50      # [4] forward gap self coefficients
COEF_K = 54      # [4] scale k[t] of the scaled gap states (multi lanes'
                 # terminal sums, ops/fb_multi_cuda.py)
N_COEF = 58


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


def expand_streams_resources(device: torch.device,
                             wp: int) -> Dict[str, int]:
    """What a launch of expand_streams at band width `wp` gets on `device`:
    registers per thread, shared memory per block (bytes), blocks resident
    per SM, threads per block and local memory per thread (bytes;
    spills)."""
    return _build.resources("expand_streams_info", device, wp)


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


def expand_rel_resources(device: torch.device, wp: int) -> Dict[str, int]:
    """What a launch of expand_rel at band width `wp` gets on `device`: the
    keys of expand_streams_resources."""
    return _build.resources("expand_rel_info", device, wp)


# ------------------------------------------------------ emission sources


def emission_table(table: Sequence[float], dev) -> torch.Tensor:
    """The 25 match emissions Ematch[ref][read] as a float32 tensor."""
    return torch.tensor(np.asarray(table, np.float32), device=dev)


def lookup_emissions(table: torch.Tensor, xb, yb) -> torch.Tensor:
    """Ematch[x][y] per cell from the [25] emission table (0 for a code
    outside 0..4), as the kernels look it up."""
    x = xb.long()
    y = yb.long()
    ok = (x >= 0) & (x < 5) & (y >= 0) & (y < 5)
    return torch.where(ok, table[(x * 5 + y).clamp(0, 24)],
                       torch.zeros_like(table[:1]))


def _es_source(es):
    """Per diagonal (e, valid) of the signed stream: valid = es >= 0,
    e = max(es, 0)."""
    return lambda d: (es[d].clamp(min=0.0), (es[d] >= 0).float())


def _emv_source(em, valid):
    """(e, valid) of a premasked emission stream and the int8 valid
    stream."""
    return lambda d: (em[d], (valid[d] != 0).float())


def _codes_source(table: Sequence[float], xb, yb, valid):
    """(e, valid) from the int8 code streams: e = Ematch[x][y] * valid."""
    tab = emission_table(table, xb.device)

    def load(d):
        v = (valid[d] != 0).float()
        return lookup_emissions(tab, xb[d], yb[d]) * v, v
    return load


# ------------------------------------------------------------ S: backward


class _CircBackward:
    """The scaled backward of the circular layout, one diagonal per
    `step(d)` (d descending), as the kernels' `CircBackward` runs it.
    State: p1 / p2 the e_M * b_M rows of d+1 / d+2, g the gap states 1..4
    of d+1, the cumulative log-scale bls and the last rescale factor."""

    def __init__(self, coef: np.ndarray, chain: bool, load, fink, find,
                 Wp: int, B: int, dev):
        self.c = _floats(coef)
        self.chain = chain
        self.load = load
        self.A = [[self.c[COEF_A + 5 * s + u] for u in range(5)]
                  for s in range(5)]
        self.kidx = torch.arange(Wp, device=dev)[:, None]
        self.fink = fink.long()[None, :]
        self.find = find
        zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
        self.p1 = self.p2 = zero
        self.g = [zero] * 4
        self.new = None
        self.bls = torch.zeros(B, dtype=torch.float32, device=dev)
        self.cprev = torch.ones(B, dtype=torch.float32, device=dev)

    def step(self, d: int) -> torch.Tensor:
        """Generation d; returns b_M of diagonal d."""
        c, A = self.c, self.A
        e, valid = self.load(d)
        q0 = _roll_up(self.p2)
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            q0 = q0 / self.cprev
        g = self.g
        q = [q0, g[0], _roll_up(g[1]), g[2], _roll_up(g[3])]
        mask = (self.kidx == self.fink) & (self.find == d)[None, :]
        if self.chain:
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
            self.bls = self.bls + torch.log(cf)
            self.cprev = cf
            new = [x * inv for x in new]
        self.new = new
        self.p2, self.p1 = self.p1, e * new[0]
        self.g = new[1:]
        return new[0]

    def logz(self) -> torch.Tensor:
        """logZ [B] from generation 0 (row 0 holds the origin cell)."""
        c, b1 = self.c, self.new
        if self.chain:
            zr = b1[0][0]
            for s in range(1, 5):
                zr = zr + c[COEF_TZ + s - 1] * b1[s][0]
        else:
            zr = (((b1[0][0] + b1[1][0]) + b1[2][0]) + b1[3][0]) + b1[4][0]
        return torch.log(torch.clamp(0.2 * zr, min=_TINY)) + self.bls

    def checkpoint(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The state entering the next step: ([6, Wp, B] = p1, p2, g,
        [2, B] = bls, cprev)."""
        return (torch.stack([self.p1, self.p2, *self.g]),
                torch.stack([self.bls, self.cprev]))

    def restore(self, ck: torch.Tensor, cs: torch.Tensor) -> None:
        self.p1, self.p2 = ck[0], ck[1]
        self.g = [ck[2 + s] for s in range(4)]
        self.bls, self.cprev = cs[0], cs[1]


def _backward(coef: np.ndarray, chain: bool, load, fink, find, shape):
    """(bm [d1k, Wp, B], bls [d1k, B], logZ [B]) of the backward over
    the diagonals of `shape` with emission source `load`."""
    d1k, Wp, B = shape
    dev = fink.device
    bw = _CircBackward(coef, chain, load, fink, find, Wp, B, dev)
    bm = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    bls = torch.empty((d1k, B), dtype=torch.float32, device=dev)
    for d in range(d1k - 1, -1, -1):
        bm[d] = bw.step(d)
        bls[d] = bw.bls
    return bm, bls, bw.logz()


def sv_backward_plain(coef: np.ndarray, chain: bool, es, fink, find):
    """Plain version of the sv_backward kernel: (bm [d1k, Wp, B],
    bls [d1k, B], logZ [B]) from es [d1k, Wp, B], the terminal row fink and
    diagonal find [B]."""
    return _backward(coef, chain, _es_source(es), fink, find, es.shape)


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


def sv_backward_resources(device: torch.device, wp: int,
                          B: int) -> Dict[str, int]:
    """What a launch of sv_backward over B lanes at band width `wp` gets on
    `device`: the keys of mw_forward_resources, the lanes a block chosen
    by csrc/common.cuh `warp_lanes`."""
    res = _build.resources("sv_backward_info", device, wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


# ------------------------------------------------------------- C: forward


class _CircForward:
    """The scaled forward of the circular layout, one diagonal per
    `step(d, bm_d, bls_d)` (d ascending from 0), as the kernels'
    `CircForward` runs it; returns post = f_M * b_M * exp(ls + bls - logZ)
    [Wp, B] in the circular layout.  At d = 0 the frontier is the start
    distribution (row 0 holds the origin cell; post there is NOT zeroed
    here)."""

    def __init__(self, coef: np.ndarray, chain: bool, load, logZ, Wp: int):
        B = logZ.shape[0]
        dev = logZ.device
        self.c = _floats(coef)
        self.chain = chain
        self.load = load
        self.logZ = logZ
        self.A = [[self.c[COEF_A + 5 * s + u] for u in range(5)]
                  for s in range(5)]
        row0 = torch.arange(Wp, device=dev)[:, None] == 0
        zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
        pi = [0.2] + [self.c[COEF_PI + s] if chain else 0.2
                      for s in range(4)]
        self.start = [torch.where(row0, p, zero) for p in pi]
        self.f1 = self.start
        self.f2 = [zero] * 5
        self.ls = torch.zeros(B, dtype=torch.float32, device=dev)
        self.cprev = torch.ones(B, dtype=torch.float32, device=dev)

    def _mix(self, vals, t):
        A = self.A
        out = vals[0] * A[0][t]
        for s in range(1, 5):
            out = out + vals[s] * A[s][t]
        return out

    def step(self, d: int, bm_d, bls_d) -> torch.Tensor:
        c, f1, f2 = self.c, self.f1, self.f2
        if d == 0:
            cur = self.start    # generation 0 is the start distribution
        else:
            e, valid = self.load(d)
            if self.chain:
                mix_m = c[COEF_T00] * f2[0]
                for s in range(1, 5):
                    mix_m = mix_m + c[COEF_MC + s - 1] * f2[s]
                mix_g = [f1[0] + c[COEF_C + t - 1] * f1[t]
                         for t in range(1, 5)]
            else:
                mix_m = self._mix(f2, 0)
                mix_g = [self._mix(f1, t) for t in range(1, 5)]
            if d % _RESCALE_PERIOD == 0:
                mix_m = mix_m / self.cprev
            cur = [e * _roll_down(mix_m), mix_g[0] * valid,
                   _roll_down(mix_g[1]) * valid, mix_g[2] * valid,
                   _roll_down(mix_g[3]) * valid]
            if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
                fmax = torch.stack(cur).amax(dim=(0, 1))
                cf = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
                inv = 1.0 / cf
                cur = [x * inv for x in cur]
                self.ls = self.ls + torch.log(cf)
                self.cprev = cf
            self.f2 = f1
        self.f1 = cur
        alpha = torch.exp(self.ls + bls_d - self.logZ)
        return cur[0] * bm_d * alpha


def _forward_generations(coef: np.ndarray, chain: bool, es, bm, bls, logZ):
    """The scaled forward shared by C and M: yields (d, post [Wp, B]) for
    every diagonal (`_CircForward` from the signed stream es)."""
    fw = _CircForward(coef, chain, _es_source(es), logZ, es.shape[1])
    for d in range(es.shape[0]):
        yield d, fw.step(d, bm[d], bls[d])


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


def cx_forward_resources(device: torch.device, wp: int,
                         B: int) -> Dict[str, int]:
    """What a launch of cx_forward over B lanes at band width `wp` gets on
    `device`: the keys of mw_forward_resources, the lanes a block chosen
    by csrc/common.cuh `warp_lanes`."""
    res = _build.resources("cx_forward_info", device, wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


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


def mw_forward_resources(device: torch.device, wp: int,
                         B: int) -> Dict[str, int]:
    """What a launch of mw_forward over B lanes at band width `wp` gets on
    `device`: the keys of expand_streams_resources and the lanes a block,
    which csrc/fb_circ.cu `mw_lanes` chooses from B, the SM count and the
    shared memory a block may take."""
    res = _build.resources("mw_forward_info", device, wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


# ------------------------------------- the serving modes' kernels (B16)
#
# The unfused serving route's backwards and posterior forwards, each for
# one emission source: es (the signed stream), emv (a premasked emission
# stream em and the int8 valid stream), codes (the int8 code streams xb,
# yb and valid with the 25 match emissions `table` = Ematch[ref][read]).
# Every band is [d1k, Wp, B] in the circular layout; post is the circular
# posterior band, the origin cell kept.


def _table_arg(table: Sequence[float]) -> np.ndarray:
    t = np.ascontiguousarray(table, np.float32)
    if t.shape != (25,):
        raise ValueError("expected 25 match emissions, got %s" % (t.shape,))
    return t


def _check_codes(xb, yb, valid):
    d1k, Wp, B = xb.shape
    for t in (xb, yb, valid):
        check_tensor(t, torch.int8, (d1k, Wp, B), xb.device)
    return d1k, Wp, B, xb.device


def _check_ends(fink, find, B, dev):
    check_tensor(fink, torch.int32, (B,), dev)
    check_tensor(find, torch.int32, (B,), dev)


def _backward_outputs(d1k, Wp, B, dev):
    return (torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev),
            torch.empty((d1k, B), dtype=torch.float32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def _check_back(bm, bls, logZ, d1k, Wp, B, dev):
    check_tensor(bm, torch.float32, (d1k, Wp, B), dev)
    check_tensor(bls, torch.float32, (d1k, B), dev)
    check_tensor(logZ, torch.float32, (B,), dev)


def circ_backward_emv_plain(coef: np.ndarray, chain: bool, em, valid, fink,
                            find):
    """Plain version of the circ_backward_emv kernel: (bm, bls, logZ) as
    sv_backward's, from em [d1k, Wp, B] f32 (premasked) and valid int8."""
    return _backward(coef, chain, _emv_source(em, valid), fink, find,
                     em.shape)


def circ_backward_emv_cuda(coef: np.ndarray, chain: bool, em, valid, fink,
                           find):
    """The circ_backward_emv kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B = em.shape
    dev = em.device
    check_tensor(em, torch.float32, (d1k, Wp, B), dev)
    check_tensor(valid, torch.int8, (d1k, Wp, B), dev)
    _check_ends(fink, find, B, dev)
    bm, bls, logZ = _backward_outputs(d1k, Wp, B, dev)
    _build.launch(
        "circ_backward_emv", dev, em.data_ptr(), valid.data_ptr(),
        fink.data_ptr(), find.data_ptr(), _coef(coef).ctypes.data,
        int(chain), d1k, Wp, B, bm.data_ptr(), bls.data_ptr(),
        logZ.data_ptr(),
    )
    return bm, bls, logZ


def circ_backward_codes_plain(coef: np.ndarray, chain: bool, table, xb, yb,
                              valid, fink, find):
    """Plain version of the circ_backward_codes kernel: (bm, bls, logZ)
    from the int8 code streams."""
    return _backward(coef, chain, _codes_source(table, xb, yb, valid), fink,
                     find, xb.shape)


def circ_backward_codes_cuda(coef: np.ndarray, chain: bool, table, xb, yb,
                             valid, fink, find):
    """The circ_backward_codes kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B, dev = _check_codes(xb, yb, valid)
    _check_ends(fink, find, B, dev)
    bm, bls, logZ = _backward_outputs(d1k, Wp, B, dev)
    _build.launch(
        "circ_backward_codes", dev, xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), _table_arg(table).ctypes.data, fink.data_ptr(),
        find.data_ptr(), _coef(coef).ctypes.data, int(chain), d1k, Wp, B,
        bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(),
    )
    return bm, bls, logZ


def circ_backward_codes_es_plain(coef: np.ndarray, chain: bool, table, xb,
                                 yb, valid, fink, find):
    """Plain version of the circ_backward_codes_es kernel: (bm, bls, logZ,
    es) where es [d1k, Wp, B] = e * valid - (1 - valid) is the signed
    stream of the emissions the backward computed."""
    load = _codes_source(table, xb, yb, valid)
    es = torch.empty(xb.shape, dtype=torch.float32, device=xb.device)

    def writing(d):
        e, v = load(d)
        es[d] = e - (1.0 - v)
        return e, v
    bm, bls, logZ = _backward(coef, chain, writing, fink, find, xb.shape)
    return bm, bls, logZ, es


def circ_backward_codes_es_cuda(coef: np.ndarray, chain: bool, table, xb,
                                yb, valid, fink, find):
    """The circ_backward_codes_es kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B, dev = _check_codes(xb, yb, valid)
    _check_ends(fink, find, B, dev)
    bm, bls, logZ = _backward_outputs(d1k, Wp, B, dev)
    es = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    _build.launch(
        "circ_backward_codes_es", dev, xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), _table_arg(table).ctypes.data, fink.data_ptr(),
        find.data_ptr(), _coef(coef).ctypes.data, int(chain), d1k, Wp, B,
        bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(), es.data_ptr(),
    )
    return bm, bls, logZ, es


def _post(coef: np.ndarray, chain: bool, load, bm, bls, logZ):
    """The circular posterior band of the forward over (bm, bls, logZ)."""
    d1k, Wp, _ = bm.shape
    fw = _CircForward(coef, chain, load, logZ, Wp)
    post = torch.empty_like(bm)
    for d in range(d1k):
        post[d] = fw.step(d, bm[d], bls[d])
    return post


def circ_post_es_plain(coef: np.ndarray, chain: bool, es, bm, bls, logZ):
    """Plain version of the circ_post_es kernel: the circular posterior
    band [d1k, Wp, B] from the signed stream es."""
    return _post(coef, chain, _es_source(es), bm, bls, logZ)


def circ_post_es_cuda(coef: np.ndarray, chain: bool, es, bm, bls, logZ):
    """The circ_post_es kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B = es.shape
    dev = es.device
    check_tensor(es, torch.float32, (d1k, Wp, B), dev)
    _check_back(bm, bls, logZ, d1k, Wp, B, dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    _build.launch(
        "circ_post_es", dev, es.data_ptr(), bm.data_ptr(), bls.data_ptr(),
        logZ.data_ptr(), _coef(coef).ctypes.data, int(chain), d1k, Wp, B,
        post.data_ptr(),
    )
    return post


def circ_post_emv_plain(coef: np.ndarray, chain: bool, em, valid, bm, bls,
                        logZ):
    """Plain version of the circ_post_emv kernel."""
    return _post(coef, chain, _emv_source(em, valid), bm, bls, logZ)


def circ_post_emv_cuda(coef: np.ndarray, chain: bool, em, valid, bm, bls,
                       logZ):
    """The circ_post_emv kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B = em.shape
    dev = em.device
    check_tensor(em, torch.float32, (d1k, Wp, B), dev)
    check_tensor(valid, torch.int8, (d1k, Wp, B), dev)
    _check_back(bm, bls, logZ, d1k, Wp, B, dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    _build.launch(
        "circ_post_emv", dev, em.data_ptr(), valid.data_ptr(), bm.data_ptr(),
        bls.data_ptr(), logZ.data_ptr(), _coef(coef).ctypes.data,
        int(chain), d1k, Wp, B, post.data_ptr(),
    )
    return post


def circ_post_codes_plain(coef: np.ndarray, chain: bool, table, xb, yb,
                          valid, bm, bls, logZ):
    """Plain version of the circ_post_codes kernel."""
    return _post(coef, chain, _codes_source(table, xb, yb, valid), bm, bls,
                 logZ)


def circ_post_codes_cuda(coef: np.ndarray, chain: bool, table, xb, yb,
                         valid, bm, bls, logZ):
    """The circ_post_codes kernel (csrc/fb_serve.cu)."""
    d1k, Wp, B, dev = _check_codes(xb, yb, valid)
    _check_back(bm, bls, logZ, d1k, Wp, B, dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    _build.launch(
        "circ_post_codes", dev, xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), _table_arg(table).ctypes.data, bm.data_ptr(),
        bls.data_ptr(), logZ.data_ptr(), _coef(coef).ctypes.data,
        int(chain), d1k, Wp, B, post.data_ptr(),
    )
    return post


# The serving kernels' templates and emission sources (csrc/fb_serve.cu
# `serve_backward_kernel` / `serve_post_kernel`, SRC_*).
_SERVE_SOURCES = {
    "circ_backward_emv": ("serve_backward_info", 1),
    "circ_backward_codes": ("serve_backward_info", 2),
    "circ_backward_codes_es": ("serve_backward_info", 3),
    "circ_post_es": ("serve_post_info", 0),
    "circ_post_emv": ("serve_post_info", 1),
    "circ_post_codes": ("serve_post_info", 2),
}


def serve_resources(device: torch.device, name: str, wp: int,
                    B: int) -> Dict[str, int]:
    """What a launch of serving kernel `name` (one of the six circ_backward_*
    and circ_post_* entry points) over B lanes at band width `wp` gets on
    `device`: the keys of mw_forward_resources and the lanes a block (the
    backwards take S's, the forwards K3's rule; the forwards copy by TMA
    where B % 4 == 0 and wp <= 64)."""
    query, src = _SERVE_SOURCES[name]
    res = _build.resources(query, device, src, wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


# KB, the diagonals per checkpoint, sets the shape of ck, which the plain
# versions share, so its rule stays that of the pair's first kernels: the
# largest of 32, 16 and 8 whose replay fitted shared memory in a block of
# 32 lanes (the backward's 12 planes of [Wp][32], bm [KB][Wp][32], bls
# [KB][32], beside the forward's 12 planes; 227 KB on an H100).  The
# kernels of csrc/fb_ckpt.cu take any KB that is a multiple of their tile
# (16 diagonals at Wp <= 32, else 8).
_SMEM_BYTES = 232448
_LANES = 32


def _replay_floats(Wp: int, kb: int) -> int:
    return ((12 + kb) * Wp + kb) * _LANES


def _replay_fits(Wp: int, kb: int) -> bool:
    return (12 * Wp * _LANES + _replay_floats(Wp, kb)) * 4 <= _SMEM_BYTES


def ckpt_block(Wp: int) -> int:
    """KB, the diagonals per checkpoint: 32 (the TPU kernels'
    `_CKPT_BLOCK`) where a 32-lane block's replay fits the card's shared
    memory (`_replay_fits`), else 16 or 8 (the rescale period divides each,
    so the schedule is unchanged); 32 again where not even 8 fit
    (Wp > 56)."""
    for kb in (32, 16, 8):
        if _replay_fits(Wp, kb):
            return kb
    return 32


def circ_ckpt_backward_plain(coef: np.ndarray, chain: bool, table, xb, yb,
                             valid, fink, find, kb: int):
    """Plain version of the circ_ckpt_backward kernel: (ck [G, 6, Wp, B],
    cs [G, 2, B], logZ [B]), G = ceil(d1k / kb).  ck[g] and cs[g] are the
    state entering block g (diagonals g*kb .. g*kb + kb - 1) from above:
    the e_M * b_M rows of the two diagonals above it, the gap states 1..4
    of the one above, then bls and the last rescale factor."""
    d1k, Wp, B = xb.shape
    dev = xb.device
    G = -(-d1k // kb)
    bw = _CircBackward(coef, chain, _codes_source(table, xb, yb, valid),
                       fink, find, Wp, B, dev)
    ck = torch.empty((G, 6, Wp, B), dtype=torch.float32, device=dev)
    cs = torch.empty((G, 2, B), dtype=torch.float32, device=dev)
    for g in range(G - 1, -1, -1):
        ck[g], cs[g] = bw.checkpoint()
        for d in range(min(g * kb + kb, d1k) - 1, g * kb - 1, -1):
            bw.step(d)
    return ck, cs, bw.logz()


def circ_ckpt_backward_cuda(coef: np.ndarray, chain: bool, table, xb, yb,
                            valid, fink, find, kb: int):
    """The circ_ckpt_backward kernel (csrc/fb_ckpt.cu); kb a multiple of
    its tile (16 diagonals at Wp <= 32, else 8)."""
    d1k, Wp, B, dev = _check_codes(xb, yb, valid)
    _check_ends(fink, find, B, dev)
    G = -(-d1k // kb)
    ck = torch.empty((G, 6, Wp, B), dtype=torch.float32, device=dev)
    cs = torch.empty((G, 2, B), dtype=torch.float32, device=dev)
    logZ = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "circ_ckpt_backward", dev, xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), _table_arg(table).ctypes.data, fink.data_ptr(),
        find.data_ptr(), _coef(coef).ctypes.data, int(chain), d1k, Wp, B,
        kb, ck.data_ptr(), cs.data_ptr(), logZ.data_ptr(),
    )
    return ck, cs, logZ


def circ_ckpt_post_plain(coef: np.ndarray, chain: bool, table, xb, yb, valid,
                         fink, find, ck, cs, logZ, kb: int):
    """Plain version of the circ_ckpt_post kernel: the circular posterior
    band [d1k, Wp, B]; per block, ascending, the backward replayed from its
    checkpoint, then the forward over the block."""
    d1k, Wp, B = xb.shape
    dev = xb.device
    load = _codes_source(table, xb, yb, valid)
    bw = _CircBackward(coef, chain, load, fink, find, Wp, B, dev)
    fw = _CircForward(coef, chain, load, logZ, Wp)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    for g in range(ck.shape[0]):
        lo, hi = g * kb, min(g * kb + kb, d1k)
        bw.restore(ck[g], cs[g])
        back = {}
        for d in range(hi - 1, lo - 1, -1):
            back[d] = (bw.step(d), bw.bls)
        for d in range(lo, hi):
            post[d] = fw.step(d, *back[d])
    return post


def circ_ckpt_post_cuda(coef: np.ndarray, chain: bool, table, xb, yb, valid,
                        fink, find, ck, cs, logZ, kb: int):
    """The circ_ckpt_post kernel (csrc/fb_ckpt.cu); its replay and forward
    tiles live in a scratch tensor on the device where they do not fit
    shared memory (Wp > 72 at kb 32)."""
    d1k, Wp, B, dev = _check_codes(xb, yb, valid)
    _check_ends(fink, find, B, dev)
    G = -(-d1k // kb)
    check_tensor(ck, torch.float32, (G, 6, Wp, B), dev)
    check_tensor(cs, torch.float32, (G, 2, B), dev)
    check_tensor(logZ, torch.float32, (B,), dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    per_block, blocks = _ckpt_post_scratch(dev, Wp, B, kb)
    scratch = (torch.empty(per_block * blocks, dtype=torch.float32,
                           device=dev) if per_block else None)
    _build.launch(
        "circ_ckpt_post", dev, xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), _table_arg(table).ctypes.data, fink.data_ptr(),
        find.data_ptr(), ck.data_ptr(), cs.data_ptr(), logZ.data_ptr(),
        _coef(coef).ctypes.data, int(chain), d1k, Wp, B, kb,
        None if scratch is None else scratch.data_ptr(), post.data_ptr(),
    )
    return post


def _ckpt_post_scratch(device: torch.device, wp: int, B: int,
                       kb: int) -> Tuple[int, int]:
    """(floats a block, blocks) of the device memory circ_ckpt_post's
    launch at (wp, B, kb) needs for its tiles ((0, blocks): none)."""
    out = (ctypes.c_int * 2)()
    _build.query("circ_ckpt_post_scratch", device, wp, B, kb,
                 ctypes.addressof(out))
    return out[0], out[1]


def ckpt_resources(device: torch.device, name: str, wp: int, B: int,
                   kb: int) -> Dict[str, int]:
    """What a launch of `name` (circ_ckpt_backward or circ_ckpt_post) over B
    lanes at band width `wp` and kb diagonals per checkpoint gets on
    `device`: the keys of mw_forward_resources, the warps a lane (2 where
    the posterior pass pipelines its replay and forward) and the scratch
    floats a block (the posterior pass's tiles in device memory; 0: in
    shared memory)."""
    out = (ctypes.c_int * 8)()
    _build.query("circ_ckpt_info", device, int(name == "circ_ckpt_backward"),
                 wp, B, kb, ctypes.addressof(out))
    keys = ("registers", "smem_per_block", "blocks_per_sm",
            "threads_per_block", "local_bytes", "lanes_per_block",
            "warps_per_lane", "scratch_floats_per_block")
    return dict(zip(keys, out))
