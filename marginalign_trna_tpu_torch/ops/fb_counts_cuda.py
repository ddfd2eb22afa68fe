"""Baum-Welch expected counts (the EM E-step): the four CUDA kernels of
csrc/fb_counts.cu and their plain PyTorch versions.

Port of marginalign_trna_tpu/ops/fb_pallas_counts.py, single-problem lanes:

  counts_fwd_all   <- `_fwd_all_impl` (rows 24 and 26): scaled forward over
                      the whole band storing all five states per diagonal
                      (f_all), the cumulative log-scale lsf and the terminal
                      sum term of every diagonal;
  counts_bwd       <- `_bwd_counts_impl` (rows 24 and 26): scaled backward
                      that writes the posterior match band and accumulates,
                      per lane, the 25 transition partials
                      sum F_hat[s] * q_hat[u] * alpha (T applied outside) and
                      the 20 gap-state occupancy-by-code partials;
  counts_fwd_ckpt  <- `_fwd_ckpt_impl` (rows 28 and 29): the same forward,
                      storing only the frontier of every 8-diagonal block
                      (f[d] and f[d-1], ckpt) and its scale state (cs);
  counts_bwd_ckpt  <- `_bwd_counts_ckpt_impl` (rows 28 and 29): per block,
                      recompute the forward from the previous block's
                      checkpoint, then the backward of counts_bwd with the
                      25 match-emission partials folded in (no posterior
                      band).

and the same four over multi-problem lanes (several problems per lane,
SPACER empty diagonals apart: ops/band.py `pack_multi_banded_batch`):

  counts_multi_fwd_all, counts_multi_bwd      <- `_fwd_all_multi_impl`,
      `_bwd_counts_multi_impl` (rows 25 and 27);
  counts_multi_fwd_ckpt, counts_multi_bwd_ckpt <- `_fwd_ckpt_multi_impl`,
      `_bwd_counts_ckpt_multi_impl` (row 30).

Every function takes the model as stacked tables T, Ematch, Egap
[Ntr, 5, 5] (one per EM trial; Ntr = 1 for a serial trial) and the band
streams padded to d1k, a multiple of 8 diagonals: xb, yb int8, valid bool
[d1k, Wp, B], s1 int32 [d1k, B], fink, find int32 [B].  The multi-lane
functions take fink and find per diagonal, int32 [d1k, B] (-1 off each
problem's terminal diagonal), and start int8 [d1k, B]; their backwards take
L [Ntr, d1k, B] (the log-likelihood of the problem owning each diagonal)
where the single-lane ones take logZ [Ntr, B].  The trials share the
streams.  Outputs carry the trials axis first.

The arithmetic is the TPU kernels' with the model as run-time tables:
generic emissions Ematch[x][y] and Egap[s][code] (gap rows need not be flat:
mid-training models are not), the 8-diagonal rescale (forward at
d % 8 == 7, backward at d % 8 == 0, factor 1 for a step with no mass), the
d-2 term divided by the previous factor on the diagonal after a rescale,
the uniform start distribution at row 0 of d = 0, the terminal injection at
(find, fink), and no emission counted at the d = 0 boundary cell.  Over
multi-problem lanes every diagonal runs the recursion from a zero frontier,
the start distribution is added in all five states at row 0 of each
problem's first diagonal, the backward injects at every terminal cell and
restarts its log-scale there, and a problem's first diagonal counts no
emission.  The
plain versions follow it step for step; only the count partials sum in
another order in the kernels (per thread over the diagonals, then over the
band rows once), so they agree with the plain versions to float32
summation error, while f_all, lsf, term, the checkpoints and the posterior
band round identically.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import _build
from ._build import check_tensor
from .fb import shift

_NSTATE = 5
_RESCALE_PERIOD = 8
STEP_BLOCK = 8
N_TRANS = 25       # transition partials, row s * 5 + u
N_GAP = 20         # gap partials, row (s - 1) * 5 + code
N_MATCH = 25       # match partials, row ref_code * 5 + read_code
MAX_WP = 32        # band rows the kernels take (one a thread of a warp)


# --------------------------------------------------------------- arithmetic


def _cols(tab: torch.Tensor) -> List[List[torch.Tensor]]:
    """tab [Ntr, 5, 5] -> [a][b] views [Ntr, 1, 1] for broadcasting."""
    n = tab.shape[0]
    return [[tab[:, a, b].reshape(n, 1, 1) for b in range(5)]
            for a in range(5)]


def _emissions(Em, Eg, x: torch.Tensor, y: torch.Tensor):
    """(e_match, [e_gap of states 1..4]) [Ntr, Wp, B] at one diagonal:
    Ematch[x][y] and Egap[s][x] (states 1, 3) or Egap[s][y] (2, 4), 0 for a
    code outside 0..4 (the TPU kernels' one-hot sums)."""
    okx = (x >= 0) & (x < 5)
    oky = (y >= 0) & (y < 5)
    xi = torch.where(okx, x, 0).long()
    yi = torch.where(oky, y, 0).long()
    zero = Em.new_zeros(())
    em = torch.where(okx & oky, Em[:, xi, yi], zero)
    gx = torch.where(okx, Eg[:, :, xi], zero)      # [Ntr, 5, Wp, B]
    gy = torch.where(oky, Eg[:, :, yi], zero)
    return em, [gx[:, 1], gy[:, 2], gx[:, 3], gy[:, 4]]


def _mix(T, vals, t):
    """sum_s vals[s] * T[s][t], left to right."""
    acc = vals[0] * T[0][t]
    for s in range(1, _NSTATE):
        acc = acc + vals[s] * T[s][t]
    return acc


def _max_rows(vals) -> torch.Tensor:
    """Per-lane max over the five states and the band rows: [Ntr, B]."""
    m = torch.maximum(torch.maximum(torch.maximum(vals[0], vals[1]),
                                    torch.maximum(vals[2], vals[3])), vals[4])
    return m.amax(dim=-2)


def _sum5(vals):
    return vals[0] + vals[1] + vals[2] + vals[3] + vals[4]


class _Forward:
    """The counts forward's state, one diagonal at a time: frontiers f1
    (d-1) and f2 (d-2), log-scale ls, last factor cprev, previous s1.
    Single-problem lanes start from the start distribution at d = 0;
    multi-problem lanes (multi=True) from the zero frontier before d = 0,
    their previous s1 0."""

    def __init__(self, T, Em, Eg, Wp, B, multi: bool = False):
        self.T, self.Em, self.Eg = _cols(T), Em, Eg
        ntr = T.shape[0]
        self.zero = T.new_zeros((ntr, Wp, B))
        init = self.zero.clone()
        if not multi:
            init[:, 0] = 0.2
        self.f1 = [init] * _NSTATE
        self.f2 = [self.zero] * _NSTATE
        self.ls = T.new_zeros((ntr, B))
        self.cprev = T.new_ones((ntr, B))
        self.sprev = (torch.zeros(B, dtype=torch.int32, device=T.device)
                      if multi else None)
        self.rows = torch.arange(Wp, device=T.device)[:, None]

    def restart(self, f1, f2, ls, cprev, sprev):
        self.f1, self.f2 = f1, f2
        self.ls, self.cprev, self.sprev = ls, cprev, sprev

    def step(self, d, xb, yb, valid, s1, start=None):
        """Advance to diagonal d (d >= 1 on single-problem lanes); returns
        the unscaled new frontier's five states and the rescale factor's
        inverse (None off the rescale diagonals).  self.f1 is then the
        (scaled) frontier at d.  With the start stream (multi-problem
        lanes) the start distribution is added at row 0 of every lane
        where a problem starts at d."""
        t1 = s1[d]
        t2 = t1 + self.sprev
        self.sprev = t1
        em, eg = _emissions(self.Em, self.Eg, xb[d], yb[d])
        v = valid[d].float()
        mix_m = _mix(self.T, self.f2, 0)
        if d % _RESCALE_PERIOD == 0:
            mix_m = mix_m / self.cprev[:, None, :]
        mix_g = [_mix(self.T, self.f1, t) for t in range(1, _NSTATE)]
        new = [em * shift(mix_m, t2 - 1) * v,
               eg[0] * shift(mix_g[0], t1) * v,
               eg[1] * shift(mix_g[1], t1 - 1) * v,
               eg[2] * shift(mix_g[2], t1) * v,
               eg[3] * shift(mix_g[3], t1 - 1) * v]
        if start is not None:
            seed = (self.rows == 0) & (start[d] != 0)[None, :]
            inj = torch.where(seed, 0.2, 0.0)
            new = [x + inj for x in new]
        inv = None
        scaled = new
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            fmax = _max_rows(new)
            c = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
            inv = 1.0 / c
            scaled = [x * inv[:, None, :] for x in new]
            self.ls = self.ls + torch.log(c)
            self.cprev = c
        self.f2, self.f1 = self.f1, scaled
        return new, inv


def _forward(T, Em, Eg, xb, yb, valid, s1, fink, store: str, start=None):
    """The forward over the band, storing (the kernels' modes) "all": the
    five states of every diagonal (f_all), "ckpt": the checkpoints of every
    8-diagonal block, or "match": the match state of every diagonal
    (F_match, the generic forward); with lsf and term.  With the start
    stream the band holds multi-problem lanes, and fink is per diagonal."""
    d1k, Wp, B = xb.shape
    ntr = T.shape[0]
    multi = start is not None
    fw = _Forward(T, Em, Eg, Wp, B, multi)
    rows = torch.arange(Wp, device=xb.device)[:, None]

    def sel(d):
        """1 at the row of the terminal cell on diagonal d, else 0."""
        return (rows == (fink[d] if multi else fink)[None, :]).float()

    lsf = T.new_empty((ntr, d1k, B))
    term = T.new_empty((ntr, d1k, B))
    if store == "ckpt":
        G = d1k // STEP_BLOCK
        ck = T.new_empty((ntr, G, 2 * _NSTATE, Wp, B))
        cs = T.new_zeros((ntr, G, 4, B))
    elif store == "all":
        band = T.new_empty((ntr, d1k, _NSTATE, Wp, B))
    else:
        band = T.new_empty((ntr, d1k, Wp, B))

    def keep(d):
        if store == "all":
            band[:, d] = torch.stack(fw.f1, dim=1)
        elif store == "match":
            band[:, d] = fw.f1[0]

    first = 0
    if not multi:
        # d = 0 is pure initialisation: the start distribution at row 0.
        fw.sprev = s1[0]
        lsf[:, 0] = fw.ls
        term[:, 0] = (_sum5(fw.f1) * sel(0)).sum(dim=-2)
        keep(0)
        first = 1
    for d in range(first, d1k):
        new, inv = fw.step(d, xb, yb, valid, s1, start)
        t = (_sum5(new) * sel(d)).sum(dim=-2)
        term[:, d] = t if inv is None else t * inv
        lsf[:, d] = fw.ls
        keep(d)
        if store == "ckpt" and d % STEP_BLOCK == STEP_BLOCK - 1:
            g = d // STEP_BLOCK
            ck[:, g] = torch.stack(fw.f1 + fw.f2, dim=1)
            cs[:, g, 0] = fw.ls
            cs[:, g, 1] = fw.cprev
            cs[:, g, 2] = fw.sprev.float()
    if store == "ckpt":
        return ck, cs, lsf, term
    return band, lsf, term


class _Backward:
    """The counts backward's state and per-lane partials, one diagonal at
    a time (descending d).  counts=False keeps no partials (the generic
    forward-backward's backward, ops/fb_generic_cuda.py): `step` then needs
    only the match plane of the forward frontier.  With the start stream
    (multi-problem lanes) logZ is the per-diagonal L [Ntr, d1k, B] and
    fink, find are per diagonal."""

    def __init__(self, T, Em, Eg, logZ, Wp, B, match: bool,
                 counts: bool = True, start=None):
        self.T, self.Em, self.Eg = _cols(T), Em, Eg
        ntr = T.shape[0]
        zero = T.new_zeros((ntr, Wp, B))
        self.p1 = self.p2 = zero           # e_M * b_M at d+1, d+2
        self.g1 = [zero] * 4               # e_s * b_s at d+1, states 1..4
        self.bls = T.new_zeros((ntr, B))
        self.cprev = T.new_ones((ntr, B))
        self.sh1 = self.sh2 = torch.zeros(B, dtype=torch.int32,
                                          device=T.device)  # s1 at d+1, d+2
        self.logZ = logZ
        self.start = start
        self.tca = T.new_zeros((ntr, N_TRANS, B)) if counts else None
        self.ega = T.new_zeros((ntr, N_GAP, B)) if counts else None
        self.mca = T.new_zeros((ntr, N_MATCH, B)) if match else None
        self.codes = torch.arange(5, device=T.device)[:, None, None]

    def step(self, d, f_d, lsf_d, xb, yb, valid, s1, fink, find):
        """Diagonal d from the forward frontier f_d ([Ntr, 5, Wp, B], or
        [Ntr, 1, Wp, B] without counts, at log-scale lsf_d [Ntr, B]);
        returns the posterior match band of d."""
        Wp = f_d.shape[-2]
        s1n, s2n = self.sh1, self.sh1 + self.sh2
        q = [shift(self.p2, 1 - s2n),
             shift(self.g1[0], -s1n), shift(self.g1[1], 1 - s1n),
             shift(self.g1[2], -s1n), shift(self.g1[3], 1 - s1n)]
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            q[0] = q[0] / self.cprev[:, None, :]
        x, y = xb[d], yb[d]
        em, eg = _emissions(self.Em, self.Eg, x, y)
        self.sh2, self.sh1 = self.sh1, s1[d]
        kr = torch.arange(Wp, device=f_d.device)[:, None]
        if self.start is None:
            at_term, lz = find == d, self.logZ
            inj = ((kr == fink[None, :]) & at_term[None, :]).float()
        else:
            at_term, lz = find[d] == d, self.logZ[:, d]
            inj = ((kr == fink[d][None, :]) & at_term[None, :]).float()
            # Each problem's backward restarts at its terminal cell.
            self.bls = torch.where(at_term, 0.0, self.bls)
        v = valid[d].float()
        new = []
        for s in range(_NSTATE):
            acc = q[0] * self.T[s][0]
            for u in range(1, _NSTATE):
                acc = acc + q[u] * self.T[s][u]
            new.append((acc + inj) * v)
        if d % _RESCALE_PERIOD == 0:
            bmax = _max_rows(new)
            c = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
            inv = 1.0 / c
            self.bls = self.bls + torch.log(c)
            self.cprev = c
            new = [b * inv[:, None, :] for b in new]
            alpha0 = torch.exp(lsf_d + self.bls - lz)
            alpha1 = alpha0 * inv
        else:
            alpha0 = torch.exp(lsf_d + self.bls - lz)
            alpha1 = alpha0
        a0 = alpha0[:, None, :]
        post = f_d[:, 0] * new[0] * a0
        if self.tca is not None:
            self._count(d, f_d, new, q, alpha1, a0, x, y)
        self.p2, self.p1 = self.p1, em * new[0]
        self.g1 = [eg[s - 1] * new[s] for s in range(1, _NSTATE)]
        return post

    def _count(self, d, f_d, new, q, alpha1, a0, x, y):
        """Add diagonal d's count partials."""
        # Transition partials: sum over rows of (F_hat[s] * alpha1) * q[u].
        fs = f_d * alpha1[:, None, None, :]
        qs = torch.stack(q, dim=1)
        self.tca += (fs[:, :, None] * qs[:, None]).sum(dim=-2).reshape(
            fs.shape[0], N_TRANS, -1)
        # Gap (and match) occupancy by code; the d = 0 boundary cell (each
        # problem's first diagonal) holds the start distribution and emits
        # nothing.
        if self.start is None:
            a0n = a0 * (0.0 if d == 0 else 1.0)
        else:
            a0n = a0 * (self.start[d] == 0).float()
        gam = torch.stack([f_d[:, s] * new[s] for s in range(1, _NSTATE)],
                          dim=1) * a0n[:, None]
        hx = (x.long()[None] == self.codes).float()    # [5, Wp, B]
        hy = (y.long()[None] == self.codes).float()
        for s, h in ((0, hx), (1, hy), (2, hx), (3, hy)):
            self.ega[:, 5 * s:5 * s + 5] += (gam[:, s, None] * h).sum(dim=-2)
        if self.mca is not None:
            gm = f_d[:, 0] * new[0] * a0n
            for a in range(5):
                self.mca[:, 5 * a:5 * a + 5] += (
                    (gm * hx[a])[:, None] * hy).sum(dim=-2)


# ------------------------------------------------------------ plain versions


def counts_fwd_all_plain(T, Em, Eg, xb, yb, valid, s1, fink):
    """Plain version of the counts_fwd_all kernel: (f_all
    [Ntr, d1k, 5, Wp, B], lsf [Ntr, d1k, B], term [Ntr, d1k, B])."""
    return _forward(T, Em, Eg, xb, yb, valid, s1, fink, "all")


def counts_bwd_plain(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink, find,
                     logZ):
    """Plain version of the counts_bwd kernel: (post [Ntr, d1k, Wp, B],
    tcp [Ntr, 25, B], egp [Ntr, 20, B])."""
    d1k, Wp, B = xb.shape
    bw = _Backward(T, Em, Eg, logZ, Wp, B, match=False)
    post = T.new_empty((T.shape[0], d1k, Wp, B))
    for d in range(d1k - 1, -1, -1):
        post[:, d] = bw.step(d, f_all[:, d], lsf[:, d], xb, yb, valid, s1,
                             fink, find)
    return post, bw.tca, bw.ega


def counts_fwd_ckpt_plain(T, Em, Eg, xb, yb, valid, s1, fink):
    """Plain version of the counts_fwd_ckpt kernel: (ckpt
    [Ntr, G, 10, Wp, B] = f[d] and f[d-1] at the last diagonal d of each
    8-diagonal block, cs [Ntr, G, 4, B] = ls, cprev, s1 there and 0,
    lsf [Ntr, d1k, B], term [Ntr, d1k, B])."""
    return _forward(T, Em, Eg, xb, yb, valid, s1, fink, "ckpt")


def counts_bwd_ckpt_plain(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink,
                          find, logZ):
    """Plain version of the counts_bwd_ckpt kernel: (tcp [Ntr, 25, B],
    egp [Ntr, 20, B], mcp [Ntr, 25, B]).  Each block's forward restarts
    from the previous block's checkpoint (block 0 from the start state)."""
    return _bwd_ckpt(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink, find,
                     logZ)


def _bwd_ckpt(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink, find, logZ,
              start=None):
    """The checkpoint backward, single-problem lanes or (with the start
    stream) multi-problem lanes."""
    d1k, Wp, B = xb.shape
    multi = start is not None
    bw = _Backward(T, Em, Eg, logZ, Wp, B, match=True, start=start)
    for g in range(d1k // STEP_BLOCK - 1, -1, -1):
        fw = _Forward(T, Em, Eg, Wp, B, multi)
        base = g * STEP_BLOCK
        if g == 0 and multi:
            fs, lsb = [], []
        elif g == 0:
            fw.sprev = s1[0]
            fs, lsb = [torch.stack(fw.f1, dim=1)], [fw.ls]
        else:
            prev = ckpt[:, g - 1]
            fw.restart([prev[:, s] for s in range(_NSTATE)],
                       [prev[:, _NSTATE + s] for s in range(_NSTATE)],
                       cs[:, g - 1, 0], cs[:, g - 1, 1],
                       cs[:, g - 1, 2].to(s1.dtype)[0])
            fs, lsb = [], []
        for d in range(base + len(fs), base + STEP_BLOCK):
            fw.step(d, xb, yb, valid, s1, start)
            fs.append(torch.stack(fw.f1, dim=1))
            lsb.append(fw.ls)
        for kb in range(STEP_BLOCK - 1, -1, -1):
            bw.step(base + kb, fs[kb], lsb[kb], xb, yb, valid, s1, fink,
                    find)
    return bw.tca, bw.ega, bw.mca


def counts_multi_fwd_all_plain(T, Em, Eg, xb, yb, valid, s1, start, fink):
    """Plain version of the counts_multi_fwd_all kernel: (f_all
    [Ntr, d1k, 5, Wp, B], lsf [Ntr, d1k, B], term [Ntr, d1k, B], 0 off
    terminal diagonals) over multi-problem lanes."""
    return _forward(T, Em, Eg, xb, yb, valid, s1, fink, "all", start)


def counts_multi_bwd_plain(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, start,
                           fink, find, L):
    """Plain version of the counts_multi_bwd kernel: (post
    [Ntr, d1k, Wp, B], each problem normalised by its L, tcp [Ntr, 25, B],
    egp [Ntr, 20, B])."""
    d1k, Wp, B = xb.shape
    bw = _Backward(T, Em, Eg, L, Wp, B, match=False, start=start)
    post = T.new_empty((T.shape[0], d1k, Wp, B))
    for d in range(d1k - 1, -1, -1):
        post[:, d] = bw.step(d, f_all[:, d], lsf[:, d], xb, yb, valid, s1,
                             fink, find)
    return post, bw.tca, bw.ega


def counts_multi_fwd_ckpt_plain(T, Em, Eg, xb, yb, valid, s1, start, fink):
    """Plain version of the counts_multi_fwd_ckpt kernel: (ckpt
    [Ntr, G, 10, Wp, B], cs [Ntr, G, 4, B], lsf, term [Ntr, d1k, B]) over
    multi-problem lanes (counts_fwd_ckpt_plain's checkpoints)."""
    return _forward(T, Em, Eg, xb, yb, valid, s1, fink, "ckpt", start)


def counts_multi_bwd_ckpt_plain(T, Em, Eg, ckpt, cs, xb, yb, valid, s1,
                                start, fink, find, L):
    """Plain version of the counts_multi_bwd_ckpt kernel: (tcp, egp, mcp)
    as counts_bwd_ckpt_plain's.  Block 0's forward restarts from the zero
    frontier, and each block's recompute seeds the problems that start in
    it."""
    return _bwd_ckpt(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink, find, L,
                     start)


# ------------------------------------------------------------------ kernels


def _check_common(T, Em, Eg, xb, yb, valid, s1, fink, start=None):
    d1k, Wp, B = xb.shape
    dev = xb.device
    ntr = T.shape[0]
    for tab in (T, Em, Eg):
        check_tensor(tab, torch.float32, (ntr, 5, 5), dev)
    check_tensor(xb, torch.int8, (d1k, Wp, B), dev)
    check_tensor(yb, torch.int8, (d1k, Wp, B), dev)
    check_tensor(valid, torch.bool, (d1k, Wp, B), dev)
    check_tensor(s1, torch.int32, (d1k, B), dev)
    if start is None:
        check_tensor(fink, torch.int32, (B,), dev)
    else:
        check_tensor(start, torch.int8, (d1k, B), dev)
        check_tensor(fink, torch.int32, (d1k, B), dev)
    if d1k % STEP_BLOCK or Wp > MAX_WP:
        raise ValueError("the counts kernels take d1k a multiple of %d and "
                         "Wp <= %d (got d1k=%d, Wp=%d)"
                         % (STEP_BLOCK, MAX_WP, d1k, Wp))
    return ntr, d1k, Wp, B, dev


def _fwd_cuda(ckpt: bool, T, Em, Eg, xb, yb, valid, s1, fink, start=None):
    ntr, d1k, Wp, B, dev = _check_common(T, Em, Eg, xb, yb, valid, s1, fink,
                                         start)
    G = d1k // STEP_BLOCK
    f32 = dict(dtype=torch.float32, device=dev)
    if ckpt:
        band = torch.empty((ntr, G, 2 * _NSTATE, Wp, B), **f32)
        cs = torch.zeros((ntr, G, 4, B), **f32)
    else:
        band = torch.empty((ntr, d1k, _NSTATE, Wp, B), **f32)
        cs = None
    lsf = torch.empty((ntr, d1k, B), **f32)
    term = torch.zeros((ntr, d1k, B), **f32)
    name = "counts_fwd_ckpt" if ckpt else "counts_fwd_all"
    streams = [xb.data_ptr(), yb.data_ptr(), valid.data_ptr(), s1.data_ptr()]
    if start is not None:
        name = name.replace("counts_", "counts_multi_")
        streams.append(start.data_ptr())
    _build.launch(
        name, dev, T.data_ptr(), Em.data_ptr(), Eg.data_ptr(), *streams,
        fink.data_ptr(), ntr, d1k, Wp, B, band.data_ptr(),
        0 if cs is None else cs.data_ptr(), lsf.data_ptr(), term.data_ptr(),
    )
    return (band, cs, lsf, term) if ckpt else (band, lsf, term)


def counts_fwd_all_cuda(T, Em, Eg, xb, yb, valid, s1, fink):
    """The counts_fwd_all kernel (csrc/fb_counts.cu); outputs of
    counts_fwd_all_plain."""
    return _fwd_cuda(False, T, Em, Eg, xb, yb, valid, s1, fink)


def counts_fwd_ckpt_cuda(T, Em, Eg, xb, yb, valid, s1, fink):
    """The counts_fwd_ckpt kernel (csrc/fb_counts.cu); outputs of
    counts_fwd_ckpt_plain."""
    return _fwd_cuda(True, T, Em, Eg, xb, yb, valid, s1, fink)


def _bwd_cuda(ckpt: bool, T, Em, Eg, band, lsf_or_cs, xb, yb, valid, s1,
              fink, find, logZ, start=None) -> Tuple[torch.Tensor, ...]:
    ntr, d1k, Wp, B, dev = _check_common(T, Em, Eg, xb, yb, valid, s1, fink,
                                         start)
    G = d1k // STEP_BLOCK
    if start is None:
        check_tensor(find, torch.int32, (B,), dev)
        check_tensor(logZ, torch.float32, (ntr, B), dev)
    else:
        check_tensor(find, torch.int32, (d1k, B), dev)
        check_tensor(logZ, torch.float32, (ntr, d1k, B), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if ckpt:
        check_tensor(band, torch.float32, (ntr, G, 2 * _NSTATE, Wp, B), dev)
        check_tensor(lsf_or_cs, torch.float32, (ntr, G, 4, B), dev)
        post = None
    else:
        check_tensor(band, torch.float32, (ntr, d1k, _NSTATE, Wp, B), dev)
        check_tensor(lsf_or_cs, torch.float32, (ntr, d1k, B), dev)
        post = torch.empty((ntr, d1k, Wp, B), **f32)
    tcp = torch.empty((ntr, N_TRANS, B), **f32)
    egp = torch.empty((ntr, N_GAP, B), **f32)
    mcp = torch.empty((ntr, N_MATCH, B), **f32) if ckpt else None
    name = "counts_bwd_ckpt" if ckpt else "counts_bwd"
    streams = [xb.data_ptr(), yb.data_ptr(), valid.data_ptr(), s1.data_ptr()]
    if start is not None:
        name = name.replace("counts_", "counts_multi_")
        streams.append(start.data_ptr())
    _build.launch(
        name, dev, T.data_ptr(), Em.data_ptr(), Eg.data_ptr(),
        band.data_ptr(), lsf_or_cs.data_ptr(), *streams, fink.data_ptr(),
        find.data_ptr(), logZ.data_ptr(), ntr, d1k, Wp, B,
        0 if post is None else post.data_ptr(), tcp.data_ptr(),
        egp.data_ptr(), 0 if mcp is None else mcp.data_ptr(),
    )
    return (tcp, egp, mcp) if ckpt else (post, tcp, egp)


def counts_bwd_cuda(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink, find,
                    logZ):
    """The counts_bwd kernel (csrc/fb_counts.cu); outputs of
    counts_bwd_plain."""
    return _bwd_cuda(False, T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink,
                     find, logZ)


def counts_bwd_ckpt_cuda(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink, find,
                         logZ):
    """The counts_bwd_ckpt kernel (csrc/fb_counts.cu); outputs of
    counts_bwd_ckpt_plain."""
    return _bwd_cuda(True, T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink,
                     find, logZ)


def ckpt_backward_resources(device: torch.device, wp: int,
                            multi: bool = False) -> Dict[str, int]:
    """What a launch of counts_bwd_ckpt (multi: counts_multi_bwd_ckpt) at
    band width `wp` gets on `device`: registers per thread, shared memory
    per block (bytes), blocks resident per SM, threads per block and local
    memory per thread (bytes; spills)."""
    return _build.resources("counts_bwd_ckpt_info", device, int(multi), wp)


def ckpt_forward_resources(device: torch.device, wp: int, B: int,
                           ntr: int = 1, multi: bool = False
                           ) -> Dict[str, int]:
    """What a launch of counts_fwd_ckpt (multi: counts_multi_fwd_ckpt) of
    `ntr` trials over B lanes at band width `wp` gets on `device`: the keys
    of ckpt_backward_resources and the lanes a block, which csrc/common.cuh
    `warp_lanes` chooses from B x ntr, the SM count and the shared memory
    a block may take."""
    res = _build.resources("counts_fwd_ckpt_info", device, int(multi), ntr,
                           wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


def generic_resources(device: torch.device, wp: int, B: int,
                      backward: bool = False) -> Dict[str, int]:
    """What a launch of fb_generic_fwd (backward: fb_generic_bwd,
    ops/fb_generic_cuda.py) over B lanes at band width `wp` gets on
    `device`: the keys of ckpt_forward_resources."""
    res = _build.resources("fb_generic_info", device, int(backward), wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


def stored_resources(device: torch.device, wp: int, B: int, ntr: int = 1,
                     multi: bool = False, backward: bool = False
                     ) -> Dict[str, int]:
    """What a launch of counts_fwd_all (backward: counts_bwd; multi: their
    counts_multi_ instances) of `ntr` trials over B lanes at band width `wp`
    gets on `device`: the keys of ckpt_forward_resources."""
    res = _build.resources("counts_stored_info", device, int(backward),
                           int(multi), ntr, wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


def counts_multi_fwd_all_cuda(T, Em, Eg, xb, yb, valid, s1, start, fink):
    """The counts_multi_fwd_all kernel (csrc/fb_counts.cu); outputs of
    counts_multi_fwd_all_plain."""
    return _fwd_cuda(False, T, Em, Eg, xb, yb, valid, s1, fink, start)


def counts_multi_bwd_cuda(T, Em, Eg, f_all, lsf, xb, yb, valid, s1, start,
                          fink, find, L):
    """The counts_multi_bwd kernel (csrc/fb_counts.cu); outputs of
    counts_multi_bwd_plain."""
    return _bwd_cuda(False, T, Em, Eg, f_all, lsf, xb, yb, valid, s1, fink,
                     find, L, start)


def counts_multi_fwd_ckpt_cuda(T, Em, Eg, xb, yb, valid, s1, start, fink):
    """The counts_multi_fwd_ckpt kernel (csrc/fb_counts.cu); outputs of
    counts_multi_fwd_ckpt_plain."""
    return _fwd_cuda(True, T, Em, Eg, xb, yb, valid, s1, fink, start)


def counts_multi_bwd_ckpt_cuda(T, Em, Eg, ckpt, cs, xb, yb, valid, s1, start,
                               fink, find, L):
    """The counts_multi_bwd_ckpt kernel (csrc/fb_counts.cu); outputs of
    counts_multi_bwd_ckpt_plain."""
    return _bwd_cuda(True, T, Em, Eg, ckpt, cs, xb, yb, valid, s1, fink,
                     find, L, start)
