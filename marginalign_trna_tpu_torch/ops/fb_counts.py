"""Baum-Welch expected counts of a banded batch: the EM E-step.

Port of marginalign_trna_tpu/ops/fb_pallas_counts.py (`counts_pallas`,
`counts_pallas_trials`, `counts_pallas_multi`, `counts_pallas_multi_trials`,
`match_counts_from_posteriors(_multi)(_trials)`, `_use_ckpt`) and of the
E-step dispatch of marginalign_trna_tpu/ops/dispatch.py (`fb_counts`,
`fb_counts_trials`, `fb_counts_multi`, `fb_counts_multi_trials`), over
single-problem lanes (DeviceBatch) and multi-problem lanes
(MultiDeviceBatch, several problems per lane; logZ then per problem).  Two
kernel pairs compute the same counts (ops/fb_counts_cuda.py), each with a
single-lane and a multi-lane instance:

  stored   counts_fwd_all + counts_bwd: the forward stores every diagonal's
           five states, the backward writes the posterior match band, from
           which the match-emission counts are reduced here;
  ckpt     counts_fwd_ckpt + counts_bwd_ckpt: the forward stores one
           frontier per 8 diagonals and the backward recomputes each block,
           with the match counts folded in (no band is stored).

`use_ckpt` picks one the way the JAX package does.  CUDA tensors go through
the kernels, CPU tensors through their plain versions; the per-lane partials
are summed over the lanes and the transition partials multiplied by T here,
outside the kernels, as the TPU wrappers do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import fb_counts_cuda as K
from .dispatch import use_kernel
from .fb import (
    DeviceBatch, FbTables, MultiDeviceBatch, check_uniform_pi, multi_logz,
)

# The stored pair's bands (f_all and the posterior band) must fit this many
# MiB, else the checkpoint pair runs (the JAX package's
# MARGINALIGN_EM_STORED_BUDGET_MB default).
DEFAULT_STORED_BUDGET_MB = 6144
KERNEL_CHOICES = ("auto", "stored", "ckpt")


class CountsResult(NamedTuple):
    """Expected counts of one batch; with a trials axis every field has a
    leading [Ntr]."""

    logZ: torch.Tensor               # [B] ([P] on multi-problem lanes)
    posteriors: Optional[torch.Tensor]  # [D1, Wp, B] match posteriors
    #                                  (None on the checkpoint pair)
    trans_counts: torch.Tensor       # [5, 5] (from, to)
    emit_gap: torch.Tensor           # [5, 5] (state, code); row 0 zero
    emit_match: Optional[torch.Tensor] = None  # [5, 5] (ref, read); set
    #                                  when the kernels folded it in


def use_ckpt(xb_shape, ntr: int = 1, kernel: str = "auto",
             budget_mb: int = DEFAULT_STORED_BUDGET_MB) -> bool:
    """E-step kernel policy (marginalign_trna_tpu/ops/fb_pallas_counts.py
    `_use_ckpt`): "stored" / "ckpt" force a pair; "auto" takes the stored
    pair while its bands, (5 + 1) float32 per padded cell per trial, fit
    `budget_mb` MiB, else the checkpoint pair."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError("kernel must be one of %s, got %r"
                         % (KERNEL_CHOICES, kernel))
    if kernel != "auto":
        return kernel == "ckpt"
    d1, wp, b = xb_shape[-3], xb_shape[-2], xb_shape[-1]
    d1k = -(-d1 // K.STEP_BLOCK) * K.STEP_BLOCK
    stored_bytes = 6 * d1k * wp * b * 4 * ntr
    return stored_bytes > budget_mb * 1024 * 1024


def _pad_steps(a: torch.Tensor, d1k: int, fill: int = 0) -> torch.Tensor:
    pad = d1k - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])


def _check_trials_tables(tables: FbTables) -> int:
    if tables.T.dim() != 3:
        raise ValueError("trials tables must be stacked [Ntr, 5, 5] "
                         "(ops/fb.py tables_stacked)")
    check_uniform_pi(tables)
    return tables.T.shape[0]


def kernel_inputs(batch: DeviceBatch):
    """(xb, yb, valid, s1, fink, find) of a batch as the counts kernels take
    them: the streams padded with empty diagonals to d1k, a multiple of
    8."""
    d1k = -(-batch.xb.shape[0] // K.STEP_BLOCK) * K.STEP_BLOCK
    return tuple(_pad_steps(a, d1k)
                 for a in (batch.xb, batch.yb, batch.valid, batch.s1)) + (
        batch.final_k, batch.final_d)


def multi_kernel_inputs(mdev: MultiDeviceBatch):
    """(xb, yb, valid, s1, start, fink, find) of a multi-problem batch as
    the multi counts kernels take them: padded with empty diagonals to
    d1k, a multiple of 8, the per-diagonal fink and find with -1."""
    d1k = -(-mdev.xb.shape[0] // K.STEP_BLOCK) * K.STEP_BLOCK
    return tuple(_pad_steps(a, d1k) for a in (
        mdev.xb, mdev.yb, mdev.valid, mdev.s1, mdev.start)) + tuple(
        _pad_steps(a, d1k, -1) for a in (mdev.fink, mdev.find))


def logz_from_terminal(lsf: torch.Tensor, term: torch.Tensor,
                       final_d: torch.Tensor) -> torch.Tensor:
    """logZ [Ntr, B] from the forward's per-diagonal terminal sums and
    log-scales [Ntr, d1k, B], read at each lane's terminal diagonal."""
    lanes = torch.arange(lsf.shape[-1], device=lsf.device)
    fd = final_d.long()
    return (torch.log(torch.clamp(term[:, fd, lanes], min=1e-30))
            + lsf[:, fd, lanes])


# (checkpoint pair, multi-problem lanes) -> the kernels' (forward,
# backward) names in ops/fb_counts_cuda.py, without the _cuda / _plain
# suffix.
_PAIRS = {
    (False, False): ("counts_fwd_all", "counts_bwd"),
    (True, False): ("counts_fwd_ckpt", "counts_bwd_ckpt"),
    (False, True): ("counts_multi_fwd_all", "counts_multi_bwd"),
    (True, True): ("counts_multi_fwd_ckpt", "counts_multi_bwd_ckpt"),
}


def _counts(T: torch.Tensor, Em: torch.Tensor, Eg: torch.Tensor,
            batch, kernel: str, budget_mb: int) -> CountsResult:
    """The counts of stacked [Ntr, 5, 5] tables over a DeviceBatch or a
    MultiDeviceBatch."""
    ntr = T.shape[0]
    D1 = batch.xb.shape[0]
    multi = isinstance(batch, MultiDeviceBatch)
    if multi:
        *streams, fk, fd = multi_kernel_inputs(batch)
    else:
        *streams, fk, fd = kernel_inputs(batch)
    tabs = (T, Em, Eg)

    def normaliser(lsf, term):
        """(what the backward divides by, logZ): L and the per-problem
        logZ on multi-problem lanes, the per-lane logZ twice else."""
        if multi:
            return multi_logz(lsf, term, batch)
        logZ = logz_from_terminal(lsf, term, fd)
        return logZ, logZ

    ckpt = use_ckpt(batch.xb.shape, ntr, kernel, budget_mb)
    suffix = "_cuda" if use_kernel(batch.xb) else "_plain"
    fwd, bwd = (getattr(K, name + suffix) for name in _PAIRS[(ckpt, multi)])
    if ckpt:
        band, cs, lsf, term = fwd(*tabs, *streams, fk)
        norm, logZ = normaliser(lsf, term)
        tcp, egp, mcp = bwd(*tabs, band, cs, *streams, fk, fd, norm)
        post, emit_match = None, mcp.sum(dim=-1).reshape(ntr, 5, 5)
    else:
        f_all, lsf, term = fwd(*tabs, *streams, fk)
        norm, logZ = normaliser(lsf, term)
        post, tcp, egp = bwd(*tabs, f_all, lsf, *streams, fk, fd, norm)
        post, emit_match = post[:, :D1], None
    trans = tcp.sum(dim=-1).reshape(ntr, 5, 5) * T
    emit_gap = torch.cat([T.new_zeros((ntr, 1, 5)),
                          egp.sum(dim=-1).reshape(ntr, 4, 5)], dim=1)
    return CountsResult(logZ=logZ, posteriors=post, trans_counts=trans,
                        emit_gap=emit_gap, emit_match=emit_match)


def counts(tables: FbTables, batch, kernel: str = "auto",
           budget_mb: int = DEFAULT_STORED_BUDGET_MB) -> CountsResult:
    """Baum-Welch expected counts of one model ([5, 5] tables) over a
    DeviceBatch (`counts_pallas`) or a MultiDeviceBatch: the kernels with a
    trials axis of one."""
    check_uniform_pi(tables)
    res = _counts(tables.T[None], tables.Ematch[None], tables.Egap[None],
                  batch, kernel, budget_mb)
    return CountsResult(*(None if a is None else a[0] for a in res))


def counts_trials(tables: FbTables, batch, kernel: str = "auto",
                  budget_mb: int = DEFAULT_STORED_BUDGET_MB) -> CountsResult:
    """Expected counts of Ntr models (stacked [Ntr, 5, 5] tables) over one
    batch in one launch per kernel, the trials sharing the band streams
    (`counts_pallas_trials`): logZ [Ntr, B], counts [Ntr, 5, 5], posteriors
    [Ntr, D1, Wp, B] on the stored pair."""
    _check_trials_tables(tables)
    return _counts(tables.T, tables.Ematch, tables.Egap, batch, kernel,
                   budget_mb)


def counts_multi(tables: FbTables, mdev: MultiDeviceBatch,
                 kernel: str = "auto",
                 budget_mb: int = DEFAULT_STORED_BUDGET_MB) -> CountsResult:
    """Expected counts of one model over multi-problem lanes
    (`counts_pallas_multi`): logZ [P] per problem, the counts and the
    posterior band summed over every problem of the batch."""
    return counts(tables, mdev, kernel, budget_mb)


def counts_multi_trials(tables: FbTables, mdev: MultiDeviceBatch,
                        kernel: str = "auto",
                        budget_mb: int = DEFAULT_STORED_BUDGET_MB
                        ) -> CountsResult:
    """Lockstep trials over multi-problem lanes
    (`counts_pallas_multi_trials`): logZ [Ntr, P], counts [Ntr, 5, 5]."""
    return counts_trials(tables, mdev, kernel, budget_mb)


def _match_counts(post: torch.Tensor, xb: torch.Tensor,
                  yb: torch.Tensor) -> torch.Tensor:
    """[Ntr, 5, 5] match-emission counts (ref code, read code) of posterior
    bands [Ntr, D, Wp, B] over the codes xb, yb [D, Wp, B].  One masked sum
    per code pair, as the JAX package reduces them: unlike a scatter-add
    (atomics on the card), the sums come out the same on every run, and so
    does the trained model."""
    code = xb.long() * 5 + yb.long()
    zero = post.new_zeros(())
    return torch.stack([torch.where(code == c, post, zero).sum(dim=(1, 2, 3))
                        for c in range(25)], dim=1).reshape(-1, 5, 5)


def match_counts_from_posteriors_trials(post: torch.Tensor,
                                        batch: DeviceBatch) -> torch.Tensor:
    """[Ntr, 5, 5] match-emission counts from per-trial posterior bands
    [Ntr, D1, Wp, B]; the d = 0 boundary carries no emission."""
    D1 = post.shape[1]
    return _match_counts(post[:, 1:], batch.xb[1:D1], batch.yb[1:D1])


def match_counts_from_posteriors(post: torch.Tensor,
                                 batch: DeviceBatch) -> torch.Tensor:
    """[5, 5] match-emission counts from one posterior band [D1, Wp, B]."""
    return match_counts_from_posteriors_trials(post[None], batch)[0]


def match_counts_from_posteriors_multi_trials(
        post: torch.Tensor, mdev: MultiDeviceBatch) -> torch.Tensor:
    """[Ntr, 5, 5] match-emission counts over multi-problem lanes from
    per-trial posterior bands [Ntr, D1, Wp, B]: every problem's first
    diagonal (start != 0) carries no emission."""
    D1 = post.shape[1]
    keep = (mdev.start[:D1] == 0)[:, None, :]
    return _match_counts(torch.where(keep, post, post.new_zeros(())),
                         mdev.xb[:D1], mdev.yb[:D1])


def match_counts_from_posteriors_multi(post: torch.Tensor,
                                       mdev: MultiDeviceBatch
                                       ) -> torch.Tensor:
    """[5, 5] match-emission counts over multi-problem lanes from one
    posterior band [D1, Wp, B]."""
    return match_counts_from_posteriors_multi_trials(post[None], mdev)[0]


def fb_counts(tables: FbTables, batch: DeviceBatch):
    """(logZ [B], trans_counts, emit_match, emit_gap [5, 5]): the E-step of
    one model over one batch on the batch's device."""
    res = counts(tables, batch)
    em = (res.emit_match if res.emit_match is not None
          else match_counts_from_posteriors(res.posteriors, batch))
    return res.logZ, res.trans_counts, em, res.emit_gap


def fb_counts_trials(tables: FbTables, batch: DeviceBatch):
    """Lockstep EM trials: (logZ [Ntr, B], trans_counts, emit_match,
    emit_gap [Ntr, 5, 5]) of stacked tables over one batch."""
    res = counts_trials(tables, batch)
    em = (res.emit_match if res.emit_match is not None
          else match_counts_from_posteriors_trials(res.posteriors, batch))
    return res.logZ, res.trans_counts, em, res.emit_gap


def fb_counts_multi(tables: FbTables, mdev: MultiDeviceBatch):
    """(logZ [P], trans_counts, emit_match, emit_gap [5, 5]): the E-step of
    one model over a multi-problem batch on its device."""
    res = counts_multi(tables, mdev)
    em = (res.emit_match if res.emit_match is not None
          else match_counts_from_posteriors_multi(res.posteriors, mdev))
    return res.logZ, res.trans_counts, em, res.emit_gap


def fb_counts_multi_trials(tables: FbTables, mdev: MultiDeviceBatch):
    """Lockstep EM trials over a multi-problem batch: (logZ [Ntr, P],
    trans_counts, emit_match, emit_gap [Ntr, 5, 5])."""
    res = counts_multi_trials(tables, mdev)
    em = (res.emit_match if res.emit_match is not None
          else match_counts_from_posteriors_multi_trials(res.posteriors,
                                                          mdev))
    return res.logZ, res.trans_counts, em, res.emit_gap
