"""Pair-HMM model tables and banded device batches.

The band geometry (prefix coordinates, [D1, Wp, B] streams) is the JAX
package's, packed on the host by ops/band.py; this module
moves a packed batch and the model tables onto an explicit torch device.
State layout and model semantics are in models/hmm.py.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..models.hmm import PairHmm
from .band import BandedBatch, MultiBandedBatch, rel_to_circ_device


class FbTables(nn.Module):
    """Model tables as buffers (float32):
    T [5, 5] transitions (from, to), Ematch [5, 5] match emissions over codes
    (ref, read), Egap [5, 5] per-state single-base gap emissions, pi [5]
    start distribution.  Move with `.to(device)`."""

    def __init__(self, T, Ematch, Egap, pi, device=None):
        super().__init__()
        for name, val in (("T", T), ("Ematch", Ematch), ("Egap", Egap),
                          ("pi", pi)):
            self.register_buffer(
                name, torch.tensor(np.asarray(val, np.float32),
                                   device=device)
            )


def tables_from_hmm(hmm: PairHmm, device=None) -> FbTables:
    return FbTables(
        T=hmm.transitions,
        Ematch=hmm.match_emissions_5x5(),
        Egap=hmm.gap_emissions_5(),
        pi=np.full(5, 0.2),
        device=device,
    )


def tables_from_file(path: str, device=None) -> FbTables:
    """Tables of a model file (the format of models/hmm.py)."""
    return tables_from_hmm(PairHmm.load(path), device)


def tables_stacked(hmms: Sequence[PairHmm], device=None) -> FbTables:
    """Tables of several models with a leading [Ntr] trials axis on every
    buffer (T, Ematch, Egap [Ntr, 5, 5], pi [Ntr, 5]): the lockstep EM
    trials' tables (marginalign_trna_tpu/align/em.py
    `make_tables_stacked`)."""
    return FbTables(
        T=np.stack([h.transitions for h in hmms]),
        Ematch=np.stack([h.match_emissions_5x5() for h in hmms]),
        Egap=np.stack([h.gap_emissions_5() for h in hmms]),
        pi=np.full((len(hmms), 5), 0.2),
        device=device,
    )


def tables_from_jax(np_tables, device=None) -> FbTables:
    """The port's tables from the JAX package's FbTables (any object with
    T/Ematch/Egap/pi array fields, e.g. after `jax.device_get`), so both
    packages compute with identical float32 values.  Stacked trials tables
    ([Ntr, 5, 5] leaves, the JAX package's `make_tables_stacked`) carry
    over the same way."""
    return FbTables(
        T=np_tables.T, Ematch=np_tables.Ematch, Egap=np_tables.Egap,
        pi=np_tables.pi, device=device,
    )


def check_uniform_pi(tables: FbTables) -> None:
    """The kernels bake the uniform start distribution (1/5) into their
    start injection and logZ; a model file carries no start distribution, so
    pi is uniform everywhere today.  Fail loudly on anything else."""
    pi = tables.pi.detach().cpu().numpy()
    if not np.allclose(pi, 1.0 / pi.shape[-1], atol=1e-6):
        raise NotImplementedError(
            "the forward-backward kernels assume a uniform start "
            "distribution (got pi=%s)" % pi.tolist()
        )


class DeviceBatch(NamedTuple):
    """BandedBatch streams as tensors on one device (see ops/band.py):
    xb, yb int8 [D1, Wp, B]; valid bool [D1, Wp, B]; s1, s2 int32 [D1, B];
    final_d, final_k int32 [B]."""

    xb: torch.Tensor
    yb: torch.Tensor
    valid: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    final_d: torch.Tensor
    final_k: torch.Tensor


def shift(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[k] = a[k + t] per lane for t in {-1, 0, 1}; a is [..., Wp, B], t
    is [B].  Circular, like the kernels: wrapped rows land in guard rows,
    which `valid` masks."""
    up = torch.roll(a, -1, dims=-2)    # out[k] = a[k + 1]
    down = torch.roll(a, 1, dims=-2)   # out[k] = a[k - 1]
    return torch.where(t == 1, up, torch.where(t == -1, down, a))


def device_batch(batch: BandedBatch, device) -> DeviceBatch:
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return DeviceBatch(
        xb=up(batch.xb, np.int8),
        yb=up(batch.yb, np.int8),
        valid=up(batch.valid, np.bool_),
        s1=up(batch.s1, np.int32),
        s2=up(batch.s2, np.int32),
        final_d=up(batch.final_d, np.int32),
        final_k=up(batch.final_k, np.int32),
    )


class CircDeviceBatch(NamedTuple):
    """A BandedBatch's code and valid streams in the circular layout
    (marginalign_trna_tpu/ops/fb.py `CircDeviceBatch`) as tensors on one
    device: xb, yb int8 [D1, Wp, B]; valid bool [D1, Wp, B]; final_d [B]
    int32; fink [B] int32, the terminal cell's circular row m mod Wp; lo
    [D1, B] int32, the band offsets that rotate between the layouts."""

    xb: torch.Tensor
    yb: torch.Tensor
    valid: torch.Tensor
    final_d: torch.Tensor
    fink: torch.Tensor
    lo: torch.Tensor


def circ_device_batch(batch: BandedBatch, dev: DeviceBatch) -> CircDeviceBatch:
    """The circular streams of `batch` (ops/band.py `circular_streams`),
    rotated on the device from dev = device_batch(batch, device)."""
    lo = torch.from_numpy(np.ascontiguousarray(batch.lo, np.int32)).to(
        dev.xb.device)
    fink = torch.from_numpy((batch.m % batch.xb.shape[1]).astype(np.int32))
    return CircDeviceBatch(
        xb=rel_to_circ_device(dev.xb, lo), yb=rel_to_circ_device(dev.yb, lo),
        valid=rel_to_circ_device(dev.valid, lo), final_d=dev.final_d,
        fink=fink.to(dev.xb.device), lo=lo,
    )


class MultiDeviceBatch(NamedTuple):
    """A MultiBandedBatch's streams (ops/band.py) as tensors on one device
    (marginalign_trna_tpu/ops/fb_pallas.py `MultiDeviceBatch`), with the
    band offsets and local diagonals the MEA weights and the caller's sums
    read: xb, yb int8 [D1, Wp, B]; valid bool [D1, Wp, B]; s1, s2, find,
    fink, step_final, lo, dloc int32 [D1, B]; start int8 [D1, B]; per
    problem p_final_d, p_lane, p_d0 int32 [P]."""

    xb: torch.Tensor
    yb: torch.Tensor
    valid: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    start: torch.Tensor
    find: torch.Tensor
    fink: torch.Tensor
    step_final: torch.Tensor
    lo: torch.Tensor
    dloc: torch.Tensor
    p_final_d: torch.Tensor
    p_lane: torch.Tensor
    p_d0: torch.Tensor


def multi_logz(lsf: torch.Tensor, term: torch.Tensor,
               mdev: MultiDeviceBatch):
    """(L, logZ) of a multi-problem forward from its log-scales and
    terminal sums [..., D1, B] (any leading axes, e.g. trials; D1 may be
    padded past the batch's): logterm = log(term) + lsf, L [..., D1, B]
    logterm at the terminal diagonal of the problem owning each diagonal
    (the `step_final` gather; padded diagonals read diagonal 0), and each
    problem's logZ [..., P] = logterm at its terminal diagonal less the
    lane's log-scale just before its first diagonal (the JAX package's
    arithmetic, marginalign_trna_tpu/ops/fb_pallas_counts.py :784-791)."""
    logterm = torch.log(torch.clamp(term, min=1e-30)) + lsf
    sf = mdev.step_final.long()
    pad = lsf.shape[-2] - sf.shape[0]
    if pad:
        sf = torch.cat([sf, sf.new_zeros((pad, sf.shape[1]))])
    L = logterm.gather(-2, sf.expand(logterm.shape))
    lane = mdev.p_lane.long()
    d0 = mdev.p_d0.long()
    base = torch.where(d0 > 0, lsf[..., (d0 - 1).clamp(min=0), lane], 0.0)
    return L, logterm[..., mdev.p_final_d.long(), lane] - base


def multi_device_batch(mb: MultiBandedBatch, device) -> MultiDeviceBatch:
    """Upload a MultiBandedBatch (fb_pallas.py `multi_device_batch`)."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return MultiDeviceBatch(
        xb=up(mb.xb, np.int8), yb=up(mb.yb, np.int8),
        valid=up(mb.valid, np.bool_), s1=up(mb.s1, np.int32),
        s2=up(mb.s2, np.int32), start=up(mb.start, np.int8),
        find=up(mb.find, np.int32), fink=up(mb.fink_steps, np.int32),
        step_final=up(mb.step_final, np.int32), lo=up(mb.lo, np.int32),
        dloc=up(mb.dloc, np.int32), p_final_d=up(mb.final_d, np.int32),
        p_lane=up([p.lane for p in mb.problems], np.int32),
        p_d0=up([p.d0 for p in mb.problems], np.int32),
    )
