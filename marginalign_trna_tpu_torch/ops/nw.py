"""Banded affine-gap Viterbi alignment (the guide alignment kernel).

Port of marginalign_trna_tpu/ops/nw.py: after host-side k-mer seeding and
chaining picks a corridor, a banded 3-state (match / ref-gap / read-gap)
max-plus wavefront aligns every read against its reference window in one
batch, one read per lane (`banded_nw`) or several short ones per lane
(`banded_nw_multi`, ops/band.py `pack_multi_banded_batch`).  Pointers
come back to the host as a [D1, Wp, B] uint8 band and the cigar is
recovered by the native host traceback (native/margin_native.cpp).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import native as _native
from .band import BandedBatch, MultiBandedBatch
from .dispatch import use_kernel
from .fb import DeviceBatch, MultiDeviceBatch
from .wavefront_cuda import (
    _max_argmax3, banded_nw_cuda, banded_nw_plain, nw_multi_cuda,
    nw_multi_plain,
)

# State indices.
S_M, S_IX, S_IY = 0, 1, 2  # match, gap-in-read (ref advances), gap-in-ref


class NwParams(NamedTuple):
    match: float = 1.0
    mismatch: float = -2.0
    gap_open: float = -3.0
    gap_extend: float = -1.0


class NwResult(NamedTuple):
    pointers: torch.Tensor     # [D1, Wp, B] uint8 (ptrM | ptrIx<<2 | ptrIy<<3)
    score: torch.Tensor        # [B] ([P] over multi lanes) score at (m, n)
    final_state: torch.Tensor  # [B] ([P]) int32 argmax state at (m, n)


def banded_nw(params: NwParams, batch: DeviceBatch) -> NwResult:
    """The CUDA kernel for a batch on a CUDA device, the plain version for
    a batch on the CPU."""
    fn = banded_nw_cuda if use_kernel(batch.xb) else banded_nw_plain
    return NwResult(*fn(params, batch.xb, batch.yb, batch.valid, batch.s1,
                        batch.s2, batch.final_d, batch.final_k))


def banded_nw_multi(params: NwParams, mdev: MultiDeviceBatch) -> NwResult:
    """Guide Viterbi over multi-problem lanes
    (marginalign_trna_tpu/ops/wavefront_pallas.py `banded_nw_pallas_multi`):
    the pointer band and each problem's score and final state [P], the
    first of the M / X / Y terminal scores that is largest.  The nw_multi
    kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = nw_multi_cuda if use_kernel(mdev.xb) else nw_multi_plain
    ptr, term = fn(params, mdev.xb, mdev.yb, mdev.valid, mdev.s1, mdev.s2,
                   mdev.start, mdev.fink, mdev.find)
    t = term[:, mdev.p_final_d.long(), mdev.p_lane.long()]    # [3, P]
    score, state = _max_argmax3(t[0], t[1], t[2])
    return NwResult(ptr, score, state.to(torch.int32))


def traceback_multi(
    pointers: np.ndarray, mb: MultiBandedBatch, p: int,
    final_state: int = S_M,
) -> List[Tuple[int, int]]:
    """Traceback for problem p of a multi-problem batch: the problem's step
    range and lane slice out to an ordinary single-problem view."""
    pr = mb.problems[p]
    ptr = np.ascontiguousarray(
        pointers[pr.d0 : pr.final_d + 1, :, pr.lane : pr.lane + 1]
    )
    lo = np.ascontiguousarray(mb.lo[pr.d0 : pr.final_d + 1, pr.lane])
    return _traceback_arrays(ptr, lo, 0, pr.m, pr.n, final_state)


def traceback(
    pointers: np.ndarray,
    batch: BandedBatch,
    b: int,
    final_state: int = S_M,
) -> List[Tuple[int, int]]:
    """Host traceback for read b: aligned ops [(op, len)] with 0=M,
    1=I (read), 2=D (ref) from (0,0) to (m,n).  pointers is the host
    [D1, Wp, B] uint8 band (C-contiguous)."""
    m, n = int(batch.m[b]), int(batch.n[b])
    return _traceback_arrays(pointers, batch.lo[:, b], b, m, n, final_state)


def _traceback_arrays(
    pointers: np.ndarray,
    lo: np.ndarray,
    b: int,
    m: int,
    n: int,
    final_state: int,
) -> List[Tuple[int, int]]:
    nat = _native.nw_traceback(pointers, lo, b, m, n, final_state)
    if nat is not None:
        return nat
    i, j = m, n
    state = final_state
    ops_rev: List[int] = []
    while not (i == 0 and j == 0):
        d = i + j
        k = i - int(lo[d])
        p = int(pointers[d, k, b])
        if state == S_M:
            if i == 0 or j == 0:
                # Degenerate: fall back to gap states along the edge.
                state = S_IX if i == 0 else S_IY
                continue
            ops_rev.append(0)
            state = p & 0b11
            i -= 1
            j -= 1
        elif state == S_IX:
            ops_rev.append(2)  # deletion in read (ref consumed)
            state = S_M if ((p >> 2) & 1) == 0 else S_IX
            j -= 1
        else:
            ops_rev.append(1)  # insertion in read
            state = S_M if ((p >> 3) & 1) == 0 else S_IY
            i -= 1
        assert i >= 0 and j >= 0, "traceback escaped the grid"
    ops_rev.reverse()
    out: List[Tuple[int, int]] = []
    for op in ops_rev:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out
