"""The pair-HMM passes over compact batches.

Port of marginalign_trna_tpu/ops/fb_pallas.py's compact serving
(`CompactCircBatch`, `compact_device_batch`, `expand_rel_codes`,
`posteriors_expectations_pallas_compact`,
`posteriors_weights_pallas_compact`): the host uploads only packed
sequences and band offsets (ops/band.py `pack_compact_batch`) and every
band-shaped stream derives on the device.

  guide      the band-relative code bands of the Viterbi (R);
  caller     the band streams (E), the scaled backward from them (S) and a
             forward that accumulates per-reference-position expected base
             counts without writing a posterior band (C);
  realign    E (no read-code stream), S, and a forward that writes the
             band-relative posterior band and the row / column posterior
             sums of the MEA gap weights (M).

The kernels and their plain versions are in ops/fb_circ_cuda.py; CUDA
tensors go through the kernels, CPU tensors through the plain versions.

The model reaches the kernels as one coefficient vector in one of two
forms: the gap-chain form (`_gap_chain_consts`, every shipped model) or the
generic 5x5 mix.  Only flat-gap models run here (ops/fb_cuda.py
`require_flat_gaps`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import fb_circ_cuda as K
from .band import CompactBandedBatch, circ_mw_streams, padded_band_width
from .dispatch import use_kernel
from .fb import FbTables, check_uniform_pi
from .fb_cuda import require_flat_gaps, static_tables

STEP_BLOCK = 8  # the TPU kernels' diagonals per grid step; d1k rounds to it


class _GapChain(NamedTuple):
    """Scaled gap-state constants, indexed by gap state - 1 (states 1..4)."""

    k: Tuple[float, ...]      # stored fwd f'[t] = f[t] / k[t]
    c: Tuple[float, ...]      # fwd self coefficient: g_t = f0 + c[t] f'[t]
    mcoef: Tuple[float, ...]  # f'[t] coefficient in the fwd match mix
    r: Tuple[float, ...]      # bwd injection constant (b'[t] = b[t] r[t])
    cb: Tuple[float, ...]     # bwd self coefficient
    m0: Tuple[float, ...]     # q'[t] coefficient in the bwd match row


def _gap_chain_consts(st, gc) -> Optional[_GapChain]:
    """Constants of the scaled gap-state representation, available when
    every gap state exchanges mass only with the match state and itself
    (T[s][t] = T[t][s] = 0 for gap s != t, M<->t transitions nonzero), as
    in every cPecan model family.  Each gap mix is then one multiply and
    one add:
      forward   f'[t]_d = roll(f0 + c_t f'[t])_{d-1} * valid,
                with true f[t] = (gc_t T[0][t]) f'[t]
      backward  b'[t]_d = (q0 + cb_t q'[t]) * valid,
                with true b[t] = b'[t] / r_t, r_t = 1 / T[t][0]
    (marginalign_trna_tpu/ops/fb_pallas.py `_gap_chain_consts`)."""
    T = st[0]
    for t in range(1, 5):
        if T[0][t] <= 0.0 or T[t][0] <= 0.0:
            return None
        for s in range(1, 5):
            if s != t and (T[s][t] != 0.0 or T[t][s] != 0.0):
                return None
    k = tuple(gc[t - 1] * T[0][t] for t in range(1, 5))
    return _GapChain(
        k=k,
        c=tuple(gc[t - 1] * T[t][t] for t in range(1, 5)),
        mcoef=tuple(T[t][0] * k[t - 1] for t in range(1, 5)),
        r=tuple(1.0 / T[t][0] for t in range(1, 5)),
        cb=tuple(gc[t - 1] * T[t][t] for t in range(1, 5)),
        m0=tuple(gc[t - 1] * T[0][t] * T[t][0] for t in range(1, 5)),
    )


def circ_coefficients(tables: FbTables) -> Tuple[np.ndarray, bool]:
    """(coef float32 [N_COEF], chain) for the S and C kernels.  Products
    are taken in float64 and rounded once to float32, as the TPU kernels
    bake them.  Raises for models whose gap emissions are not flat."""
    st = static_tables(tables)
    gc = require_flat_gaps(st)
    check_uniform_pi(tables)
    T = st[0]
    coef = np.zeros(K.N_COEF, np.float64)
    coef[K.COEF_A:K.COEF_A + 25] = [
        T[s][u] * (1.0 if u == 0 else gc[u - 1])
        for s in range(5) for u in range(5)
    ]
    ch = _gap_chain_consts(st, gc)
    if ch is not None:
        coef[K.COEF_T00] = T[0][0]
        coef[K.COEF_M0:K.COEF_M0 + 4] = ch.m0
        coef[K.COEF_CB:K.COEF_CB + 4] = ch.cb
        coef[K.COEF_R:K.COEF_R + 4] = ch.r
        coef[K.COEF_TZ:K.COEF_TZ + 4] = [T[s][0] for s in range(1, 5)]
        coef[K.COEF_PI:K.COEF_PI + 4] = [0.2 / k for k in ch.k]
        coef[K.COEF_MC:K.COEF_MC + 4] = ch.mcoef
        coef[K.COEF_C:K.COEF_C + 4] = ch.c
    return coef.astype(np.float32), ch is not None


class CompactCircBatch(NamedTuple):
    """A CompactBandedBatch's arrays as tensors on one device."""

    reads: torch.Tensor    # [Mp, B] int8 packed read codes
    refs: torch.Tensor     # [Np, B] int8 packed ref codes
    lo: torch.Tensor       # [D1, B] int32 (edge-replicated)
    m: torch.Tensor        # [B] int32
    n: torch.Tensor        # [B] int32
    final_d: torch.Tensor  # [B] int32
    final_k: torch.Tensor  # [B] int32 terminal band-relative row
    fink: torch.Tensor     # [B] int32 terminal circular row (m mod Wp)


def compact_device_batch(cb: CompactBandedBatch, device) -> CompactCircBatch:
    """Upload a CompactBandedBatch (sequences and offsets only)."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CompactCircBatch(
        reads=up(cb.reads_p), refs=up(cb.refs_p),
        lo=up(cb.lo.astype(np.int32)), m=up(cb.m.astype(np.int32)),
        n=up(cb.n.astype(np.int32)), final_d=up(cb.final_d.astype(np.int32)),
        final_k=up(cb.final_k.astype(np.int32)),
        fink=up((cb.m.astype(np.int64) % cb.wp).astype(np.int32)),
    )


def _steps(comp: CompactCircBatch) -> int:
    """d1k: the diagonals rounded up to the TPU kernels' step block."""
    return -(-comp.lo.shape[0] // STEP_BLOCK) * STEP_BLOCK


def expand_rel_codes(comp: CompactCircBatch, Wp: int, steps: int):
    """(xb, yb) [steps, Wp, B] int8 band-relative code bands of the guide
    Viterbi, expanded from the compact batch on its device (R); equal to
    pack_banded_batch's xb / yb at every in-band cell."""
    fn = K.expand_rel_cuda if use_kernel(comp.lo) else K.expand_rel_plain
    return fn(comp.reads, comp.refs, comp.lo, comp.m, comp.n, Wp, steps)


def posteriors_expectations_compact(tables: FbTables, comp: CompactCircBatch,
                                    width: int):
    """(logZ [B], fl [4, d1k, B], tails [4, Wp, B]) of the fused caller
    pass: fl[c, d, b] is the expected count of read code c at the reference
    position that completes at diagonal d of lane b, tails what the
    accumulators hold after the last diagonal (assemble with
    ops/expectations.py `band_expectations_cx`)."""
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.detach().cpu().numpy().reshape(-1)
    Wp = padded_band_width(width)
    d1k = _steps(comp)
    if use_kernel(comp.lo):
        expand, backward, forward = (K.expand_streams_cuda,
                                     K.sv_backward_cuda, K.cx_forward_cuda)
    else:
        expand, backward, forward = (K.expand_streams_plain,
                                     K.sv_backward_plain, K.cx_forward_plain)
    es, yb, fr = expand(ematch, comp.reads, comp.refs, comp.lo, comp.m,
                        comp.n, width, Wp, d1k)
    bm, bls, logZ = backward(coef, chain, es, comp.fink, comp.final_d)
    fl, tails = forward(coef, chain, es, yb, fr, bm, bls, logZ)
    return logZ, fl, tails


def posteriors_weights_compact(tables: FbTables, comp: CompactCircBatch,
                               width: int):
    """(logZ [B], post [D1, Wp, B], flc / flr [d1k, B], tc / tr [Wp, B])
    of the fused realign pass: the posterior band in the band-relative
    layout and the flushed column / row posterior sums with their tails
    (assemble with ops/mea.py `rowcol_sums_from_flushed`)."""
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.detach().cpu().numpy().reshape(-1)
    Wp = padded_band_width(width)
    D1 = comp.lo.shape[0]
    d1k = _steps(comp)
    if use_kernel(comp.lo):
        expand, backward, forward = (K.expand_streams_cuda,
                                     K.sv_backward_cuda, K.mw_forward_cuda)
    else:
        expand, backward, forward = (K.expand_streams_plain,
                                     K.sv_backward_plain, K.mw_forward_plain)
    es, _, _ = expand(ematch, comp.reads, comp.refs, comp.lo, comp.m,
                      comp.n, width, Wp, d1k, False)    # no yb stream
    fr, frr, lom = circ_mw_streams(comp.lo, width, Wp, d1k)
    bm, bls, logZ = backward(coef, chain, es, comp.fink, comp.final_d)
    post, flc, flr, tc, tr = forward(coef, chain, es, fr, frr, lom, bm, bls,
                                     logZ)
    return logZ, post[:D1], flc, flr, tc, tr
