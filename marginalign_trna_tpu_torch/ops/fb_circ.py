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

Beside them, the unfused circular serving route
(marginalign_trna_tpu/ops/fb_pallas.py `posteriors_pallas_circ`), which
the host-packed band arrays take once uploaded and rotated into the
circular layout on the device (ops/fb.py `circ_device_batch`):
`posteriors_circ` gives logZ and the circular posterior band in one of
five modes, the stream diets of the TPU kernels, all computing the same
posteriors (`posteriors_serve` rotates the band back to the band-relative
layout for the MEA decode and the caller's sums):

  sv    the emission pass (`emission_stream`, plain torch) writes the
        signed stream es; S, then circ_post_es;
  em    the emission pass writes the premasked emission stream em;
        circ_backward_emv, then circ_post_emv (both read em and valid);
  lean  both kernels look emissions up from the code streams:
        circ_backward_codes, then circ_post_codes;
  emw   circ_backward_codes also writes es (circ_backward_codes_es), then
        circ_post_es;
  ckpt  lean without a stored backward band: circ_ckpt_backward writes a
        frontier checkpoint per block of diagonals, circ_ckpt_post replays
        each block's backward from it before its forward.

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
from .band import (
    BandedBatch, CompactBandedBatch, circ_mw_streams, circ_to_rel_device,
    padded_band_width,
)
from .dispatch import use_kernel
from .fb import (
    CircDeviceBatch, DeviceBatch, FbTables, check_uniform_pi,
    circ_device_batch,
)
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
    """(coef float32 [N_COEF], chain) for the flat-gap kernels of the
    circular layout and of multi-problem lanes.  Products
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
        coef[K.COEF_K:K.COEF_K + 4] = ch.k
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


# The unfused serving route's modes (marginalign_trna_tpu/ops/fb_pallas.py
# `posteriors_pallas_circ`, MARGINALIGN_CIRC_SERVE there).
SERVE_MODES = ("sv", "em", "lean", "emw", "ckpt")


def check_serve(serve: Optional[str]) -> None:
    """Raise ValueError unless `serve` is None or one of SERVE_MODES."""
    if serve is not None and serve not in SERVE_MODES:
        raise ValueError("serve must be None or one of %s, got %r"
                         % (", ".join(SERVE_MODES), serve))


def emission_stream(table, xb: torch.Tensor, yb: torch.Tensor,
                    valid: torch.Tensor, signed: bool) -> torch.Tensor:
    """The emission pass of modes "sv" and "em" (fb_pallas.py
    `_precompute_ematch` and its masking), plain torch ops on the streams'
    device: e = Ematch[xb, yb] * valid, or with `signed`
    es = e - (1 - valid), whose sign carries the validity."""
    em = K.lookup_emissions(K.emission_table(table, xb.device), xb, yb)
    vf = valid.float()
    return em * vf - (1.0 - vf) if signed else em * vf


def posteriors_circ(tables: FbTables, cdev: CircDeviceBatch,
                    mode: str = "sv"):
    """(logZ [B], posterior band [D1, Wp, B] in the circular layout) of a
    flat-gap model over circular streams, in serving mode `mode`
    (SERVE_MODES; module docstring): the kernels for CUDA tensors, their
    plain versions for CPU tensors.  Raises ValueError for an unknown mode
    or a model whose gap emissions are not flat."""
    check_serve(mode)
    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.detach().cpu().numpy().reshape(-1)
    suffix = "_cuda" if use_kernel(cdev.xb) else "_plain"

    def kernel(name):
        return getattr(K, name + suffix)

    xb, yb, fink, find = cdev.xb, cdev.yb, cdev.fink, cdev.final_d
    valid = cdev.valid.view(torch.int8)
    if mode == "sv":
        es = emission_stream(table, xb, yb, cdev.valid, True)
        bm, bls, logZ = kernel("sv_backward")(coef, chain, es, fink, find)
        post = kernel("circ_post_es")(coef, chain, es, bm, bls, logZ)
    elif mode == "em":
        em = emission_stream(table, xb, yb, cdev.valid, False)
        bm, bls, logZ = kernel("circ_backward_emv")(coef, chain, em, valid,
                                                    fink, find)
        post = kernel("circ_post_emv")(coef, chain, em, valid, bm, bls, logZ)
    elif mode == "lean":
        bm, bls, logZ = kernel("circ_backward_codes")(
            coef, chain, table, xb, yb, valid, fink, find)
        post = kernel("circ_post_codes")(coef, chain, table, xb, yb, valid,
                                         bm, bls, logZ)
    elif mode == "emw":
        bm, bls, logZ, es = kernel("circ_backward_codes_es")(
            coef, chain, table, xb, yb, valid, fink, find)
        post = kernel("circ_post_es")(coef, chain, es, bm, bls, logZ)
    else:
        kb = K.ckpt_block(xb.shape[1])
        ck, cs, logZ = kernel("circ_ckpt_backward")(
            coef, chain, table, xb, yb, valid, fink, find, kb)
        post = kernel("circ_ckpt_post")(coef, chain, table, xb, yb, valid,
                                        fink, find, ck, cs, logZ, kb)
    return logZ, post


def posteriors_serve(tables: FbTables, batch: BandedBatch, dev: DeviceBatch,
                     mode: str):
    """(logZ [B], posterior band [D1, Wp, B] in the band-relative layout)
    of the serving route in mode `mode` over `batch`, uploaded as
    dev = ops/fb.py device_batch(batch, device): the streams rotated into
    the circular layout, `posteriors_circ`, the band rotated back, all on
    dev's device."""
    cdev = circ_device_batch(batch, dev)
    logZ, post = posteriors_circ(tables, cdev, mode)
    return logZ, circ_to_rel_device(post, cdev.lo)
