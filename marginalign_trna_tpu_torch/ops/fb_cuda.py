"""Flat-gap pair-HMM forward-backward posteriors: the CUDA kernel pair
(csrc/fb.cu) and its plain PyTorch version.

Port of marginalign_trna_tpu/ops/fb_pallas.py `_posteriors_pre`, the
backward-first specialisation for models whose gap states emit flat
probabilities (every shipped and normalised model):

  1. the match emission band is precomputed by indexing (`Ematch[xb, yb]`,
     premasked by valid), and gap emissions fold into the transition
     coefficients A[s][u] = T[s][u] * g_u;
  2. fb_backward runs the scaled backward from the terminal cell, storing
     the match-state band bm, the per-diagonal cumulative log-scale bls and
     logZ (the backward alone yields it at the origin);
  3. fb_forward runs the scaled forward and writes the normalised posterior
     match band directly.

Scaling is the TPU kernels': rescale by the band max every 8 diagonals
(backward at d % 8 == 0, forward at d % 8 == 7), factor 1 for a step with no
mass, and the d-2 term divided by the previous factor on the diagonal after
a rescale.  The plain versions follow the kernels' arithmetic step for step.

Models whose gap emissions are not flat run through the generic pair
(ops/fb_generic_cuda.py); `posteriors_specialised` picks the pair by model,
as the JAX package's `posteriors_pallas_specialised` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from ._build import check_tensor
from .dispatch import use_kernel
from .fb import DeviceBatch, FbTables, check_uniform_pi, shift
from .fb_generic_cuda import posteriors_generic

_NSTATE = 5
_RESCALE_PERIOD = 8
_TINY = 1e-30


def static_tables(tables: FbTables):
    """(T, Ematch, Egap) as nested float tuples (host values)."""
    tup = lambda a: tuple(tuple(float(v) for v in row) for row in a)  # noqa: E731
    return (
        tup(tables.T.detach().cpu().numpy()),
        tup(tables.Ematch.detach().cpu().numpy()),
        tup(tables.Egap.detach().cpu().numpy()),
    )


def _flat_gap_consts(st) -> Optional[Tuple[float, float, float, float]]:
    """Per-gap-state constant emission values when every gap row is flat,
    else None."""
    consts = []
    for s in range(1, _NSTATE):
        row = st[2][s]
        if len(set(row)) != 1:
            return None
        consts.append(row[0])
    return tuple(consts)


def require_flat_gaps(st) -> Tuple[float, float, float, float]:
    """The flat gap emissions of static tables `st`, which the flat-gap
    kernels fold into their coefficients; raises ValueError for a model
    whose gap rows are not flat (the generic pair runs those:
    `posteriors_specialised` routes by model)."""
    gc = _flat_gap_consts(st)
    if gc is None:
        raise ValueError(
            "the flat-gap forward-backward kernels take only models whose "
            "gap emissions are flat; run this model through the generic "
            "pair (ops/fb_generic_cuda.py posteriors_generic, or "
            "ops/fb_cuda.py posteriors_specialised, which routes by model)"
        )
    return gc


def has_flat_gap_emissions(tables: FbTables) -> bool:
    """True when every gap state's emission row is flat: the premise of the
    flat-gap kernels, which fold gap emissions into the transition
    coefficients.  EM-trained models mid-training are generically
    non-flat."""
    return _flat_gap_consts(static_tables(tables)) is not None


def _coefficients(st, gc) -> np.ndarray:
    """A[s][u] = T[s][u] * g_u (g_0 = 1, g_u = flat emission of gap state
    u), products in float64 rounded once to float32 as the TPU kernels bake
    them."""
    T = st[0]
    return np.array(
        [[T[s][u] * (1.0 if u == 0 else gc[u - 1]) for u in range(_NSTATE)]
         for s in range(_NSTATE)],
        np.float32,
    )


def _precompute_ematch(tables: FbTables, xb: torch.Tensor,
                       yb: torch.Tensor) -> torch.Tensor:
    """[D1, Wp, B] float32 match emissions Ematch[xb, yb]."""
    return tables.Ematch[xb.long(), yb.long()]


# ------------------------------------------------------------------ backward


def fb_backward_plain(coef: np.ndarray, ematch, valid, s1, final_d, final_k):
    """Plain version of the fb_backward kernel: (bm [D1, Wp, B],
    bls [D1, B], logZ [B])."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    A = [[float(coef[s, u]) for u in range(_NSTATE)] for s in range(_NSTATE)]
    kr = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    gaps = [zero] * 4            # gap states at d+1
    p1 = p2 = zero               # e_M * b_M at d+1, d+2
    bls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)
    sh1 = sh2 = torch.zeros(B, dtype=torch.int32, device=dev)
    bm = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    bls_out = torch.empty((D1, B), dtype=torch.float32, device=dev)
    fk = final_k.long()[None, :]
    new = [zero] * _NSTATE
    for d in range(D1 - 1, -1, -1):
        s1n, s2n = sh1, sh1 + sh2
        q = [shift(p2, 1 - s2n), shift(gaps[0], -s1n),
             shift(gaps[1], 1 - s1n), shift(gaps[2], -s1n),
             shift(gaps[3], 1 - s1n)]
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            q[0] = q[0] / cprev
        inj = ((kr == fk) & (final_d == d)[None, :]).float()
        v = valid[d].float()
        new = []
        for s in range(_NSTATE):
            acc = A[s][0] * q[0]
            for u in range(1, _NSTATE):
                acc = acc + A[s][u] * q[u]
            new.append((acc + inj) * v)
        sh2, sh1 = sh1, s1[d]
        if d % _RESCALE_PERIOD == 0:
            bmax = torch.stack(new).amax(dim=(0, 1))
            c = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
            inv = 1.0 / c
            new = [x * inv for x in new]
            bls = bls + torch.log(c)
            cprev = c
        bm[d] = new[0]
        bls_out[d] = bls
        p2, p1 = p1, ematch[d] * new[0]
        gaps = new[1:]
    z = 0.2 * ((((new[0][0] + new[1][0]) + new[2][0]) + new[3][0])
               + new[4][0])
    logZ = torch.log(torch.clamp(z, min=_TINY)) + bls
    return bm, bls_out, logZ


def fb_backward_cuda(coef: np.ndarray, ematch, valid, s1, final_d, final_k):
    """The fb_backward kernel (csrc/fb.cu); same outputs as the plain
    version."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    check_tensor(ematch, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    check_tensor(s1, torch.int32, (D1, B), dev)
    check_tensor(final_d, torch.int32, (B,), dev)
    check_tensor(final_k, torch.int32, (B,), dev)
    bm = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    bls = torch.empty((D1, B), dtype=torch.float32, device=dev)
    logZ = torch.empty((B,), dtype=torch.float32, device=dev)
    c = np.ascontiguousarray(coef, np.float32)
    _build.launch(
        "fb_backward", dev, valid.data_ptr(), ematch.data_ptr(),
        s1.data_ptr(), final_d.data_ptr(), final_k.data_ptr(), c.ctypes.data,
        D1, Wp, B, bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(),
    )
    return bm, bls, logZ


# ------------------------------------------------------------------- forward


def fb_forward_plain(coef: np.ndarray, ematch, valid, s1, bm, bls, logZ):
    """Plain version of the fb_forward kernel: the posterior match band
    [D1, Wp, B]."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    A = [[float(coef[s, u]) for u in range(_NSTATE)] for s in range(_NSTATE)]
    row0 = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    row0[0] = 0.2
    zero = torch.zeros_like(row0)
    f = [row0] * _NSTATE

    def mixes(vals):
        out = []
        for t in range(_NSTATE):
            acc = vals[0] * A[0][t]
            for s in range(1, _NSTATE):
                acc = acc + vals[s] * A[s][t]
            out.append(acc)
        return out

    post = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    post[0] = f[0] * bm[0] * torch.exp(0.0 + bls[0] - logZ)
    mx = mixes(f)
    mm1, mm2 = zero, mx[0]          # match mixes of d-1 and d for step d+1
    gap_mix = mx[1:]                # gap-target mixes of d-1
    ls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)
    sprev = s1[0]
    for d in range(1, D1):
        t1 = s1[d]
        t2 = t1 + sprev
        sprev = t1
        mm = shift(mm1, t2 - 1)
        if d % _RESCALE_PERIOD == 0:
            mm = mm / cprev
        v = valid[d].float()
        f = [ematch[d] * mm,
             shift(gap_mix[0], t1) * v, shift(gap_mix[1], t1 - 1) * v,
             shift(gap_mix[2], t1) * v, shift(gap_mix[3], t1 - 1) * v]
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            fmax = torch.stack(f).amax(dim=(0, 1))
            c = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
            inv = 1.0 / c
            f = [x * inv for x in f]
            ls = ls + torch.log(c)
            cprev = c
        post[d] = f[0] * bm[d] * torch.exp(ls + bls[d] - logZ)
        mx = mixes(f)
        mm1, mm2 = mm2, mx[0]
        gap_mix = mx[1:]
    return post


def fb_forward_cuda(coef: np.ndarray, ematch, valid, s1, bm, bls, logZ):
    """The fb_forward kernel (csrc/fb.cu); same output as the plain
    version."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    check_tensor(ematch, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    check_tensor(s1, torch.int32, (D1, B), dev)
    check_tensor(bm, torch.float32, (D1, Wp, B), dev)
    check_tensor(bls, torch.float32, (D1, B), dev)
    check_tensor(logZ, torch.float32, (B,), dev)
    post = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    c = np.ascontiguousarray(coef, np.float32)
    _build.launch(
        "fb_forward", dev, ematch.data_ptr(), valid.data_ptr(),
        s1.data_ptr(), bm.data_ptr(), bls.data_ptr(), logZ.data_ptr(),
        c.ctypes.data, D1, Wp, B, post.data_ptr(),
    )
    return post


def fb_rel_resources(device: torch.device, wp: int, B: int,
                     backward: bool) -> Dict[str, int]:
    """What a launch of fb_backward (`backward`) or fb_forward over B lanes
    at band width `wp` gets on `device`: registers per thread, shared
    memory per block, blocks per SM, threads per block, local memory per
    thread (spills) and the lanes a block, which csrc/common.cuh
    `warp_lanes` chooses from B, the SM count and the shared memory a
    block may take."""
    res = _build.resources("fb_rel_info", device, int(backward), wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


# ------------------------------------------------------------------ entries


def fb_inputs(tables: FbTables, dev: DeviceBatch):
    """(coef, premasked match emission band) for the kernels; raises for
    models whose gap emissions are not flat (`require_flat_gaps`)."""
    st = static_tables(tables)
    gc = require_flat_gaps(st)
    check_uniform_pi(tables)
    ematch = _precompute_ematch(tables, dev.xb, dev.yb) * dev.valid
    return _coefficients(st, gc), ematch


def _posteriors(tables: FbTables, dev: DeviceBatch, backward, forward):
    coef, ematch = fb_inputs(tables, dev)
    bm, bls, logZ = backward(coef, ematch, dev.valid, dev.s1, dev.final_d,
                             dev.final_k)
    return logZ, forward(coef, ematch, dev.valid, dev.s1, bm, bls, logZ)


def posteriors_pre(tables: FbTables, dev: DeviceBatch):
    """(logZ [B], posterior match band [D1, Wp, B]) on dev's device: the
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    if use_kernel(dev.xb):
        return _posteriors(tables, dev, fb_backward_cuda, fb_forward_cuda)
    return _posteriors(tables, dev, fb_backward_plain, fb_forward_plain)


def posteriors_pre_plain(tables: FbTables, dev: DeviceBatch):
    """posteriors_pre through the plain versions on any device."""
    return _posteriors(tables, dev, fb_backward_plain, fb_forward_plain)


def posteriors_specialised(tables: FbTables, dev: DeviceBatch):
    """(logZ [B], posterior match band [D1, Wp, B]) of any model, routed as
    marginalign_trna_tpu/ops/fb_pallas.py `posteriors_pallas_specialised`
    routes it: flat gap emissions through the flat-gap pair
    (`posteriors_pre`), any other model through the generic pair
    (ops/fb_generic_cuda.py `posteriors_generic`)."""
    if has_flat_gap_emissions(tables):
        return posteriors_pre(tables, dev)
    return posteriors_generic(tables, dev)
