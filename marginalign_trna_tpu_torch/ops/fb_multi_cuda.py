"""Flat-gap pair-HMM posteriors over multi-problem lanes: the CUDA kernel
pair fb_multi_forward / fb_multi_backward (csrc/fb_multi.cu) and their plain
PyTorch versions.

Port of marginalign_trna_tpu/ops/fb_pallas.py `_posteriors_pre_multi`
(`posteriors_pallas_multi`), the forward-first specialisation for lanes
that hold several short problems one after another, SPACER empty
diagonals apart (ops/band.py `pack_multi_banded_batch`):

  1. the match emission band is precomputed by indexing (`Ematch[xb, yb]`,
     premasked by valid);
  2. fb_multi_forward runs the scaled forward over the whole lane, seeding
     the start distribution at row 0 of every problem's first diagonal,
     and writes the scaled match plane fm, the cumulative log-scale lsf
     and the per-diagonal terminal sum term (0 off terminal diagonals);
  3. on the device in plain torch (ops/fb.py `multi_logz`, shared with
     the E-step counts): logterm = log(term) + lsf, the per-step
     L = logterm at the owning problem's terminal diagonal (the
     `step_final` gather), and each problem's
     logZ = logterm[final_d] - lsf[d0 - 1], the lane's log-scale just
     before its start (the JAX package's arithmetic, whose float32 digits
     thin out as more problems precede a problem in its lane);
  4. fb_multi_backward runs the scaled backward, injecting at every
     terminal cell and restarting the log-scale there, and writes the
     posterior band fm * b_M * exp(lsf + bls - L), normalised per
     problem.

The model comes as the coefficient vector of ops/fb_circ.py
`circ_coefficients` in both of its forms (`chain`: the gap-chain form of
every cPecan model family, else the generic 5x5 mix), as the TPU kernels
take theirs.  Scaling is the TPU kernels': rescale by the band max every 8
diagonals of the lane (forward at d % 8 == 7, backward at d % 8 == 0),
factor 1 for a step with no mass, the d-2 term divided by the previous
factor on the step after a rescale.  The plain versions follow the kernels'
arithmetic step for step (the kernels build with -fmad=false).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build
from ._build import check_tensor
from .dispatch import use_kernel
from .fb import FbTables, MultiDeviceBatch, multi_logz, shift
from .fb_circ import circ_coefficients
from .fb_circ_cuda import (
    COEF_A, COEF_C, COEF_CB, COEF_K, COEF_M0, COEF_MC, COEF_PI, COEF_R,
    COEF_T00, _coef, _floats,
)
from .fb_cuda import _precompute_ematch

_RESCALE_PERIOD = 8


def _mixes(c, chain: bool, f):
    """(match mix, [gap-target mixes]) generation f contributes: the match
    target two diagonals on, the gap targets one on."""
    if chain:
        mm = c[COEF_T00] * f[0]
        for s in range(1, 5):
            mm = mm + c[COEF_MC + s - 1] * f[s]
        return mm, [f[0] + c[COEF_C + u - 1] * f[u] for u in range(1, 5)]
    A = [[c[COEF_A + 5 * s + u] for u in range(5)] for s in range(5)]
    out = []
    for t in range(5):
        acc = f[0] * A[0][t]
        for s in range(1, 5):
            acc = acc + f[s] * A[s][t]
        out.append(acc)
    return out[0], out[1:]


# ------------------------------------------------------------------ forward


def fb_multi_forward_plain(coef: np.ndarray, chain: bool, ematch, valid, s1,
                           start, fink):
    """Plain version of the fb_multi_forward kernel: (fm [D1, Wp, B],
    lsf [D1, B], term [D1, B]) from the premasked match emissions ematch
    [D1, Wp, B], valid, the s1 stream and the start / fink streams
    [D1, B]."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    c = _floats(coef)
    kr = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    mm1 = mm2 = zero            # match mixes of generations d-1, d-2
    gmix = [zero] * 4           # gap-target mixes of generation d-1
    ls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)
    sprev = torch.zeros(B, dtype=torch.int32, device=dev)
    fm = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    lsf = torch.empty((D1, B), dtype=torch.float32, device=dev)
    term = torch.empty((D1, B), dtype=torch.float32, device=dev)
    for d in range(D1):
        t1 = s1[d]
        t2 = t1 + sprev
        sprev = t1
        mm = shift(mm2, t2 - 1)
        if d % _RESCALE_PERIOD == 0:
            mm = mm / cprev
        v = valid[d].float()
        e = ematch[d]
        g = [shift(gmix[0], t1), shift(gmix[1], t1 - 1),
             shift(gmix[2], t1), shift(gmix[3], t1 - 1)]
        seed = (kr == 0) & (start[d] != 0)[None, :]
        if chain:
            f = [torch.where(seed, 0.2, e * mm)] + [
                torch.where(seed, c[COEF_PI + s], g[s] * v) for s in range(4)]
            w = f[0]
            for s in range(1, 5):
                w = w + c[COEF_K + s - 1] * f[s]
        else:
            inj = torch.where(seed, 0.2, 0.0)
            f = [e * mm * v + inj] + [g[s] * v + inj for s in range(4)]
            w = (((f[0] + f[1]) + f[2]) + f[3]) + f[4]
        fk = fink[d].long()
        at = w.gather(0, fk.clamp(0, Wp - 1)[None, :])[0]
        tv = torch.where((fk >= 0) & (fk < Wp), at, 0.0)
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            fmax = torch.stack(f).amax(dim=(0, 1))
            cf = torch.where(fmax > 0, fmax, torch.ones_like(fmax))
            inv = 1.0 / cf
            tv = tv * inv
            f = [x * inv for x in f]
            ls = ls + torch.log(cf)
            cprev = cf
        fm[d] = f[0]
        lsf[d] = ls
        term[d] = tv
        mix_m, gmix = _mixes(c, chain, f)
        mm2, mm1 = mm1, mix_m
    return fm, lsf, term


def fb_multi_forward_cuda(coef: np.ndarray, chain: bool, ematch, valid, s1,
                          start, fink):
    """The fb_multi_forward kernel (csrc/fb_multi.cu); same outputs as the
    plain version."""
    D1, Wp, B = ematch.shape
    dev = ematch.device
    check_tensor(ematch, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    check_tensor(s1, torch.int32, (D1, B), dev)
    check_tensor(start, torch.int8, (D1, B), dev)
    check_tensor(fink, torch.int32, (D1, B), dev)
    fm = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    lsf = torch.empty((D1, B), dtype=torch.float32, device=dev)
    term = torch.empty((D1, B), dtype=torch.float32, device=dev)
    c = _coef(coef)
    _build.launch(
        "fb_multi_forward", dev, ematch.data_ptr(), valid.data_ptr(),
        s1.data_ptr(), start.data_ptr(), fink.data_ptr(), c.ctypes.data,
        int(chain), D1, Wp, B, fm.data_ptr(), lsf.data_ptr(),
        term.data_ptr(),
    )
    return fm, lsf, term


# ----------------------------------------------------------------- backward


def fb_multi_backward_plain(coef: np.ndarray, chain: bool, fm, lsf, L,
                            ematch, valid, s1, fink, find):
    """Plain version of the fb_multi_backward kernel: the posterior match
    band [D1, Wp, B], each problem normalised by L [D1, B] (the log
    likelihood at its terminal diagonal, in the lane's forward scale)."""
    D1, Wp, B = fm.shape
    dev = fm.device
    c = _floats(coef)
    A = [[c[COEF_A + 5 * s + u] for u in range(5)] for s in range(5)]
    kr = torch.arange(Wp, device=dev)[:, None]
    zero = torch.zeros((Wp, B), dtype=torch.float32, device=dev)
    gaps = [zero] * 4            # gap states at d+1
    p1 = p2 = zero               # e_M * b_M at d+1, d+2
    bls = torch.zeros(B, dtype=torch.float32, device=dev)
    cprev = torch.ones(B, dtype=torch.float32, device=dev)
    sh1 = sh2 = torch.zeros(B, dtype=torch.int32, device=dev)
    post = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    for d in range(D1 - 1, -1, -1):
        s1n, s2n = sh1, sh1 + sh2
        q = [shift(p2, 1 - s2n), shift(gaps[0], -s1n),
             shift(gaps[1], 1 - s1n), shift(gaps[2], -s1n),
             shift(gaps[3], 1 - s1n)]
        if d % _RESCALE_PERIOD == _RESCALE_PERIOD - 1:
            q[0] = q[0] / cprev
        v = valid[d].float()
        mask = kr == fink[d].long()[None, :]
        is_term = find[d] == d
        if chain:
            acc0 = c[COEF_T00] * q[0]
            for s in range(1, 5):
                acc0 = acc0 + c[COEF_M0 + s - 1] * q[s]
            new = [torch.where(mask, 1.0, acc0) * v] + [
                torch.where(mask, c[COEF_R + s - 1],
                            q[0] + c[COEF_CB + s - 1] * q[s]) * v
                for s in range(1, 5)]
        else:
            inj = (mask & is_term[None, :]).float()
            new = []
            for s in range(5):
                acc = q[0] * A[s][0]
                for u in range(1, 5):
                    acc = acc + q[u] * A[s][u]
                new.append((acc + inj) * v)
        sh2, sh1 = sh1, s1[d]
        bls = torch.where(is_term, 0.0, bls)
        if d % _RESCALE_PERIOD == 0:
            bmax = torch.stack(new).amax(dim=(0, 1))
            cf = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
            inv = 1.0 / cf
            new = [x * inv for x in new]
            bls = bls + torch.log(cf)
            cprev = cf
        post[d] = fm[d] * new[0] * torch.exp(lsf[d] + bls - L[d])
        p2, p1 = p1, ematch[d] * new[0]
        gaps = new[1:]
    return post


def fb_multi_backward_cuda(coef: np.ndarray, chain: bool, fm, lsf, L,
                           ematch, valid, s1, fink, find):
    """The fb_multi_backward kernel (csrc/fb_multi.cu); same output as the
    plain version."""
    D1, Wp, B = fm.shape
    dev = fm.device
    for t in (fm, ematch):
        check_tensor(t, torch.float32, (D1, Wp, B), dev)
    check_tensor(valid, torch.bool, (D1, Wp, B), dev)
    for t in (lsf, L):
        check_tensor(t, torch.float32, (D1, B), dev)
    for t in (s1, fink, find):
        check_tensor(t, torch.int32, (D1, B), dev)
    post = torch.empty((D1, Wp, B), dtype=torch.float32, device=dev)
    c = _coef(coef)
    _build.launch(
        "fb_multi_backward", dev, fm.data_ptr(), lsf.data_ptr(), L.data_ptr(),
        ematch.data_ptr(), valid.data_ptr(), s1.data_ptr(), fink.data_ptr(),
        find.data_ptr(), c.ctypes.data, int(chain), D1, Wp, B,
        post.data_ptr(),
    )
    return post


def fb_multi_resources(device: torch.device, wp: int, B: int,
                       backward: bool) -> Dict[str, int]:
    """What a launch of fb_multi_backward (`backward`) or fb_multi_forward
    over B lanes at band width `wp` with a gap-chain model gets on `device`
    (as ops/fb_cuda.py `fb_rel_resources`): registers per thread, shared
    memory per block, blocks per SM, threads per block, local memory per
    thread (spills) and the lanes a block."""
    res = _build.resources("fb_multi_info", device, int(backward), wp, B)
    return {**res, "lanes_per_block": res["threads_per_block"] // 32}


# -------------------------------------------------------------------- entry


def _posteriors_multi(tables: FbTables, mdev: MultiDeviceBatch, forward,
                      backward) -> Tuple[torch.Tensor, torch.Tensor]:
    coef, chain = circ_coefficients(tables)
    ematch = _precompute_ematch(tables, mdev.xb, mdev.yb) * mdev.valid
    fm, lsf, term = forward(coef, chain, ematch, mdev.valid, mdev.s1,
                            mdev.start, mdev.fink)
    L, logZ = multi_logz(lsf, term, mdev)
    post = backward(coef, chain, fm, lsf, L, ematch, mdev.valid, mdev.s1,
                    mdev.fink, mdev.find)
    return logZ, post


def posteriors_multi(tables: FbTables, mdev: MultiDeviceBatch
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logZ [P], posterior match band [D1, Wp, B]) of a multi-problem
    batch on mdev's device: the kernels for CUDA tensors, the plain
    versions for CPU tensors.  Raises for a model whose gap emissions are
    not flat (`circ_coefficients`)."""
    if use_kernel(mdev.xb):
        return _posteriors_multi(tables, mdev, fb_multi_forward_cuda,
                                 fb_multi_backward_cuda)
    return _posteriors_multi(tables, mdev, fb_multi_forward_plain,
                             fb_multi_backward_plain)
