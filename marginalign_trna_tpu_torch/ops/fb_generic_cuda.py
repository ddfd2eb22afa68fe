"""Pair-HMM forward-backward posteriors of any model: the CUDA kernel pair
fb_generic_fwd + fb_generic_bwd (csrc/fb_counts.cu) and its plain PyTorch
versions.

Port of marginalign_trna_tpu/ops/fb_pallas.py `_run_forward` (row 8 of
PERF.md's kernel table) and `_run_backward` (row 9), the JAX package's
route for models whose gap emissions are not flat (an EM model
mid-training, the un-normalised `.trialN` models), which the flat-gap
kernels (ops/fb_cuda.py, ops/fb_circ.py) cannot run.  The TPU kernels come
in two variants that compute the same floats: the model as run-time tables
(`posteriors_pallas`) and baked in (the generic branch of
`posteriors_pallas_specialised`); here the model is run-time tables.

  fb_generic_fwd: the scaled forward with generic emissions Ematch[x][y]
                  and Egap[s][x] (states 1, 3) or Egap[s][y] (2, 4),
                  storing the scaled match plane F_match [d1k, Wp, B], the
                  cumulative log-scale lsf [d1k, B] and every diagonal's
                  terminal sum term [d1k, B]; logZ = log(max(term[final_d],
                  1e-30)) + lsf[final_d];
  fb_generic_bwd: the scaled backward from the terminal cell, writing the
                  posterior match band F_match * b_M * exp(lsf + bls - logZ).

The arithmetic is the E-step counts kernels' with one trial and no counts
(ops/fb_counts_cuda.py): the plain versions are its `_forward` and
`_Backward`; the forward kernel is another instance of the checkpoint
forward's template (`counts_fwd_ckpt_kernel` in its match-plane mode), the
backward a kernel of its own (`generic_bwd_kernel`) on the checkpoint
backward's recursion, so the kernels and the plain versions round
identically.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import check_tensor
from .dispatch import use_kernel
from .fb import DeviceBatch, FbTables, check_uniform_pi
from .fb_counts import kernel_inputs, logz_from_terminal
from .fb_counts_cuda import _Backward, _check_common, _forward


def fb_generic_fwd_plain(T, Em, Eg, xb, yb, valid, s1, fink):
    """Plain version of the fb_generic_fwd kernel: (F_match [d1k, Wp, B],
    lsf [d1k, B], term [d1k, B]) of one model (T, Em, Eg [5, 5]) over the
    band streams padded to d1k, a multiple of 8 diagonals."""
    fm, lsf, term = _forward(T[None], Em[None], Eg[None], xb, yb, valid, s1,
                             fink, "match")
    return fm[0], lsf[0], term[0]


def fb_generic_bwd_plain(T, Em, Eg, fmatch, lsf, xb, yb, valid, s1, fink,
                         find, logZ):
    """Plain version of the fb_generic_bwd kernel: the posterior match band
    [d1k, Wp, B]."""
    d1k, Wp, B = xb.shape
    bw = _Backward(T[None], Em[None], Eg[None], logZ[None], Wp, B,
                   match=False, counts=False)
    post = T.new_empty((d1k, Wp, B))
    for d in range(d1k - 1, -1, -1):
        post[d] = bw.step(d, fmatch[d][None, None], lsf[d][None], xb, yb,
                          valid, s1, fink, find)[0]
    return post


def fb_generic_fwd_cuda(T, Em, Eg, xb, yb, valid, s1, fink):
    """The fb_generic_fwd kernel (csrc/fb_counts.cu); outputs of
    fb_generic_fwd_plain."""
    _, d1k, Wp, B, dev = _check_common(T[None], Em[None], Eg[None], xb, yb,
                                       valid, s1, fink)
    f32 = dict(dtype=torch.float32, device=dev)
    fm = torch.empty((d1k, Wp, B), **f32)
    lsf = torch.empty((d1k, B), **f32)
    term = torch.zeros((d1k, B), **f32)
    _build.launch(
        "fb_generic_fwd", dev, T.data_ptr(), Em.data_ptr(), Eg.data_ptr(),
        xb.data_ptr(), yb.data_ptr(), valid.data_ptr(), s1.data_ptr(),
        fink.data_ptr(), d1k, Wp, B, fm.data_ptr(), lsf.data_ptr(),
        term.data_ptr(),
    )
    return fm, lsf, term


def fb_generic_bwd_cuda(T, Em, Eg, fmatch, lsf, xb, yb, valid, s1, fink,
                        find, logZ):
    """The fb_generic_bwd kernel (csrc/fb_counts.cu); output of
    fb_generic_bwd_plain."""
    _, d1k, Wp, B, dev = _check_common(T[None], Em[None], Eg[None], xb, yb,
                                       valid, s1, fink)
    check_tensor(fmatch, torch.float32, (d1k, Wp, B), dev)
    check_tensor(lsf, torch.float32, (d1k, B), dev)
    check_tensor(find, torch.int32, (B,), dev)
    check_tensor(logZ, torch.float32, (B,), dev)
    post = torch.empty((d1k, Wp, B), dtype=torch.float32, device=dev)
    _build.launch(
        "fb_generic_bwd", dev, T.data_ptr(), Em.data_ptr(), Eg.data_ptr(),
        fmatch.data_ptr(), lsf.data_ptr(), xb.data_ptr(), yb.data_ptr(),
        valid.data_ptr(), s1.data_ptr(), fink.data_ptr(), find.data_ptr(),
        logZ.data_ptr(), d1k, Wp, B, post.data_ptr(),
    )
    return post


def posteriors_generic(tables: FbTables, dev: DeviceBatch):
    """(logZ [B], posterior match band [D1, Wp, B]) of any model on dev's
    device (fb_pallas.posteriors_pallas): the kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    check_uniform_pi(tables)
    D1 = dev.xb.shape[0]
    xb, yb, valid, s1, fk, fd = kernel_inputs(dev)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    fwd, bwd = ((fb_generic_fwd_cuda, fb_generic_bwd_cuda)
                if use_kernel(dev.xb)
                else (fb_generic_fwd_plain, fb_generic_bwd_plain))
    fm, lsf, term = fwd(*tabs, xb, yb, valid, s1, fk)
    logZ = logz_from_terminal(lsf[None], term[None], fd)[0]
    post = bwd(*tabs, fm, lsf, xb, yb, valid, s1, fk, fd, logZ)
    return logZ, post[:D1]
