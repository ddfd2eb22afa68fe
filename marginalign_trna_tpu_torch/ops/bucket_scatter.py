"""Scatters of the fused passes' flushed streams: the CUDA kernels X and L
(csrc/scatter.cu) and their plain PyTorch versions.

X is the port of marginalign_trna_tpu/ops/bucket_scatter.py
`bucket_scatter_lanesum`, the caller's lane-summed scatter:
out[v, c] = sum over (d, b) with jm[d, b] == v of vals[c, d, b].  The TPU
kernel places values by residue masks in aligned groups of 128 rows,
because per-lane gathers and scatters scalarise there, and keeps its
[rg, C] output resident in VMEM (the JAX package drops to a chunked kernel
above 65536 positions for that reason).  On the card a block owns a group
of lanes and a window of output rows [0, 7168) in shared memory (at C = 4:
the caller's whole output up to 7168 positions), adds its lanes' values
that target the window there and the others into an accumulator in device
memory, and writes the window out as its group's partial; a second pass
sums the partials and converts every output (`scatter_lanesum_plan` gives
the groups and rows, for the scratch).  The sums are kept in 64-bit fixed
point (2^-32 units, integer adds), so they do not depend on the order of
the adds: two launches are bit-identical, and each output is its exact
fixed-point sum rounded once to float32 (values and sums below 2^31 in
magnitude; the caller's are expected base counts in [0, 1]).  The plain
version sums in float64 and rounds once to float32, so the order of
`scatter_add_`'s adds moves it by float64 rounding only (a float32 sum of
2.5e5 values in one row drifted past rtol 1e-5).

L is the port of that module's `bucket_scatter` (called through
`bucket_scatter_chunked`), the per-lane scatter of the MEA's row and column
posterior sums: out[v, b] = sum over d with jm[d, b] == v of vals[d, b],
one channel.  The TPU kernel pads rows to 128-row residue groups and chunks
its [rg, B] output through VMEM; on the card a block owns 16 lanes and
spreads each lane's rows over 32 row chunks: a chunk sums its runs of
equal targets in registers, a warp per lane walks the chunks in parallel
(runs that cross chunk edges sum in a segmented scan), and where the
targets go back (the tail rows) later adds follow earlier ones a barrier
apart; the adds collect in a shared-memory window of output rows written
out as coalesced rows.  No atomics and a fixed order of additions, so two
launches give identical outputs, within float32 rounding of the plain
version's.

`monotone_gather_plain` is the function of the TPU kernel `monotone_gather`,
which the port performs as direct loads inside the expand_streams kernel
(ops/fb_circ_cuda.py).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from ._build import check_tensor


def scatter_lanesum_plain(vals: torch.Tensor, jm: torch.Tensor,
                          rg: int) -> torch.Tensor:
    """Plain version of the scatter_lanesum kernel: [rg, C] float32 from
    vals [C, D, B] float32 and targets jm [D, B] int32 (-1, and anything
    outside [0, rg), adds nowhere); summed in float64, rounded once."""
    C = vals.shape[0]
    tgt = torch.where((jm >= 0) & (jm < rg), jm, rg).long().reshape(-1)
    out = vals.new_zeros((rg + 1, C), dtype=torch.float64)
    out.scatter_add_(0, tgt[:, None].expand(-1, C),
                     vals.reshape(C, -1).t().double())
    return out[:rg].float()


def scatter_lanesum_plan(device: torch.device, C: int, B: int,
                         rg: int) -> Tuple[int, int]:
    """(lane groups, window rows) of the scatter_lanesum kernel's launch at
    (C, B, rg) on `device` (csrc/scatter.cu `lanesum_plan`): one block per
    group, its window the output rows [0, rows); the launch sums the
    groups' windows from a scratch."""
    out = (ctypes.c_int * 2)()
    _build.query("scatter_lanesum_plan", device, C, B, rg,
                 ctypes.addressof(out))
    return out[0], out[1]


def scatter_lanesum_resources(device: torch.device, C: int, B: int,
                              rg: int) -> Dict[str, int]:
    """What the window kernel of a scatter_lanesum launch at (C, B, rg)
    gets on `device` (registers, shared memory a block, blocks an SM,
    threads a block, spills), with its lane groups and window rows."""
    res = _build.resources("scatter_lanesum_info", device, C, B, rg)
    groups, rows = scatter_lanesum_plan(device, C, B, rg)
    return {**res, "groups": groups, "window_rows": rows}


def scatter_lanesum_cuda(vals: torch.Tensor, jm: torch.Tensor,
                         rg: int) -> torch.Tensor:
    """The scatter_lanesum kernel (csrc/scatter.cu); the plain version's
    function, each value first rounded to a multiple of 2^-32."""
    C, D, B = vals.shape
    dev = vals.device
    check_tensor(vals, torch.float32, (C, D, B), dev)
    check_tensor(jm, torch.int32, (D, B), dev)
    groups, rows = scatter_lanesum_plan(dev, C, B, rg)
    out = torch.empty((rg, C), dtype=torch.float32, device=dev)
    # The groups' partials, then the zeroed accumulator of rows [rows, rg).
    scratch = torch.empty(((groups * rows + rg - rows) * C,),
                          dtype=torch.int64, device=dev)
    scratch[groups * rows * C:].zero_()
    _build.launch("scatter_lanesum", dev, vals.data_ptr(), jm.data_ptr(),
                  C, D, B, rg, scratch.data_ptr(), groups, out.data_ptr())
    return out


def scatter_lanes_plain(vals: torch.Tensor, jm: torch.Tensor,
                        rg: int) -> torch.Tensor:
    """Plain version of the scatter_lanes kernel: [rg, B] float32 from
    vals [D, B] float32 and targets jm [D, B] int32 (-1, and anything
    outside [0, rg), adds nowhere)."""
    B = vals.shape[1]
    tgt = torch.where((jm >= 0) & (jm < rg), jm, rg).long()
    out = vals.new_zeros((rg + 1, B))
    out.scatter_add_(0, tgt, vals)
    return out[:rg]


def scatter_lanes_cuda(vals: torch.Tensor, jm: torch.Tensor,
                       rg: int) -> torch.Tensor:
    """The scatter_lanes kernel (csrc/scatter.cu); the plain version's
    outputs, summed in another fixed order (launches are bit-identical)."""
    D, B = vals.shape
    dev = vals.device
    check_tensor(vals, torch.float32, (D, B), dev)
    check_tensor(jm, torch.int32, (D, B), dev)
    out = torch.zeros((rg, B), dtype=torch.float32, device=dev)
    _build.launch("scatter_lanes", dev, vals.data_ptr(), jm.data_ptr(), D, B,
                  rg, out.data_ptr())
    return out


def monotone_gather_plain(src: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """out[u, b] = src[idx[u, b], b]: the function of the TPU kernel
    marginalign_trna_tpu/ops/bucket_scatter.py `monotone_gather`."""
    return src.gather(0, idx.long())
