"""Banded tracebacks on the device (NW and MEA): the CUDA kernels
(csrc/traceback.cu) and their plain PyTorch versions.

Port of marginalign_trna_tpu/ops/traceback_device.py.  Every lane walks its
uint8 pointer band [D1, Wp, B] in lockstep over the diagonals
d = D1 - 1 .. 1 and makes at most one move a diagonal (an M move skips
d - 1 entirely); only the 2-bit move stream [ceil((D1 - 1) / 4), B] comes
to the host, into a pinned buffer, where the pointer band it replaces is
Wp x 4 times larger.  Each kernel writes the packed stream directly
(`nw_moves_device` / `mea_moves_device` fused with `pack_moves`): a block
of 32 lanes streams its slabs of the band and of lo into shared memory, a
tile of diagonals at a time from its longest lane's m + n down, ahead of
the warp that walks them (csrc/traceback.cu).  Each
plain version is the scan step for step, vectorised over lanes (one torch
step a diagonal), followed by `pack_moves`.

Move codes: 0 = M (diag, i-1 j-1), 1 = I (read consumed, i-1),
2 = D (ref consumed, j-1), 3 = no move at this diagonal.  Reading a lane's
column in ascending d gives the host traceback's op list in order;
`ops_from_moves` run-length encodes it.

Semantics are the host tracebacks' (native/margin_native.cpp, ops/nw.py and
ops/mea.py `_traceback_arrays`): the NW degenerate edge (state M on the
i == 0 / j == 0 edge re-reads the same cell as a gap state), and MEA
pointer values other than 0 and 1 taken as I with i decremented alone (the
JAX scan decrements both i and j for value 3, which no kernel emits).
A band row outside [0, Wp) reads pointer 0, as the scans' one-hot does.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import _build
from ._build import check_tensor
from .dispatch import use_kernel

NO_MOVE = 3


def _walk_plain(ptrs: torch.Tensor, lo: torch.Tensor, m: torch.Tensor,
                n: torch.Tensor, final_state) -> torch.Tensor:
    """Moves [D1 - 1, B] int8 of the NW walk (final_state given) or the MEA
    walk (final_state None); moves[d - 1, b] is the move of lane b at
    diagonal d (marginalign_trna_tpu/ops/traceback_device.py
    `nw_moves_device` :36, `mea_moves_device` :90)."""
    D1, Wp, B = ptrs.shape
    dev = ptrs.device
    T = D1 - 1
    mvs = torch.full((max(T, 0), B), NO_MOVE, dtype=torch.int8, device=dev)
    i, j = m.to(torch.int64), n.to(torch.int64)
    nw = final_state is not None
    state = final_state.to(torch.int64) if nw else None
    # Above every lane's m + n no lane moves: those rows stay NO_MOVE.
    top = min(T, int((i + j).max())) if B else 0
    for d in range(top, 0, -1):
        active = (i + j == d) & ((i > 0) | (j > 0))
        k = i - lo[d].to(torch.int64)
        inb = (k >= 0) & (k < Wp)
        p = ptrs[d].gather(0, k.clamp(0, Wp - 1)[None])[0].to(torch.int64)
        p = torch.where(inb, p, 0)
        if nw:
            st = torch.where((state == 0) & (i == 0), 1,
                             torch.where((state == 0) & (j == 0), 2, state))
            is_m, is_ix = st == 0, st == 1
            op = torch.where(is_m, 0, torch.where(is_ix, 2, 1))
            di = (~is_ix).to(torch.int64)
            dj = (is_m | is_ix).to(torch.int64)
            ns = torch.where(is_m, p & 3, torch.where(
                is_ix, (p >> 2) & 1, ((p >> 3) & 1) * 2))
            state = torch.where(active, ns, state)
        else:
            pe = torch.where(i == 0, 1, torch.where(j == 0, 2, p))
            op = torch.where(pe == 0, 0, torch.where(pe == 1, 2, 1))
            di = (pe != 1).to(torch.int64)
            dj = (pe <= 1).to(torch.int64)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        mvs[d - 1] = torch.where(active, op, NO_MOVE).to(torch.int8)
    return mvs


def nw_walk_plain(ptrs, lo, m, n, final_state) -> torch.Tensor:
    """The NW walk's moves [D1 - 1, B] int8, unpacked (`nw_moves_device`)."""
    return _walk_plain(ptrs, lo, m, n, final_state)


def mea_walk_plain(ptrs, lo, m, n) -> torch.Tensor:
    """The MEA walk's moves [D1 - 1, B] int8, unpacked
    (`mea_moves_device`)."""
    return _walk_plain(ptrs, lo, m, n, None)


def pack_moves(mvs: torch.Tensor) -> torch.Tensor:
    """[T, B] 2-bit moves -> [ceil(T / 4), B] uint8: 4 moves a byte, move t
    in bits 2 (t % 4), the padding NO_MOVE (traceback_device.py
    `pack_moves` :122)."""
    T, B = mvs.shape
    P = -(-T // 4)
    pad = torch.full((4 * P - T, B), NO_MOVE, dtype=torch.uint8,
                     device=mvs.device)
    m4 = torch.cat([mvs.to(torch.uint8), pad]).reshape(P, 4, B)
    return m4[:, 0] | (m4[:, 1] << 2) | (m4[:, 2] << 4) | (m4[:, 3] << 6)


def nw_moves_plain(ptrs, lo, m, n, final_state) -> torch.Tensor:
    """Plain version of the nw_moves kernel: the packed move stream
    [ceil((D1 - 1) / 4), B] uint8."""
    return pack_moves(nw_walk_plain(ptrs, lo, m, n, final_state))


def mea_moves_plain(ptrs, lo, m, n) -> torch.Tensor:
    """Plain version of the mea_moves kernel (output as nw_moves')."""
    return pack_moves(mea_walk_plain(ptrs, lo, m, n))


def _moves_cuda(name, ptrs, lo, m, n, final_state=None) -> torch.Tensor:
    D1, Wp, B = ptrs.shape
    dev = ptrs.device
    check_tensor(ptrs, torch.uint8, (D1, Wp, B), dev)
    check_tensor(lo, torch.int32, (D1, B), dev)
    lanes = (m, n) if final_state is None else (m, n, final_state)
    for t in lanes:
        check_tensor(t, torch.int32, (B,), dev)
    out = torch.empty((-(-(D1 - 1) // 4), B), dtype=torch.uint8, device=dev)
    if out.numel():
        _build.launch(name, dev, ptrs.data_ptr(),
                      *(t.data_ptr() for t in (lo,) + lanes), D1, Wp, B,
                      out.data_ptr())
    return out


def nw_moves_cuda(ptrs, lo, m, n, final_state) -> torch.Tensor:
    """The nw_moves kernel (csrc/traceback.cu); same output as the plain
    version."""
    return _moves_cuda("nw_moves", ptrs, lo, m, n, final_state)


def mea_moves_cuda(ptrs, lo, m, n) -> torch.Tensor:
    """The mea_moves kernel (csrc/traceback.cu); same output as the plain
    version."""
    return _moves_cuda("mea_moves", ptrs, lo, m, n)


# The kernels' copy routes (csrc/traceback.cu), by the band's alignment:
# TMA boxes (B % 16 == 0, band and lo 16-byte aligned) or cp.async of the
# aligned words that hold each row, read at its byte shift.
ROUTES = ("tma", "shifted")


def moves_resources(name: str, device: torch.device, wp: int,
                    B: int) -> Dict[str, object]:
    """What a launch of nw_moves or mea_moves (`name`) over B lanes at band
    width `wp` gets on `device`, its band and lo 16-byte aligned (a band at
    another offset takes the "shifted" route whatever B): registers per
    thread, shared memory per block, blocks per SM, threads per block,
    local memory per thread (spills), and the kernel's diagonals a tile,
    stages of its ring, copy route and lanes a block."""
    out = (ctypes.c_int * 9)()
    _build.query("moves_info", device, int(name == "nw_moves"), wp, B,
                 ctypes.addressof(out))
    res = dict(zip(("registers", "smem_per_block", "blocks_per_sm",
                    "threads_per_block", "local_bytes",
                    "diagonals_per_tile", "stages"), out))
    return {**res, "route": ROUTES[out[7]], "lanes_per_block": out[8]}


def nw_moves(ptrs, lo, m, n, final_state) -> torch.Tensor:
    """Packed NW moves of every lane: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = nw_moves_cuda if use_kernel(ptrs) else nw_moves_plain
    return fn(ptrs, lo, m, n, final_state)


def mea_moves(ptrs, lo, m, n) -> torch.Tensor:
    """Packed MEA moves of every lane: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = mea_moves_cuda if use_kernel(ptrs) else mea_moves_plain
    return fn(ptrs, lo, m, n)


def unpack_moves(packed: np.ndarray, T: int) -> np.ndarray:
    """Inverse of pack_moves on host numpy: [P, B] uint8 -> [T, B] uint8."""
    P, B = packed.shape
    out = np.empty((P, 4, B), np.uint8)
    for s in range(4):
        out[:, s, :] = (packed >> (2 * s)) & 3
    return out.reshape(P * 4, B)[:T]


def ops_from_moves(moves: np.ndarray, b: int) -> List[Tuple[int, int]]:
    """Run-length encode lane b's move column (ascending d == the host
    traceback's final op order) into aligned ops [(op, len)]."""
    col = moves[:, b]
    sel = col[col != NO_MOVE]
    if sel.size == 0:
        return []
    cuts = np.nonzero(np.diff(sel))[0]
    starts = np.concatenate([[0], cuts + 1])
    ends = np.concatenate([cuts + 1, [sel.size]])
    return [
        (int(sel[s]), int(e - s)) for s, e in zip(starts, ends)
    ]


def moves_to_host(packed: torch.Tensor) -> np.ndarray:
    """The packed move stream on the host: a CUDA stream through one pinned
    buffer (an asynchronous copy, then one synchronize of the current
    stream)."""
    if not packed.is_cuda:
        return packed.numpy()
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(packed.device).synchronize()
    return host.numpy()


def lane_ops(packed: torch.Tensor, T: int) -> List[List[Tuple[int, int]]]:
    """Aligned ops [(op, len)] of every lane of a packed move stream of T
    moves a lane."""
    moves = unpack_moves(moves_to_host(packed), T)
    return [ops_from_moves(moves, b) for b in range(moves.shape[1])]


def nw_lane_ops(ptrs, lo, m, n, final_state) -> List[List[Tuple[int, int]]]:
    """Guide traceback of every lane of K1's pointer band (0 = M, 1 = I,
    2 = D, from (0, 0) to (m, n)); only the move stream leaves the
    device."""
    return lane_ops(nw_moves(ptrs, lo, m, n, final_state), ptrs.shape[0] - 1)


def mea_lane_ops(ptrs, lo, m, n) -> List[List[Tuple[int, int]]]:
    """MEA traceback of every lane of D's or K4's pointer band (ops as
    nw_lane_ops')."""
    return lane_ops(mea_moves(ptrs, lo, m, n), ptrs.shape[0] - 1)
