"""Kernel dispatch by tensor device.

A CUDA tensor goes through the hand-written CUDA kernel (or the call
raises); a CPU tensor goes through the kernel's plain PyTorch version.
There is no switch that sends CUDA tensors to the plain versions and no
fallback when a kernel fails: the device of the data is the only input.
"""
from __future__ import annotations

import torch


def use_kernel(t: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("no kernel or plain version for device %s" % t.device)
