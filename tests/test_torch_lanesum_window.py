"""The window scheme of X's CUDA kernel, checked where there is no card:
csrc/scatter.cu `lanesum_window_kernel` + `lanesum_reduce_kernel`
(scatter_lanesum, marginCaller's lane-summed scatter).

The kernel's plan (`lanesum_plan`) gives each block a group of lanes (a
power of two, at least 32, no more groups than SMs) and a window of the
output rows [0, rows), rows = min(rg, X_WIN / C).  Every value is rounded
once to 64-bit fixed point (2^-32 units); a block adds its lanes' values
whose targets fall in the window into shared memory and those targeting
rows [rows, rg) into an accumulator in device memory; targets -1 or >= rg
add nowhere.  It then writes its window as the group's partial
[groups, rows, C], which a second pass sums, converting every output once
to float32.  Integer sums do not depend on the order of the adds, so the
model here (torch, a group at a time) computes what the kernel computes
bit for bit, whatever order its threads take.

The model is held to the plain version (rtol 1e-5) with groups of 8 and
16 lanes, windows far shorter than rg (most targets past them), random
targets with -1 and out-of-range ones, channel counts 4 and 3, and to
itself across group sizes (bit for bit); on the caller's flush streams of
packed synthetic reads, to the JAX package's `bucket_scatter_lanesum` in
interpret mode as tests/test_torch_bucket_scatter.py runs it (1e-5).  The
plan is checked at the caller's shapes against the window size read from
the kernel's source.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops import bucket_scatter as jbs
from marginalign_trna_tpu.ops import expectations as jexp
from marginalign_trna_tpu_torch.ops import bucket_scatter as tbs
from marginalign_trna_tpu_torch.ops import expectations as texp

from test_torch_bucket_scatter import WIDTH, _batch, _without_group_pad

F32 = torch.float32
SCATTER_CU = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "marginalign_trna_tpu_torch", "csrc", "scatter.cu")


def kernel_window_words():
    """X_WIN, the 64-bit sums of a block's window, from csrc/scatter.cu."""
    with open(SCATTER_CU) as fh:
        return int(re.search(r"constexpr int X_WIN = (\d+);", fh.read())
                   .group(1))


def lanesum_plan(C, B, rg, sms, win_words):
    """csrc/scatter.cu `lanesum_plan`: (window rows, lanes a group,
    groups)."""
    rows = min(rg, win_words // C)
    shift = 5
    while shift < 30 and ((B - 1) >> shift) + 1 > sms:
        shift += 1
    return rows, 1 << shift, ((B - 1) >> shift) + 1


def fixed(x):
    """csrc/scatter.cu `fixed`: float32 values in 2^-32 units, rounded to
    nearest (half to even, as __float2ll_rn)."""
    return torch.round(x.double() * 2.0 ** 32).long()


def lanesum_window(vals, jm, rg, rows, lanes):
    """[rg, C] as the window kernel and the reduce pass compute it, groups
    of `lanes` lanes, the window the output rows [0, rows)."""
    C, D, B = vals.shape
    groups = -(-B // lanes)
    acc = torch.zeros((rg, C), dtype=torch.int64)
    part = torch.zeros((groups, rows, C), dtype=torch.int64)
    for g in range(groups):
        lo, hi = g * lanes, min(B, (g + 1) * lanes)
        for d in range(D):
            t = jm[d, lo:hi].long()
            q = fixed(vals[:, d, lo:hi].t())
            here = (t >= 0) & (t < rows)
            past = (t >= rows) & (t < rg)
            part[g].index_put_((t[here],), q[here], accumulate=True)
            acc.index_put_((t[past],), q[past], accumulate=True)
    acc[:rows] = part.sum(0)
    # __ll2float_rn, then the exact scale by 2^-32.
    return acc.to(F32) * 2.0 ** -32


@pytest.mark.parametrize("C", [4, 3])
@pytest.mark.parametrize("lanes", [8, 16])
def test_window_model_matches_plain(lanes, C):
    """Random targets over rg = 500 with a 48-row window (most targets
    past it), 30% -1 and 3% at or past rg; 37 lanes (a partial group)."""
    rng = np.random.default_rng(lanes + C)
    D, B, rg = 41, 37, 500
    vals = torch.from_numpy(rng.random((C, D, B)).astype(np.float32))
    jm = rng.integers(0, rg, (D, B))
    u = rng.random((D, B))
    jm[u < 0.3] = -1
    jm[u > 0.97] = rg + rng.integers(0, 9, int((u > 0.97).sum()))
    jm = torch.from_numpy(jm.astype(np.int32))
    got = lanesum_window(vals, jm, rg, 48, lanes)
    ref = tbs.scatter_lanesum_plain(vals, jm, rg)
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-6)
    # One group (every window add in one block) gives the same sums, bit
    # for bit (integer sums).
    assert torch.equal(lanesum_window(vals, jm, rg, 48, 64), got)


@pytest.mark.parametrize("lanes", [8, 16])
def test_window_model_matches_pallas(lanes):
    """The caller's flush streams (fused_flush_jmaps_device) of 40 packed
    synthetic lanes over 700 positions (rg 1024), random values on every
    row, a 64-row window: the model against the JAX package's kernel in
    interpret mode, and the port's plain version."""
    rng = np.random.default_rng(40 + lanes)
    comp = _batch(rng, 40)
    B, total = comp.batch, 700
    off = np.zeros(B, np.int64)
    live = (comp.m + comp.n) > 0
    off[live] = rng.integers(0, total - comp.n[live])
    d1k = -(-comp.num_steps // 8) * 8
    rg = -(-total // 512) * 512
    jm = jexp.fused_flush_jmaps_device(
        jnp.asarray(comp.lo), jnp.asarray(off), jnp.asarray(comp.n), WIDTH,
        comp.wp, d1k)
    fl = rng.random((4, d1k, B)).astype(np.float32)
    tails = rng.random((4, comp.wp, B)).astype(np.float32)
    vals_j, jm_j = jbs.pad_group_rows(
        jexp._concat_group_aligned_vals(jnp.asarray(fl), jnp.asarray(tails)),
        jm)
    want = np.asarray(jbs.bucket_scatter_lanesum(vals_j, jm_j, rg))
    g = -(-d1k // jbs.GROUP) * jbs.GROUP
    jm = np.asarray(jm)
    vals, jm_t = texp.concat_flush_tails(
        torch.from_numpy(fl), torch.from_numpy(tails),
        torch.from_numpy(jm[:d1k].copy()), torch.from_numpy(jm[g:].copy()))
    assert np.array_equal(jm_t.numpy(), _without_group_pad(np.asarray(jm_j),
                                                           d1k, comp.wp))
    got = lanesum_window(vals, jm_t, rg, 64, lanes)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert torch.allclose(got, tbs.scatter_lanesum_plain(vals, jm_t, rg),
                          rtol=1e-5, atol=1e-6)


def test_plan_at_caller_shapes():
    """The caller's [4, 152, 65536] on an H100's 132 SMs: 128 groups of 512
    lanes with the whole output of rg 7168 in the window; at rg 65536 the
    window's 7168 rows, the rest into the device-memory accumulator; few
    lanes, one group."""
    win = kernel_window_words()
    assert win // 4 == 7168
    assert lanesum_plan(4, 65536, 7168, 132, win) == (7168, 512, 128)
    assert lanesum_plan(4, 65536, 65536, 132, win) == (7168, 512, 128)
    assert lanesum_plan(4, 20, 700, 132, win) == (700, 32, 1)
    assert lanesum_plan(3, 4300, 40000, 132, win)[0] == win // 3


def test_plain_sums_in_float64():
    """The card test's one-row case (C = 4, 41 x 9000 cells, ~2.5e5 values
    of [0, 1) in row 0, a sum near 1.1e5): the plain version equals the
    float64 sum rounded once (a float32 scatter_add_ in cell order drifted
    1.12 from it on channel 0, past the card test's bound of 1.11); the
    fixed-point model within float32 rounding of it."""
    rng = np.random.default_rng(1 + 9000)
    C, D, B, rg = 4, 41, 9000, 1
    vals = rng.random((C, D, B)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = 0
    jm = rng.integers(0, rg, (D, B))
    u = rng.random((D, B))
    jm[u < 0.3] = -1
    jm[u > 0.97] = rg + rng.integers(0, 9, int((u > 0.97).sum()))
    hit = (jm >= 0) & (jm < rg)
    exact = np.stack([np.bincount(jm[hit], weights=vals[c][hit].astype(
        np.float64), minlength=rg) for c in range(C)], axis=1)
    v, j = torch.from_numpy(vals), torch.from_numpy(jm.astype(np.int32))
    got = tbs.scatter_lanesum_plain(v, j, rg)
    assert got.dtype == F32
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    model = lanesum_window(v, j, rg, 1, 128)
    assert np.abs(model.double().numpy() - exact).max() <= 0.01
