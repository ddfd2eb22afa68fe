"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: these skip on a machine without a CUDA device.  This file
imports only the port, so it runs where the JAX package cannot.  On the
card:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import os

import numpy as np
import pytest
import torch

from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import (
    _build, bucket_scatter, fb_circ_cuda, fb_counts, fb_counts_cuda,
    fb_cuda, fb_multi_cuda, wavefront_cuda,
)
from marginalign_trna_tpu_torch.ops.band import (
    band_masks, circ_mw_streams, pack_banded_batch, pack_compact_batch,
    pack_multi_banded_batch, padded_band_width, path_from_cigar,
)
from marginalign_trna_tpu_torch.ops.expectations import (
    concat_flush_tails, fused_flush_jmaps, fused_row_jmaps,
)
from marginalign_trna_tpu_torch.ops.fb import (
    device_batch, multi_device_batch, multi_logz, tables_from_hmm,
    tables_stacked,
)
from marginalign_trna_tpu_torch.ops.fb_circ import (
    circ_coefficients, compact_device_batch,
)
from marginalign_trna_tpu_torch.ops.mea import NEG, mea_weights

pytestmark = pytest.mark.cuda

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(width, seed=0, n=6):
    rng = np.random.default_rng(seed)
    reads, refs, paths = [], [], []
    for b in range(n):
        ref = rng.integers(0, 4, size=int(rng.integers(20, 120)))
        cut = len(ref) // 2
        read = np.concatenate([ref[:cut], ref[cut + 3:]]).astype(np.int8)
        read[rng.random(len(read)) < 0.1] = int(rng.integers(0, 5))
        reads.append(read)
        refs.append(ref.astype(np.int8))
        paths.append(path_from_cigar([(0, cut), (2, 3),
                                      (0, len(ref) - cut - 3)]))
    return pack_banded_batch(reads, refs, width=width, paths=paths,
                             pad_batch_to=40)


@pytest.mark.parametrize("width", [9, 40])
def test_nw_kernel_matches_plain(cuda, width):
    dev = device_batch(_batch(width), cuda)
    args = ((1.0, -2.0, -3.0, -1.0), dev.xb, dev.yb, dev.valid, dev.s1,
            dev.s2, dev.final_d, dev.final_k)
    before = _build.launch_counts["banded_nw"]
    got = wavefront_cuda.banded_nw_cuda(*args)
    ref = wavefront_cuda.banded_nw_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["banded_nw"] == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_fb_kernels_match_plain(cuda):
    tables = tables_from_hmm(PairHmm.load(MODEL), cuda)
    dev = device_batch(_batch(21, seed=1), cuda)
    coef, em = fb_cuda.fb_inputs(tables, dev)
    args = (coef, em, dev.valid, dev.s1, dev.final_d, dev.final_k)
    bm, bls, logZ = fb_cuda.fb_backward_cuda(*args)
    rbm, rbls, rlogZ = fb_cuda.fb_backward_plain(*args)
    assert torch.allclose(logZ, rlogZ, rtol=1e-4, atol=1e-4)
    assert torch.allclose(bls, rbls, rtol=1e-4, atol=1e-4)
    fargs = (coef, em, dev.valid, dev.s1, rbm, rbls, rlogZ)
    post = fb_cuda.fb_forward_cuda(*fargs)
    rpost = fb_cuda.fb_forward_plain(*fargs)
    assert (post - rpost).abs().max().item() <= 2e-4
    _, full = fb_cuda.posteriors_pre(tables, dev)
    assert (full - rpost).abs().max().item() <= 2e-4


def test_mea_kernel_matches_plain(cuda):
    batch = _batch(21, seed=2)
    dev = device_batch(batch, cuda)
    tables = tables_from_hmm(PairHmm.load(MODEL), cuda)
    _, post = fb_cuda.posteriors_pre(tables, dev)
    lo = torch.from_numpy(batch.lo).to(cuda)
    wup, wleft = mea_weights(post, dev.valid, lo, 0.5, int(batch.m.max()),
                             int(batch.n.max()))
    wdiag = torch.where(post > 0, post, NEG)
    args = (wdiag, wup, wleft, dev.valid, dev.s1, dev.s2, dev.final_d,
            dev.final_k)
    ptr, score = wavefront_cuda.banded_mea_cuda(*args)
    rptr, rscore = wavefront_cuda.banded_mea_plain(*args)
    assert torch.equal(ptr, rptr)
    assert torch.allclose(score, rscore, rtol=0, atol=1e-4)


def _compact(cuda, seed=3, n=40):
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, int(rng.integers(20, 150))).astype(np.int8)
             for _ in range(n)]
    refs = [r[: max(1, len(r) - 4)].copy() for r in reads]
    comp = pack_compact_batch(reads, refs, width=21, quantize=True)
    return comp, compact_device_batch(comp, cuda)


def test_caller_kernels_match_plain(cuda):
    """E, S, C and X at a tiny shape, each on the plain version's inputs."""
    tables = tables_from_hmm(PairHmm.load(MODEL), cuda)
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    comp, dev = _compact(cuda)
    Wp, d1k = comp.wp, comp.num_steps
    eargs = (ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, 21, Wp, d1k)
    names = ("expand_streams", "sv_backward", "cx_forward",
             "scatter_lanesum")
    before = {k: _build.launch_counts[k] for k in names}
    es, yb, fr = fb_circ_cuda.expand_streams_cuda(*eargs)
    res, ryb, rfr = fb_circ_cuda.expand_streams_plain(*eargs)
    assert torch.equal(es, res) and torch.equal(fr, rfr)
    assert torch.equal(yb[res >= 0], ryb[res >= 0])

    sargs = (coef, chain, res, dev.fink, dev.final_d)
    bm, bls, logZ = fb_circ_cuda.sv_backward_cuda(*sargs)
    rbm, rbls, rlogZ = fb_circ_cuda.sv_backward_plain(*sargs)
    assert torch.allclose(logZ, rlogZ, rtol=1e-4, atol=1e-4)
    assert torch.allclose(bm, rbm, rtol=2e-4, atol=1e-30)
    assert torch.allclose(bls, rbls, rtol=2e-4, atol=1e-6)

    cargs = (coef, chain, res, ryb, rfr, rbm, rbls, rlogZ)
    fl, tails = fb_circ_cuda.cx_forward_cuda(*cargs)
    rfl, rtails = fb_circ_cuda.cx_forward_plain(*cargs)
    assert (fl - rfl).abs().max().item() <= 2e-4
    assert (tails - rtails).abs().max().item() <= 2e-4

    off = torch.arange(comp.batch, device=cuda) * 40
    jmap, jtail = fused_flush_jmaps(dev.lo, off, dev.n, 21, Wp, d1k)
    vals, jm = concat_flush_tails(rfl, rtails, jmap, jtail)
    rg = 40 * comp.batch + 512
    out = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
    ref = bucket_scatter.scatter_lanesum_plain(vals, jm, rg)
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)


def test_default_path_kernels_match_plain(cuda):
    """R, M, L and D at a tiny shape, each on the plain version's inputs:
    R's code bands equal, M within the FB tolerances, L rtol 1e-5, D's
    pointers equal on every valid cell."""
    tables = tables_from_hmm(PairHmm.load(MODEL), cuda)
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    comp, dev = _compact(cuda, seed=4)
    Wp, D1 = comp.wp, comp.num_steps
    names = ("expand_rel", "mw_forward", "scatter_lanes", "mea_dl")
    before = {k: _build.launch_counts[k] for k in names}
    rargs = (dev.reads, dev.refs, dev.lo, dev.m, dev.n, Wp, D1)
    for got, ref in zip(fb_circ_cuda.expand_rel_cuda(*rargs),
                        fb_circ_cuda.expand_rel_plain(*rargs)):
        assert torch.equal(got, ref)

    es, _, _ = fb_circ_cuda.expand_streams_plain(
        ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, 21, Wp, D1,
        want_yb=False)
    fr, frr, lom = circ_mw_streams(dev.lo, 21, Wp, D1)
    bm, bls, logZ = fb_circ_cuda.sv_backward_plain(coef, chain, es,
                                                   dev.fink, dev.final_d)
    margs = (coef, chain, es, fr, frr, lom, bm, bls, logZ)
    got = fb_circ_cuda.mw_forward_cuda(*margs)
    ref = fb_circ_cuda.mw_forward_plain(*margs)
    assert (got[0] - ref[0]).abs().max().item() <= 2e-4
    for g, r in zip(got[1:], ref[1:]):
        assert (g - r).abs().max().item() <= 2e-3
    post, flc, flr, tc, tr = ref

    zero = torch.zeros(comp.batch, dtype=torch.int32, device=cuda)
    sums = []
    for fl, tail, (jmap, jtail), rg in (
            (flc, tc, fused_flush_jmaps(dev.lo, zero, dev.n, 21, Wp, D1),
             256),
            (flr, tr, fused_row_jmaps(dev.lo, dev.m, Wp, D1), 256)):
        vals, jm = concat_flush_tails(fl, tail, jmap, jtail)
        out = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
        sums.append(bucket_scatter.scatter_lanes_plain(vals, jm, rg))
        assert torch.allclose(out, sums[-1], rtol=1e-5, atol=1e-6)

    accc, accr = sums
    dargs = (post, dev.lo, dev.m, dev.n, 21, dev.final_d, dev.final_k,
             accr, accc, 0.5, 0.0)
    ptr, score = wavefront_cuda.mea_dl_cuda(*dargs)
    rptr, rscore = wavefront_cuda.mea_dl_plain(*dargs)
    torch.cuda.synchronize()
    valid = band_masks(dev.lo, dev.m, dev.n, 21, Wp)[0]
    assert torch.equal(ptr[valid], rptr[valid])
    assert torch.allclose(score, rscore, rtol=1e-5, atol=1e-4)
    assert (_build.launch_counts["scatter_lanes"]
            == before["scatter_lanes"] + 2)
    assert all(_build.launch_counts[k] == before[k] + 1
               for k in ("expand_rel", "mw_forward", "mea_dl"))


def _flat_gap_tables(chain_model):
    """The shipped model's tables (CPU), or (chain_model False) its
    flat-gap variant whose gap states 1 and 2 exchange mass: the generic
    5x5 branch of the circular kernels."""
    from marginalign_trna_tpu_torch.ops.fb import FbTables

    tables = tables_from_hmm(PairHmm.load(MODEL))
    if not chain_model:
        T = tables.T.numpy().copy()
        T[1, 2] = T[2, 1] = 0.05
        T /= T.sum(axis=1, keepdims=True)
        tables = FbTables(T, tables.Ematch.numpy(), tables.Egap.numpy(),
                          tables.pi.numpy())
    assert circ_coefficients(tables)[1] == chain_model
    return tables


def _ragged_compact(cuda, width, seed, n=37, pad=43, lo_len=(20, 150),
                    hi_len=(200, 320)):
    """n noisy pairs at `width`, a few of them long enough that the band
    wraps its rows more than once, packed to `pad` lanes (the lanes past n
    have m + n = 0; 43 is a multiple of neither 4 nor 8 nor 128)."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for b in range(n):
        lo_, hi_ = hi_len if b % 6 == 0 else lo_len
        ref = rng.integers(0, 4, int(rng.integers(lo_, hi_))).astype(np.int8)
        read = ref.copy()
        read[rng.random(len(read)) < 0.1] = int(rng.integers(0, 4))
        reads.append(read[: len(read) - int(rng.integers(0, 6))])
        refs.append(ref)
    comp = pack_compact_batch(reads, refs, width=width, pad_batch_to=pad)
    return comp, compact_device_batch(comp, cuda)


def _wide_lanes(cuda):
    """A lane count past 16 x the SM count, and a multiple of neither 8 nor
    16: M takes 16-lane blocks there wherever they fit."""
    return 16 * torch.cuda.get_device_properties(
        cuda).multi_processor_count + 5


def _widen(dev, B):
    """The compact batch `dev` with its lanes repeated to B lanes."""
    k = -(-B // dev.m.shape[-1])
    return type(dev)(*(
        (t.repeat(1, k) if t.dim() == 2 else t.repeat(k))[..., :B]
        .contiguous() for t in dev))


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("width", [21, 45, 93, 126])
def test_mw_forward_matches_plain(cuda, width, chain_model):
    """M (warp per lane) bit-equal to its plain version at Wp 24, 48, 96
    and 128 (one to four rows a thread), on both model branches, with both
    block sizes it takes: 43 lanes (8 a block) and past 16 x the SM count
    (16 a block where they fit, at Wp 24 and 48), dead lanes in the last
    block, lanes with m + n = 0, d1k past D1 and not a multiple of the
    staged tile, and the column and row flushes forced to rows 0 and Wp - 1
    on some diagonals."""
    tables = _flat_gap_tables(chain_model)
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.numpy().reshape(-1)
    comp, narrow = _ragged_compact(cuda, width, seed=width)
    Wp = comp.wp
    d1k = comp.num_steps + 3
    assert Wp == {21: 24, 45: 48, 93: 96, 126: 128}[width]
    assert d1k % 8 != 0 and d1k > comp.num_steps
    lanes = []
    for dev in (narrow, _widen(narrow, _wide_lanes(cuda))):
        es, _, _ = fb_circ_cuda.expand_streams_plain(
            ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, width, Wp,
            d1k, want_yb=False)
        fr, frr, lom = circ_mw_streams(dev.lo, width, Wp, d1k)
        d = torch.arange(d1k, device=cuda)
        fr = torch.where((d % 7 == 3)[:, None], 0, fr).int()
        fr = torch.where((d % 7 == 5)[:, None], Wp - 1, fr).int()
        frr = torch.where((d % 5 == 2)[:, None], 0, frr).int()
        frr = torch.where((d % 5 == 4)[:, None], Wp - 1, frr).int()
        bm, bls, logZ = fb_circ_cuda.sv_backward_plain(coef, chain, es,
                                                       dev.fink, dev.final_d)
        margs = (coef, chain, es, fr.contiguous(), frr.contiguous(), lom,
                 bm, bls, logZ)
        want = fb_circ_cuda.mw_forward_plain(*margs)
        assert want[1].abs().max().item() > 0
        assert want[2].abs().max().item() > 0
        before = _build.launch_counts["mw_forward"]
        got = fb_circ_cuda.mw_forward_cuda(*margs)
        torch.cuda.synchronize()
        B = es.shape[2]
        lanes.append(fb_circ_cuda.mw_forward_resources(
            cuda, Wp, B)["lanes_per_block"])
        for name, g, w in zip(("post", "flc", "flr", "tc", "tr"), got, want):
            assert torch.equal(g, w), (B, name, (g - w).abs().max().item())
        assert _build.launch_counts["mw_forward"] == before + 1
    assert lanes == [8, 16 if Wp <= 72 else 8]


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_mw_forward_resources(cuda, wp):
    """M takes 8 lanes a block over few lanes and 16 past 16 x the SM
    count where 16 fit (Wp <= 72), with at least one block an SM, no
    spills and no stack; at Wp 24 it keeps 32 or more warps resident an
    SM."""
    for B, lanes in ((43, 8), (_wide_lanes(cuda), 16 if wp <= 72 else 8)):
        res = fb_circ_cuda.mw_forward_resources(cuda, wp, B)
        assert res["lanes_per_block"] == lanes, res
        assert res["threads_per_block"] == 32 * lanes
        assert res["local_bytes"] == 0, res
        assert res["blocks_per_sm"] >= 1, res
        if wp == 24:
            assert res["blocks_per_sm"] * lanes >= 32, res


@pytest.mark.parametrize("want_yb", [False, True])
@pytest.mark.parametrize("wp_extra", [0, -1, 3])
def test_expand_streams_matches_plain(cuda, wp_extra, want_yb):
    """E exactly equal to its plain version (es, fr; yb on valid cells)
    with d1k past D1 (lo edge-replicated), lanes with m + n = 0, 43 lanes
    (a multiple of no block size), odd and even Wp, bands that wrap their
    rows more than once, with and without yb, its codes gathered through
    the shared-memory windows; and on offsets that jump, whose tiles span
    more than a window (those lanes read device memory)."""
    tables = tables_from_hmm(PairHmm.load(MODEL))
    ematch = tables.Ematch.numpy().reshape(-1)
    comp, dev = _ragged_compact(cuda, 21, seed=5)
    Wp = comp.wp + wp_extra
    d1k = comp.num_steps + 37
    jumped = dev.lo.clone()
    jumped[comp.num_steps // 2:, ::3] += 40
    for lo in (dev.lo, jumped.contiguous()):
        args = (ematch, dev.reads, dev.refs, lo, dev.m, dev.n, 21, Wp, d1k,
                want_yb)
        res, ryb, rfr = fb_circ_cuda.expand_streams_plain(*args)
        valid = res >= 0
        assert valid.any() and (~valid).any()
        before = _build.launch_counts["expand_streams"]
        es, yb, fr = fb_circ_cuda.expand_streams_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(es, res) and torch.equal(fr, rfr)
        assert (yb is None) == (not want_yb)
        if want_yb:
            assert torch.equal(yb[valid], ryb[valid])
        assert _build.launch_counts["expand_streams"] == before + 1


def test_expand_streams_resources(cuda):
    """E builds without spills; at Wp 24 a 128-lane block's windows take
    14.5 KB, so eight blocks fit an SM."""
    res = fb_circ_cuda.expand_streams_resources(cuda, 24)
    assert res["local_bytes"] == 0, res
    assert res["threads_per_block"] == 128
    assert res["blocks_per_sm"] >= 8, res


def test_scatter_lanes_any_targets(cuda):
    """L on targets that repeat out of order and fall outside [0, rg):
    the plain version's sums (rtol 1e-5)."""
    rng = np.random.default_rng(9)
    D, B, rg = 300, 70, 64
    jm = rng.integers(-3, rg + 3, size=(D, B)).astype(np.int32)
    jm[: D // 2] = np.sort(jm[: D // 2], axis=0)   # increasing runs first
    vals = torch.from_numpy(rng.random((D, B)).astype(np.float32)).to(cuda)
    jm = torch.from_numpy(jm).to(cuda)
    out = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
    ref = bucket_scatter.scatter_lanes_plain(vals, jm, rg)
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-6)


def _lane_patterns(rng, D, B):
    """Target streams L's chunked design must get right, one per lane
    group: runs of 1-17 equal targets straddling the 8-row chunks and
    256-row tiles, a lane of -1 only, one target over every row, distinct
    increasing targets with 24 tail rows (fewer for short D) that go back
    (in every other such lane jumping 1100 targets ahead halfway, past
    the kernel's 1024-row output window), random pads."""
    jm = np.full((D, B), -1, np.int32)
    tail = min(24, D // 2)
    n = D - tail
    for b in range(B):
        kind = b % 4
        if kind == 0:
            jm[:, b] = np.arange(D) // (1 + b % 17)
        elif kind == 1:
            jm[:, b] = -1 if b % 8 == 1 else 77
        else:
            jm[:n, b] = np.arange(n) // (kind - 1) + b
            if b % 8 == 3:
                jm[n // 2:n, b] += 1100
            jm[n:, b] = jm[n - 1, b] - (np.arange(tail) + 7 * b) % tail
    jm[(rng.random((D, B)) < 0.05) & (jm >= 0)] = -1
    return jm


@pytest.mark.parametrize("D,B", [(603, 37), (603, 36), (3096, 64), (8, 5)])
def test_scatter_lanes_edge_targets(cuda, D, B):
    """L on the target streams of `_lane_patterns` (D a multiple of neither
    the 8-row chunk nor the 256-row tile; B not a multiple of 32, with and
    without 16-byte loads): the plain version's sums (rtol 1e-5), and two
    launches bit-identical."""
    rng = np.random.default_rng(D + B)
    jm = torch.from_numpy(_lane_patterns(rng, D, B)).to(cuda)
    vals = torch.from_numpy(rng.random((D, B)).astype(np.float32)).to(cuda)
    rg = 2048
    before = _build.launch_counts["scatter_lanes"]
    out = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
    again = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
    ref = bucket_scatter.scatter_lanes_plain(vals, jm, rg)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(out, again)
    assert _build.launch_counts["scatter_lanes"] == before + 2


def test_scatter_lanes_random_targets_past_window(cuda):
    """L on random targets over an output far taller than the kernel's
    1024-row window (rows that share a window slot, targets ahead of and
    behind it): the plain version's sums (rtol 1e-5), launches
    bit-identical."""
    rng = np.random.default_rng(11)
    D, B, rg = 505, 36, 5000
    jm = torch.from_numpy(
        rng.integers(-2, rg + 2, size=(D, B)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random((D, B)).astype(np.float32)).to(cuda)
    out = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
    again = bucket_scatter.scatter_lanes_cuda(vals, jm, rg)
    ref = bucket_scatter.scatter_lanes_plain(vals, jm, rg)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(out, again)


def _em_models(ntr):
    """ntr random EM starts under fiveStateAsymmetric constraints (every
    transition, non-flat gap emissions)."""
    out = []
    for t in range(ntr):
        hmm = PairHmm.random(seed=20 + t)
        hmm.apply_model_type_constraints()
        out.append(hmm)
    return out


@pytest.mark.parametrize("ntr", [1, 3])
def test_counts_kernels_match_plain(cuda, ntr):
    """The four counts kernels on the plain versions' inputs: f_all, lsf,
    the terminal sums, the checkpoints and the posterior band bit-equal;
    the lane-summed count partials within rtol 1e-5 (the kernels sum each
    thread's rows and diagonals first, then the row threads)."""
    K = fb_counts_cuda
    tables = tables_stacked(_em_models(ntr), cuda)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    dev = device_batch(_batch(21, seed=5), cuda)
    xb, yb, valid, s1, fk, fd = fb_counts.kernel_inputs(dev)
    streams = (xb, yb, valid, s1, fk)
    names = ("counts_fwd_all", "counts_bwd", "counts_fwd_ckpt",
             "counts_bwd_ckpt")
    before = {k: _build.launch_counts[k] for k in names}

    got = K.counts_fwd_all_cuda(*tabs, *streams)
    f_all, lsf, term = K.counts_fwd_all_plain(*tabs, *streams)
    for g, r in zip(got, (f_all, lsf, term)):
        assert torch.equal(g, r)
    logZ = fb_counts.logz_from_terminal(lsf, term, fd)
    assert torch.isfinite(logZ).all()
    bargs = (*tabs, f_all, lsf, *streams, fd, logZ)
    post, tcp, egp = K.counts_bwd_cuda(*bargs)
    rpost, rtcp, regp = K.counts_bwd_plain(*bargs)
    assert torch.equal(post, rpost)
    for g, r in ((tcp, rtcp), (egp, regp)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)

    got = K.counts_fwd_ckpt_cuda(*tabs, *streams)
    ref = K.counts_fwd_ckpt_plain(*tabs, *streams)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(ref[2], lsf) and torch.equal(ref[3], term)
    cargs = (*tabs, ref[0], ref[1], *streams, fd, logZ)
    for g, r in zip(K.counts_bwd_ckpt_cuda(*cargs),
                    K.counts_bwd_ckpt_plain(*cargs)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)


def _narrow(streams, wp):
    """The first wp band rows of (xb, yb, valid, s1, fink): a band of wp
    rows, which the kernels take whatever the packer's padding."""
    xb, yb, valid, s1, fk = streams
    assert int(fk.max()) < wp
    return tuple(a[:, :wp].contiguous() for a in (xb, yb, valid)) + (s1, fk)


@pytest.mark.parametrize("ntr", [1, 3])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_counts_ckpt_backward_band_widths(cuda, ntr, wp):
    """counts_bwd_ckpt and counts_multi_bwd_ckpt (one band row per thread
    of a warp: Wp 9 leaves 23 rows idle, Wp 32 none) on their plain
    forwards' checkpoints: the lane-summed counts within rtol 1e-5 of the
    plain versions, and each launch counted."""
    K = fb_counts_cuda
    tables = tables_stacked(_em_models(ntr), cuda)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    width = {9: 7, 24: 21, 32: 29}[wp]
    dev = device_batch(_batch(width, seed=5), cuda)
    xb, yb, valid, s1, fk, fd = fb_counts.kernel_inputs(dev)
    streams = _narrow((xb, yb, valid, s1, fk), wp)
    ref = K.counts_fwd_ckpt_plain(*tabs, *streams)
    logZ = fb_counts.logz_from_terminal(ref[2], ref[3], fd)
    cargs = (*tabs, ref[0], ref[1], *streams, fd, logZ)
    before = _build.launch_counts["counts_bwd_ckpt"]
    for g, r in zip(K.counts_bwd_ckpt_cuda(*cargs),
                    K.counts_bwd_ckpt_plain(*cargs)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)
    assert _build.launch_counts["counts_bwd_ckpt"] == before + 1

    mb, mdev = _multi(cuda, width, seed=9, n=40)
    *mstreams, mfk, mfd = fb_counts.multi_kernel_inputs(mdev)
    xb, yb, valid, s1, start = mstreams
    assert int(mfk.max()) < wp
    mstreams = tuple(a[:, :wp].contiguous() for a in (xb, yb, valid)) + (
        s1, start, mfk)
    ref = K.counts_multi_fwd_ckpt_plain(*tabs, *mstreams)
    L, _ = multi_logz(ref[2], ref[3], mdev)
    cargs = (*tabs, ref[0], ref[1], *mstreams, mfd, L)
    before = _build.launch_counts["counts_multi_bwd_ckpt"]
    for g, r in zip(K.counts_multi_bwd_ckpt_cuda(*cargs),
                    K.counts_multi_bwd_ckpt_plain(*cargs)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert _build.launch_counts["counts_multi_bwd_ckpt"] == before + 1


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_ckpt_backward_resources(cuda, multi, wp):
    """The checkpoint backward builds without spills and fits at least one
    block per SM at every band width; its registers, shared memory and
    residency are what the smoke reports."""
    res = fb_counts_cuda.ckpt_backward_resources(cuda, wp, multi)
    assert res["local_bytes"] == 0
    assert res["registers"] > 0 and res["blocks_per_sm"] >= 1
    assert res["threads_per_block"] % 32 == 0


@pytest.mark.parametrize("kernel", ["stored", "ckpt"])
def test_serial_counts_on_card_match_cpu(cuda, kernel):
    """One model's counts (a serial EM trial: [5, 5] tables, trials axis 1)
    through the kernels equal the plain versions' on the CPU: logZ within
    1e-4, counts within rtol 1e-5."""
    hmm = _em_models(1)[0]
    batch = _batch(21, seed=6)
    got = fb_counts.counts(tables_from_hmm(hmm, cuda),
                           device_batch(batch, cuda), kernel=kernel)
    want = fb_counts.counts(tables_from_hmm(hmm), device_batch(batch, "cpu"),
                            kernel=kernel)
    assert torch.allclose(got.logZ.cpu(), want.logZ, rtol=1e-4, atol=1e-4)
    for g, w in ((got.trans_counts, want.trans_counts),
                 (got.emit_gap, want.emit_gap)):
        assert torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-5)
    assert (got.posteriors is None) == (kernel == "ckpt")


def test_generic_kernels_match_plain(cuda):
    """fb_generic_fwd and fb_generic_bwd on a model whose gap emissions are
    not flat, each on the plain versions' inputs: F_match, lsf, the terminal
    sums and the posterior band bit-equal; posteriors_generic on the card
    within the FB tolerances of the CPU's."""
    from marginalign_trna_tpu_torch.ops import fb_generic_cuda as G

    hmm = PairHmm.load(MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    tables = tables_from_hmm(hmm, cuda)
    assert not fb_cuda.has_flat_gap_emissions(tables)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    batch = _batch(21, seed=7)
    dev = device_batch(batch, cuda)
    xb, yb, valid, s1, fk, fd = fb_counts.kernel_inputs(dev)
    streams = (xb, yb, valid, s1, fk)
    names = ("fb_generic_fwd", "fb_generic_bwd")
    before = {k: _build.launch_counts[k] for k in names}
    ref = G.fb_generic_fwd_plain(*tabs, *streams)
    for g, r in zip(G.fb_generic_fwd_cuda(*tabs, *streams), ref):
        assert torch.equal(g, r)
    fm, lsf, term = ref
    logZ = fb_counts.logz_from_terminal(lsf[None], term[None], fd)[0]
    assert torch.isfinite(logZ).all()
    bargs = (*tabs, fm, lsf, *streams, fd, logZ)
    assert torch.equal(G.fb_generic_bwd_cuda(*bargs),
                       G.fb_generic_bwd_plain(*bargs))
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)
    got = G.posteriors_generic(tables, dev)
    want = G.posteriors_generic(tables_from_hmm(hmm),
                                device_batch(batch, "cpu"))
    assert torch.allclose(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    assert (got[1].cpu() - want[1]).abs().max().item() <= 2e-4


def _serve_kernels_match_plain(cuda, tables, batch):
    """Each serving kernel on the plain versions' inputs for `batch`:
    every output bit-equal, one launch each; and posteriors_circ on the
    card in every mode within the FB tolerances of the CPU's."""
    from marginalign_trna_tpu_torch.ops.fb import circ_device_batch
    from marginalign_trna_tpu_torch.ops.fb_circ import (
        SERVE_MODES, emission_stream, posteriors_circ,
    )

    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.numpy().reshape(-1)
    cdev = circ_device_batch(batch, device_batch(batch, cuda))
    xb, yb, fink, find = cdev.xb, cdev.yb, cdev.fink, cdev.final_d
    valid = cdev.valid.view(torch.int8)
    es = emission_stream(table, xb, yb, cdev.valid, True)
    em = emission_stream(table, xb, yb, cdev.valid, False)
    back = fb_circ_cuda.sv_backward_plain(coef, chain, es, fink, find)
    codes = (coef, chain, table, xb, yb, valid)
    kb = fb_circ_cuda.ckpt_block(xb.shape[1])
    ck = fb_circ_cuda.circ_ckpt_backward_plain(*codes, fink, find, kb)
    cases = {
        "circ_backward_emv": (coef, chain, em, valid, fink, find),
        "circ_backward_codes": (*codes, fink, find),
        "circ_backward_codes_es": (*codes, fink, find),
        "circ_post_es": (coef, chain, es, *back),
        "circ_post_emv": (coef, chain, em, valid, *back),
        "circ_post_codes": (*codes, *back),
        "circ_ckpt_backward": (*codes, fink, find, kb),
        "circ_ckpt_post": (*codes, fink, find, *ck, kb),
    }
    for name, args in cases.items():
        before = _build.launch_counts[name]
        got = getattr(fb_circ_cuda, name + "_cuda")(*args)
        want = getattr(fb_circ_cuda, name + "_plain")(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        assert _build.launch_counts[name] == before + 1
    cpu = circ_device_batch(batch, device_batch(batch, "cpu"))
    for mode in SERVE_MODES:
        logZ, post = posteriors_circ(tables, cdev, mode)
        rlogZ, rpost = posteriors_circ(tables, cpu, mode)
        assert torch.allclose(logZ.cpu(), rlogZ, rtol=1e-4, atol=1e-4)
        assert (post.cpu() - rpost).abs().max().item() <= 2e-4


@pytest.mark.parametrize("chain_model", [True, False])
def test_serve_kernels_match_plain(cuda, chain_model):
    """The serving kernels (csrc/fb_serve.cu: circ_backward_emv / _codes /
    _codes_es, circ_post_es / _emv / _codes; csrc/fb_ckpt.cu:
    circ_ckpt_backward, circ_ckpt_post) on the shipped model and on its
    flat-gap variant whose gap states 1 and 2 exchange mass (the generic
    branch) at width 21 (Wp 24, the checkpoint pass's tiles in shared
    memory)."""
    _serve_kernels_match_plain(cuda, _flat_gap_tables(chain_model),
                               _batch(21, seed=8))


@pytest.mark.parametrize("width", [61, 126])
def test_serve_kernels_wide_bands(cuda, width):
    """The serving kernels at Wp 64 and 128 (two and four rows per
    thread), 32 diagonals a checkpoint; the checkpoint posterior pass
    keeps its tiles in shared memory at Wp 64 (4 lanes a block) and in
    device memory at Wp 128."""
    Wp = padded_band_width(width)
    assert fb_circ_cuda.ckpt_block(Wp) == 32
    assert not fb_circ_cuda._replay_fits(Wp, 32)
    _serve_kernels_match_plain(cuda, tables_from_hmm(PairHmm.load(MODEL)),
                               _batch(width, seed=8))


def _multi(cuda, width, seed=7, n=30, steps=256):
    """A multi-problem batch of n noisy pairs of 20-90 bases (lanes
    shared) in lanes of `steps` diagonals, on the card."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, int(rng.integers(20, 90))).astype(np.int8)
            for _ in range(n)]
    reads = []
    for r in refs:
        read = np.delete(r, [len(r) // 2]).copy()
        read[rng.random(len(read)) < 0.1] = int(rng.integers(0, 4))
        reads.append(read)
    mb = pack_multi_banded_batch(reads, refs, width=width,
                                 pad_steps_to=steps)
    assert len({p.lane for p in mb.problems}) < n
    return mb, multi_device_batch(mb, cuda)


@pytest.mark.parametrize("width", [9, 40])
def test_nw_multi_kernel_matches_plain(cuda, width):
    _, mdev = _multi(cuda, width)
    args = ((1.0, -2.0, -3.0, -1.0), mdev.xb, mdev.yb, mdev.valid, mdev.s1,
            mdev.s2, mdev.start, mdev.fink, mdev.find)
    before = _build.launch_counts["nw_multi"]
    got = wavefront_cuda.nw_multi_cuda(*args)
    ref = wavefront_cuda.nw_multi_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["nw_multi"] == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("chain_model", [True, False])
def test_fb_multi_kernels_match_plain(cuda, chain_model):
    """Both model branches: the shipped gap-chain model and a flat-gap
    model whose gap states 1 and 2 exchange mass; bit-equal."""
    hmm = PairHmm.load(MODEL)
    if not chain_model:
        T = np.asarray(hmm.transitions, np.float64).copy()
        T[1, 2] = T[2, 1] = 0.05
        hmm.transitions = T / T.sum(axis=1, keepdims=True)
    tables = tables_from_hmm(hmm, cuda)
    coef, chain = circ_coefficients(tables)
    assert chain == chain_model
    _, mdev = _multi(cuda, 21)
    em = tables.Ematch[mdev.xb.long(), mdev.yb.long()] * mdev.valid
    fargs = (coef, chain, em, mdev.valid, mdev.s1, mdev.start, mdev.fink)
    got = fb_multi_cuda.fb_multi_forward_cuda(*fargs)
    ref = fb_multi_cuda.fb_multi_forward_plain(*fargs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    fm, lsf, term = ref
    L = (torch.log(term.clamp(min=1e-30)) + lsf).gather(
        0, mdev.step_final.long())
    bargs = (coef, chain, fm, lsf, L, em, mdev.valid, mdev.s1, mdev.fink,
             mdev.find)
    post = fb_multi_cuda.fb_multi_backward_cuda(*bargs)
    assert torch.equal(post, fb_multi_cuda.fb_multi_backward_plain(*bargs))
    assert torch.isfinite(post).all()


def _multi_tables(cuda, chain_model):
    """The shipped model, or (chain_model False) its flat-gap variant whose
    gap states 1 and 2 exchange mass (the generic 5x5 branch)."""
    hmm = PairHmm.load(MODEL)
    if not chain_model:
        T = np.asarray(hmm.transitions, np.float64).copy()
        T[1, 2] = T[2, 1] = 0.05
        hmm.transitions = T / T.sum(axis=1, keepdims=True)
    return tables_from_hmm(hmm, cuda)


def _fb_multi_equal(cuda, chain_model, width, B, steps=256, seed=7):
    """The multi-lane FB pair on `_multi`'s packed lanes of `steps`
    diagonals at `width`, repeated to B lanes: the forward against its
    plain version (fm, lsf, term), the backward on the plain forward's
    outputs and chained on the kernel's own, every output bit for bit, one
    launch each counted."""
    tables = _multi_tables(cuda, chain_model)
    coef, chain = circ_coefficients(tables)
    assert chain == chain_model
    _, mdev = _multi(cuda, width, seed=seed, steps=steps)

    def lanes(t):
        reps = -(-B // t.shape[-1])
        return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :B].contiguous()

    xb, yb, valid, s1, start, fink, find, sf = (lanes(t) for t in (
        mdev.xb, mdev.yb, mdev.valid, mdev.s1, mdev.start, mdev.fink,
        mdev.find, mdev.step_final))
    em = tables.Ematch[xb.long(), yb.long()] * valid
    fargs = (coef, chain, em, valid, s1, start, fink)
    names = ("fb_multi_forward", "fb_multi_backward")
    before = [_build.launch_counts[k] for k in names]
    got = fb_multi_cuda.fb_multi_forward_cuda(*fargs)
    want = fb_multi_cuda.fb_multi_forward_plain(*fargs)
    for g, w in zip(got, want):
        _same_bits(g, w)
    fm, lsf, term = want
    L = (torch.log(term.clamp(min=1e-30)) + lsf).gather(0, sf.long())
    bargs = (coef, chain, fm, lsf, L, em, valid, s1, fink, find)
    post = fb_multi_cuda.fb_multi_backward_cuda(*bargs)
    torch.cuda.synchronize()
    assert [_build.launch_counts[k] for k in names] == [n + 1 for n in before]
    rpost = fb_multi_cuda.fb_multi_backward_plain(*bargs)
    _same_bits(post, rpost)
    _same_bits(fb_multi_cuda.fb_multi_backward_cuda(
        *bargs[:2], got[0], got[1], L, *bargs[5:]), rpost)
    assert torch.isfinite(post).all() and float(post.max()) > 0.5


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("B", [61, 62, 63])
def test_fb_multi_unaligned_lanes(cuda, chain_model, B):
    """The multi-lane FB pair at lane counts of 1, 2 and 3 modulo 4 (em by
    cp.async, valid and start byte by byte), over 250 diagonals (a partial
    tile), on both model branches."""
    _fb_multi_equal(cuda, chain_model, 21, B, steps=250)


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("extra", [5, 8])
def test_fb_multi_full_card(cuda, chain_model, extra):
    """The multi-lane FB pair past 16 x the SM count lanes (16 lanes a
    block), by cp.async and by TMA, on both model branches."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = 16 * sms + extra
    for backward in (True, False):
        res = fb_multi_cuda.fb_multi_resources(cuda, 24, B, backward)
        assert res["lanes_per_block"] == 16, res
    _fb_multi_equal(cuda, chain_model, 21, B)


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("width", [45, 93, 126])
def test_fb_multi_wide_bands(cuda, chain_model, width):
    """The multi-lane FB pair at Wp 48, 96 and 128 (two to four rows a
    thread; TMA at Wp 48, cp.async above), on both model branches."""
    _fb_multi_equal(cuda, chain_model, width, 64)


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_fb_multi_resources(cuda, wp):
    """fb_multi_forward and fb_multi_backward serve every Wp <= 128 at 8
    lanes a block and at 16 where csrc/fb_rel.cuh `rel_lanes` takes them (the
    forward up to two rows a thread, the backward at one), at least one
    block an SM, no spill and no stack up to two rows a thread.  The multi
    paths' 1024-diagonal lanes take 8 lanes a block at 1024 lanes, 16 at
    4096 and 8192."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for backward in (True, False):
        for lanes in (8, 16):
            res = fb_multi_cuda.fb_multi_resources(cuda, wp, lanes * sms,
                                                   backward)
            if res["lanes_per_block"] < lanes:
                continue    # 16 lanes do not fit at this Wp
            assert res["lanes_per_block"] == lanes, res
            assert res["threads_per_block"] == 32 * lanes
            assert res["blocks_per_sm"] >= 1, res
            assert res["registers"] <= 65536 // (32 * lanes), res
            assert 0 < res["smem_per_block"] <= 232448, res
            if wp <= 64:
                assert res["local_bytes"] == 0, res
        for B, lanes in ((1024, 8), (4096, 16), (8192, 16)):
            res = fb_multi_cuda.fb_multi_resources(cuda, 24, B, backward)
            assert res["lanes_per_block"] == lanes, (B, res)


def test_mea_multi_kernel_matches_plain(cuda):
    mb, mdev = _multi(cuda, 21, seed=8)
    tables = tables_from_hmm(PairHmm.load(MODEL), cuda)
    _, post = fb_multi_cuda.posteriors_multi(tables, mdev)
    wdiag = torch.where(post > 0, post, NEG)
    gap = 0.5 * (1.0 - post).clamp(0.0, 1.0)
    args = (wdiag, gap, gap.flip(1).contiguous(), mdev.valid, mdev.s1,
            mdev.s2, mdev.start, mdev.fink, mdev.find)
    got = wavefront_cuda.mea_multi_cuda(*args)
    ref = wavefront_cuda.mea_multi_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _repeat_lanes(t, B):
    """t [..., lanes] repeated along its lanes to B lanes."""
    reps = -(-B // t.shape[-1])
    return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :B].contiguous()


def _multi_mixed(cuda, width, B, seed):
    """A multi-problem batch of 24 noisy pairs of 20-90 bases and one of
    ~120 (alone in its lane of 256 diagonals, beside lanes of several),
    its lanes repeated to B, on the card; nw_multi's and mea_multi's
    arguments on it (mea_multi's weights random: wdiag in [0, 1) with 20%
    NEG, wup and wleft in [0, 0.5))."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(20, 90)) for _ in range(24)] + [120]
    refs = [rng.integers(0, 4, n).astype(np.int8) for n in sizes]
    reads = []
    for r in refs:
        read = np.delete(r, [len(r) // 2]).copy()
        read[rng.random(len(read)) < 0.1] = int(rng.integers(0, 4))
        reads.append(read)
    mb = pack_multi_banded_batch(reads, refs, width=width, pad_steps_to=256)
    per_lane = np.bincount([p.lane for p in mb.problems])
    assert per_lane.min() == 1 and per_lane.max() > 1, per_lane
    mdev = multi_device_batch(mb, cuda)
    streams = [_repeat_lanes(t, B) for t in (
        mdev.xb, mdev.yb, mdev.valid, mdev.s1, mdev.s2, mdev.start,
        mdev.fink, mdev.find)]
    xb, yb, valid, s1, s2, start, fink, find = streams
    shape = tuple(xb.shape)
    wdiag = torch.from_numpy(rng.random(shape).astype(np.float32))
    wdiag[torch.from_numpy(rng.random(shape) < 0.2)] = NEG
    wup, wleft = (torch.from_numpy(
        (rng.random(shape) * 0.5).astype(np.float32)) for _ in range(2))
    nw = ((1.0, -2.0, -3.0, -1.0), xb, yb, valid, s1, s2, start, fink, find)
    mea = (wdiag.to(cuda), wup.to(cuda), wleft.to(cuda), valid, s1, s2,
           start, fink, find)
    return nw, mea


def _multi_wave_equal(cuda, name, args):
    """nw_multi or mea_multi against its plain version: pointers and term
    bit for bit, one launch."""
    before = _build.launch_counts[name]
    got = getattr(wavefront_cuda, name + "_cuda")(*args)
    ref = getattr(wavefront_cuda, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), (name, i)


_MULTI_WIDTHS = {"Wp24": 21, "Wp48": 40, "Wp96": 93, "Wp128": 126}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("wp", list(_MULTI_WIDTHS))
def test_nw_multi_warp_cases(cuda, wp, wide, aligned):
    """nw_multi, K1's kernel with the MULTI flag, at Wp 24 / 48 / 96 / 128
    (a quarter of a warp a lane up to Wp 24, half up to 48, a warp above)
    and at both block sizes it takes there (8 or 16 warps' worth of
    lanes), over lane counts that are no multiple of either (a multiple of
    4 or not: rows copied as words or byte by byte), with a lane of one
    problem beside lanes of several: pointers and term bit-equal to
    plain."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = (64 * sms if wide else 45) + (4 if aligned else 5)
    width = _MULTI_WIDTHS[wp]
    nw, _ = _multi_mixed(cuda, width, B, seed=width + B)
    Wp = nw[1].shape[1]
    T = 8 if Wp <= 24 else (16 if Wp <= 48 else 32)
    res = wavefront_cuda.warp_lane_resources("nw_multi", cuda, Wp, B)
    assert res["threads_per_lane"] == T, res
    assert res["lanes_per_block"] == (32 // T) * (16 if wide else 8), res
    _multi_wave_equal(cuda, "nw_multi", nw)


@pytest.mark.parametrize("case", ["narrow_tma", "narrow_cp_async",
                                  "mid_tma", "wide_cp_async"])
@pytest.mark.parametrize("wp", list(_MULTI_WIDTHS))
def test_mea_multi_warp_cases(cuda, wp, case):
    """mea_multi, K4's kernel with the MULTI flag, at Wp 24 / 48 / 96 / 128
    over lane counts that give each block size `mea_lanes` takes (half a
    warp a lane up to Wp 32: 16 or 32 lanes a block; a warp a lane above:
    8, 16, or 32 at one row a thread), no multiple of them, B a multiple of
    4 (TMA up to Wp 64) or not (cp.async), with a lane of one problem
    beside lanes of several: pointers and term bit-equal to plain."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = {"narrow_tma": 44, "narrow_cp_async": 45, "mid_tma": 16 * sms + 4,
         "wide_cp_async": 32 * sms + 5}[case]
    width = _MULTI_WIDTHS[wp]
    _, mea = _multi_mixed(cuda, width, B, seed=width + B)
    Wp = mea[0].shape[1]
    res = wavefront_cuda.warp_lane_resources("mea_multi", cuda, Wp, B)
    assert res["threads_per_lane"] == (16 if Wp <= 32 else 32), res
    if case.startswith("narrow"):
        assert res["lanes_per_block"] == (16 if Wp <= 32 else 8), res
    _multi_wave_equal(cuda, "mea_multi", mea)


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_wavefront_multi_resources(cuda, wp):
    """nw_multi and mea_multi: one block an SM at least over 1024, 4096
    and 32 x SMs + 5 lanes, no local memory up to Wp 64; at the multi
    batch's 4096 lanes and Wp 24 mea_multi takes half a warp a lane and 32
    lanes a block, nw_multi a quarter and 32 lanes; ptxas reports no spill
    in any multi instance and no stack frame in those serving Wp <= 64 (a
    half or a quarter of a warp a lane, or one or two rows of a warp)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name in ("nw_multi", "mea_multi"):
        for B in (1024, 4096, 32 * sms + 5):
            res = wavefront_cuda.warp_lane_resources(name, cuda, wp, B)
            assert res["blocks_per_sm"] >= 1, (name, B, res)
            if wp <= 64:
                assert res["local_bytes"] == 0, (name, B, res)
    if wp == 24:
        for name, lanes, T in (("mea_multi", 32, 16), ("nw_multi", 32, 8)):
            res = wavefront_cuda.warp_lane_resources(name, cuda, 24, 4096)
            assert res["lanes_per_block"] == lanes, (name, res)
            assert res["threads_per_lane"] == T, (name, res)
    fn, frames = None, {}
    for line in _build.build_log().splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif "spill stores" in line and fn:
            if ("nw_kernelI" in fn or "mea_warp_kernelI" in fn) \
                    and "Lb1ELi" in fn:
                frames[fn] = [int(x) for x in line.split()
                              if x.isdigit()][:3]
            fn = None
    # Both kernels at a half (and nw_multi a quarter) of a warp and a warp a
    # lane, each at two block sizes or more, one to four rows a thread.
    assert len(frames) >= 16, frames
    for f, (stack, stores, loads) in frames.items():
        assert stores == 0 and loads == 0, (f, stack, stores, loads)
        if "Li16EEEv" in f or "Li8EEEv" in f or (
                ("kernelILi1E" in f or "kernelILi2E" in f)
                and "Li32EEEv" in f):
            assert stack == 0, (f, stack)


@pytest.mark.parametrize("ntr", [1, 3])
def test_counts_multi_kernels_match_plain(cuda, ntr):
    """The four multi-lane counts kernels on the plain versions' inputs, on
    lanes of three or more problems at width 21 (Wp 24): f_all, lsf, the
    terminal sums, the checkpoints and the posterior band bit-equal; the
    lane-summed count partials within rtol 1e-5."""
    K = fb_counts_cuda
    tables = tables_stacked(_em_models(ntr), cuda)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    mb, mdev = _multi(cuda, 21, seed=9, n=40)
    assert max(np.bincount([p.lane for p in mb.problems])) >= 3
    *streams, fk, fd = fb_counts.multi_kernel_inputs(mdev)
    streams = (*streams, fk)
    names = ("counts_multi_fwd_all", "counts_multi_bwd",
             "counts_multi_fwd_ckpt", "counts_multi_bwd_ckpt")
    before = {k: _build.launch_counts[k] for k in names}

    got = K.counts_multi_fwd_all_cuda(*tabs, *streams)
    f_all, lsf, term = K.counts_multi_fwd_all_plain(*tabs, *streams)
    for g, r in zip(got, (f_all, lsf, term)):
        assert torch.equal(g, r)
    L, logZ = multi_logz(lsf, term, mdev)
    assert torch.isfinite(logZ).all() and logZ.shape == (ntr, len(mb.problems))
    bargs = (*tabs, f_all, lsf, *streams, fd, L)
    post, tcp, egp = K.counts_multi_bwd_cuda(*bargs)
    rpost, rtcp, regp = K.counts_multi_bwd_plain(*bargs)
    assert torch.equal(post, rpost)
    for g, r in ((tcp, rtcp), (egp, regp)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)

    got = K.counts_multi_fwd_ckpt_cuda(*tabs, *streams)
    ref = K.counts_multi_fwd_ckpt_plain(*tabs, *streams)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(ref[2], lsf) and torch.equal(ref[3], term)
    cargs = (*tabs, ref[0], ref[1], *streams, fd, L)
    for g, r in zip(K.counts_multi_bwd_ckpt_cuda(*cargs),
                    K.counts_multi_bwd_ckpt_plain(*cargs)):
        assert torch.allclose(g.sum(-1), r.sum(-1), rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)


@pytest.mark.parametrize("kernel", ["stored", "ckpt"])
def test_serial_counts_multi_on_card_match_cpu(cuda, kernel):
    """One model's counts over multi-problem lanes (a serial trial) through
    the kernels equal the plain versions' on the CPU: per-problem logZ
    within 1e-4, counts within rtol 1e-5."""
    hmm = _em_models(1)[0]
    mb, mdev = _multi(cuda, 21, seed=10)
    got = fb_counts.counts_multi(tables_from_hmm(hmm, cuda), mdev,
                                 kernel=kernel)
    want = fb_counts.counts_multi(tables_from_hmm(hmm),
                                  multi_device_batch(mb, "cpu"),
                                  kernel=kernel)
    assert torch.allclose(got.logZ.cpu(), want.logZ, rtol=1e-4, atol=1e-4)
    for g, w in ((got.trans_counts, want.trans_counts),
                 (got.emit_gap, want.emit_gap)):
        assert torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-5)
    assert (got.posteriors is None) == (kernel == "ckpt")


# ------------------------------------------ K1 and D: one warp per lane


def _t(cuda, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)


def _lanes_at(cuda, lanes, aligned):
    """A lane count at which K1 and D take `lanes` lanes a block
    (csrc/common.cuh `warp_lanes`: 16 from 16 x the SM count on, else 8),
    a multiple of 4 (rows copied as words) or not (byte by byte) but of no
    block size."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return (16 * sms if lanes == 16 else 5 * lanes) + (4 if aligned else 5)


def _random_nw(cuda, D1, wp, B, seed):
    """K1's inputs at random: codes 0-4, 80% valid cells, shifts s1 in
    {-1, 0, 1, 2} and s2 in {-1, ..., 3} (every branch of the row shifts;
    the plain version leaves rows in place for shifts other than +-1),
    terminals on any diagonal (every fifth at d = 0) and any band row."""
    rng = np.random.default_rng(seed)
    final_d = rng.integers(0, D1, B).astype(np.int32)
    final_d[::5] = 0
    return ((1.0, -2.0, -3.0, -1.0),
            _t(cuda, rng.integers(0, 5, (D1, wp, B)).astype(np.int8)),
            _t(cuda, rng.integers(0, 5, (D1, wp, B)).astype(np.int8)),
            _t(cuda, rng.random((D1, wp, B)) < 0.8),
            _t(cuda, rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05],
                                size=(D1, B)).astype(np.int32)),
            _t(cuda, rng.integers(-1, 4, (D1, B)).astype(np.int32)),
            _t(cuda, final_d),
            _t(cuda, rng.integers(0, wp, B).astype(np.int32)))


def _random_dl(cuda, D1, wp, B, seed):
    """D's inputs at random: a band whose lower edge lo steps by 0 or 1 and
    now and then by -1 or 2 (where the kernel seeds its windows again),
    posteriors in [0, 1) with 20% zeros, every seventh lane with m = 0 and
    another with n = 0, sums in [0, 1.3) (the gap weight's clip) with half
    as many rows as the band reaches (the rgm - 1 / rgn - 1 clip),
    terminals on any diagonal (every fifth at d = 0) and any band row."""
    rng = np.random.default_rng(seed)
    width = wp - 3
    step = rng.choice([-1, 0, 1, 2], p=[.03, .47, .47, .03], size=(D1, B))
    step[0] = 0
    lo = np.cumsum(step, axis=0) - rng.integers(0, width, B)[None, :]
    m = rng.integers(0, D1, B).astype(np.int32)
    n = rng.integers(0, D1, B).astype(np.int32)
    m[1::7] = 0
    n[2::7] = 0
    post = rng.random((D1, wp, B)).astype(np.float32)
    post[rng.random(post.shape) < 0.2] = 0
    rgm, rgn = max(1, int(m.max()) // 2), max(1, int(n.max()) // 2)
    final_d = rng.integers(0, D1, B).astype(np.int32)
    final_d[::5] = 0
    return (_t(cuda, post), _t(cuda, lo.astype(np.int32)), _t(cuda, m),
            _t(cuda, n), width, _t(cuda, final_d),
            _t(cuda, rng.integers(0, wp, B).astype(np.int32)),
            _t(cuda, (rng.random((rgm, B)) * 1.3).astype(np.float32)),
            _t(cuda, (rng.random((rgn, B)) * 1.3).astype(np.float32)),
            0.5, 0.05)


WARP_KERNELS = {
    "banded_nw": (_random_nw, wavefront_cuda.banded_nw_cuda,
                  wavefront_cuda.banded_nw_plain),
    "mea_dl": (_random_dl, wavefront_cuda.mea_dl_cuda,
               wavefront_cuda.mea_dl_plain),
}


def _warp_kernel_equal(cuda, name, D1, wp, B, seed):
    make, kernel, plain = WARP_KERNELS[name]
    args = make(cuda, D1, wp, B, seed)
    before = _build.launch_counts[name]
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (name, D1, wp, B, i)


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("wp", [24, 48, 96, 128])
@pytest.mark.parametrize("name", ["banded_nw", "mea_dl"])
def test_warp_kernels_random_inputs(cuda, name, wp, B):
    """K1 and D bit-equal to their plain versions on every cell (pointers,
    scores, K1's final states) at every rows-a-thread count, over lane
    counts that are no multiple of the lanes a block, 67 diagonals (a
    partial last tile)."""
    _warp_kernel_equal(cuda, name, 67, wp, B, seed=wp + B)


@pytest.mark.parametrize("D1", [1, 2])
@pytest.mark.parametrize("name", ["banded_nw", "mea_dl"])
def test_warp_kernels_short_bands(cuda, name, D1):
    """K1 and D over one or two diagonals (terminals at d = 0 and 1)."""
    for wp in (24, 48):
        _warp_kernel_equal(cuda, name, D1, wp, 33, seed=D1)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("name", ["banded_nw", "mea_dl"])
def test_warp_kernels_lanes_a_block(cuda, name, lanes, aligned):
    """K1 and D at each block size they take, their rows copied as words
    (lanes a multiple of 4) and byte by byte, bit-equal to plain."""
    B = _lanes_at(cuda, lanes, aligned)
    res = wavefront_cuda.warp_lane_resources(name, cuda, 48, B)
    assert res["lanes_per_block"] == lanes, res
    _warp_kernel_equal(cuda, name, 40, 48, B, seed=lanes)


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
@pytest.mark.parametrize("name", ["banded_nw", "mea_dl"])
def test_warp_kernels_resources(cuda, name, wp):
    """K1 and D serve every Wp <= 128 at 8 lanes a block and over many
    lanes at 16, with at least one block an SM; no spills and no stack at
    Wp 24 and 48."""
    for lanes in (8, 16):
        res = wavefront_cuda.warp_lane_resources(
            name, cuda, wp, _lanes_at(cuda, lanes, True))
        assert res["lanes_per_block"] == lanes, res
        assert res["threads_per_block"] == 32 * lanes
        assert res["blocks_per_sm"] >= 1, res
        if wp <= 48:
            assert res["local_bytes"] == 0, res


# ------------------------------------------ S: one warp per lane; R: tiles


def _random_sv(cuda, d1k, wp, B, chain_model, seed):
    """S's inputs at random: es with 25% invalid cells (-1) and emissions
    in [0, 0.6) elsewhere, terminal rows on any band row and terminal
    diagonals at 0, at d1k - 1, on a rescale edge (8), on a tile edge
    (16, the first diagonal of the second tile) and anywhere."""
    rng = np.random.default_rng(seed)
    es = (rng.random((d1k, wp, B)) * 0.6).astype(np.float32)
    es[rng.random(es.shape) < 0.25] = -1.0
    find = rng.integers(0, d1k, B).astype(np.int32)
    find[::5] = 0
    find[1::5] = d1k - 1
    find[2::5] = min(8, d1k - 1)
    find[3::5] = min(16, d1k - 1)
    coef, chain = circ_coefficients(_flat_gap_tables(chain_model))
    return (coef, chain, _t(cuda, es),
            _t(cuda, rng.integers(0, wp, B).astype(np.int32)),
            _t(cuda, find))


def _sv_equal(cuda, d1k, wp, B, chain_model, seed):
    args = _random_sv(cuda, d1k, wp, B, chain_model, seed)
    before = _build.launch_counts["sv_backward"]
    got = fb_circ_cuda.sv_backward_cuda(*args)
    want = fb_circ_cuda.sv_backward_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["sv_backward"] == before + 1
    for name, g, w in zip(("bm", "bls", "logZ"), got, want):
        assert torch.equal(g, w), (name, d1k, wp, B, chain_model)


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_sv_backward_random_inputs(cuda, wp, B, chain_model):
    """S bit-equal to its plain version (bm, bls, logZ) at every
    rows-a-thread count, over lane counts that are no multiple of the
    lanes a block, both branches, 67 diagonals (a partial top tile)."""
    _sv_equal(cuda, 67, wp, B, chain_model, seed=wp + B)


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("d1k", [1, 2, 8, 16, 17])
def test_sv_backward_short_bands(cuda, d1k, chain_model):
    """S over one or two diagonals, part of a tile, a whole tile and a
    tile and one diagonal."""
    for wp in (24, 48):
        _sv_equal(cuda, d1k, wp, 33, chain_model, seed=d1k)


@pytest.mark.parametrize("lanes", [8, 16])
def test_sv_backward_lanes_a_block(cuda, lanes):
    """S at each block size it takes (common.cuh `warp_lanes`)."""
    B = _lanes_at(cuda, lanes, aligned=False)
    res = fb_circ_cuda.sv_backward_resources(cuda, 24, B)
    assert res["lanes_per_block"] == lanes, res
    _sv_equal(cuda, 40, 24, B, True, seed=lanes)


def _random_rel(cuda, d1k, wp, B, seed):
    """R's inputs, guide-like: lo steps by 0 or 1 on most diagonals and
    jumps by 2 to 40 (or back by 1) now and then, so that some tiles span
    more than a window and read device memory; D1 < d1k (lo
    edge-replicated past D1); every seventh lane with m = 0, another with
    n = 0; codes 0-4."""
    rng = np.random.default_rng(seed)
    D1 = max(1, d1k - 11)
    step = rng.choice([0, 1, 2, 40, -1], p=[.48, .48, .02, .01, .01],
                      size=(D1, B))
    step[0] = 0
    lo = np.cumsum(step, axis=0) - rng.integers(0, wp, B)[None, :]
    Mp, Np = d1k + 50, d1k + 50
    m = rng.integers(0, Mp + 1, B).astype(np.int32)
    n = rng.integers(0, Np + 1, B).astype(np.int32)
    m[1::7] = 0
    n[2::7] = 0
    return (_t(cuda, rng.integers(0, 5, (Mp, B)).astype(np.int8)),
            _t(cuda, rng.integers(0, 5, (Np, B)).astype(np.int8)),
            _t(cuda, lo.astype(np.int32)), _t(cuda, m), _t(cuda, n), wp,
            d1k)


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_expand_rel_random_inputs(cuda, wp, B):
    """R bit-equal to its plain version on every cell, windows and direct
    loads, packed rows (B % 4 == 0) and byte stores, a partial last
    tile."""
    args = _random_rel(cuda, 150, wp, B, seed=wp + B)
    before = _build.launch_counts["expand_rel"]
    got = fb_circ_cuda.expand_rel_cuda(*args)
    want = fb_circ_cuda.expand_rel_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["expand_rel"] == before + 1
    for name, g, w in zip(("xb", "yb"), got, want):
        assert torch.equal(g, w), (name, wp, B)


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_sv_expand_rel_resources(cuda, wp):
    """S at 8 and 16 lanes a block and R serve every Wp <= 128 with at
    least one block an SM; no spills at Wp 24 and 48 (S), 48 (R)."""
    for lanes in (8, 16):
        res = fb_circ_cuda.sv_backward_resources(
            cuda, wp, _lanes_at(cuda, lanes, True))
        if lanes == 16 and res["lanes_per_block"] == 8:
            continue    # 16 lanes do not fit shared memory at this Wp
        assert res["lanes_per_block"] == lanes, res
        assert res["blocks_per_sm"] >= 1, res
        if wp <= 48:
            assert res["local_bytes"] == 0, res
    res = fb_circ_cuda.expand_rel_resources(cuda, wp)
    assert res["blocks_per_sm"] >= 1, res
    if wp == 48:
        assert res["local_bytes"] == 0, res


# ------------------------- the checkpoint forward and C: one warp per lane


def _random_counts(cuda, d1k, wp, B, ntr, multi, seed):
    """The checkpoint forward's inputs at random: codes -1 .. 5 (outside
    0..4 at both ends), 80% valid cells, band shifts s1 of 0 or 1 (the
    plain versions' rolls take -1, 0 and 1), terminal rows anywhere in the
    band; multi-problem lanes with problems starting at d = 0 and then on
    about one diagonal in twelve, a terminal row on about one diagonal in
    ten (-1 elsewhere)."""
    rng = np.random.default_rng(seed)
    tables = tables_stacked(_em_models(ntr), cuda)
    streams = [_t(cuda, rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8)),
               _t(cuda, rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8)),
               _t(cuda, rng.random((d1k, wp, B)) < 0.8),
               _t(cuda, rng.integers(0, 2, (d1k, B)).astype(np.int32))]
    if multi:
        start = (rng.random((d1k, B)) < 1 / 12).astype(np.int8)
        start[0] = 1
        fink = rng.integers(0, wp, (d1k, B)).astype(np.int32)
        fink[rng.random((d1k, B)) >= 0.1] = -1
        streams += [_t(cuda, start), _t(cuda, fink)]
    else:
        streams.append(_t(cuda, rng.integers(0, wp, B).astype(np.int32)))
    return (tables.T, tables.Ematch, tables.Egap, *streams)


def _ckpt_fwd_equal(cuda, d1k, wp, B, ntr, multi, seed):
    K = fb_counts_cuda
    name = "counts_multi_fwd_ckpt" if multi else "counts_fwd_ckpt"
    args = _random_counts(cuda, d1k, wp, B, ntr, multi, seed)
    before = _build.launch_counts[name]
    got = getattr(K, name + "_cuda")(*args)
    want = getattr(K, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    for what, g, w in zip(("ckpt", "cs", "lsf", "term"), got, want):
        assert torch.equal(g, w), (what, name, d1k, wp, B, ntr)


@pytest.mark.parametrize("wp", [8, 16, 24, 32])
@pytest.mark.parametrize("ntr", [1, 3])
@pytest.mark.parametrize("multi", [False, True])
def test_ckpt_forward_random_inputs(cuda, multi, ntr, wp):
    """The checkpoint forward (counts_fwd_ckpt, counts_multi_fwd_ckpt)
    bit-equal to its plain version on ckpt, cs, lsf and term, one to four
    band rows of a warp idle, 37 lanes (no multiple of the lanes a block
    or of 4: the codes copied byte by byte), five tiles."""
    _ckpt_fwd_equal(cuda, 40, wp, 37, ntr, multi, seed=wp + ntr)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("multi", [False, True])
def test_ckpt_forward_lanes_a_block(cuda, multi, lanes, aligned):
    """The checkpoint forward at each block size it takes (common.cuh
    `warp_lanes` over lanes x trials), its codes copied as words (lanes a
    multiple of 4) and byte by byte, bit-equal to plain."""
    B = _lanes_at(cuda, lanes, aligned)
    res = fb_counts_cuda.ckpt_forward_resources(cuda, 24, B, 1, multi)
    assert res["lanes_per_block"] == lanes, res
    _ckpt_fwd_equal(cuda, 16, 24, B, 1, multi, seed=lanes)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("wp", [24, 32])
def test_ckpt_forward_resources(cuda, wp, multi):
    """The checkpoint forward builds without spills and fits at least one
    block per SM at 8 and 16 lanes a block."""
    for lanes in (8, 16):
        res = fb_counts_cuda.ckpt_forward_resources(
            cuda, wp, _lanes_at(cuda, lanes, True), 1, multi)
        assert res["lanes_per_block"] == lanes, res
        assert res["local_bytes"] == 0, res
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1, res


def _cx_inputs(cuda, width, B, chain_model, d1k=None, seed=0):
    """C's inputs on `_ragged_compact` pairs at `width`, their lanes
    repeated or cut to B: es, yb and fr from E's plain version over d1k
    diagonals (the band's plus 3, a partial last tile, when None), fr
    forced past the band (Wp + 5, -1) and to its edge rows (0, Wp - 1) on
    some diagonals, and S's outputs on es (its plain version: C's inputs
    must not hang on S's kernel)."""
    tables = _flat_gap_tables(chain_model)
    coef, chain = circ_coefficients(tables)
    comp, dev = _ragged_compact(cuda, width, seed=seed)
    dev = _widen(dev, B)
    Wp = comp.wp
    d1k = d1k or comp.num_steps + 3
    es, yb, fr = fb_circ_cuda.expand_streams_plain(
        tables.Ematch.numpy().reshape(-1), dev.reads, dev.refs, dev.lo,
        dev.m, dev.n, width, Wp, d1k, want_yb=True)
    d = torch.arange(d1k, device=cuda)[:, None]
    for step, at, row in ((7, 3, Wp + 5), (11, 4, -1), (13, 5, 0),
                          (17, 6, Wp - 1)):
        fr = torch.where(d % step == at, row, fr)
    fr = fr.int().contiguous()
    back = fb_circ_cuda.sv_backward_plain(coef, chain, es, dev.fink,
                                          dev.final_d)
    return (coef, chain, es, yb, fr, *back)


def _cx_equal(cuda, width, B, chain_model, d1k=None, seed=0):
    args = _cx_inputs(cuda, width, B, chain_model, d1k, seed)
    before = _build.launch_counts["cx_forward"]
    got = fb_circ_cuda.cx_forward_cuda(*args)
    want = fb_circ_cuda.cx_forward_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["cx_forward"] == before + 1
    for name, g, w in zip(("fl", "tails"), got, want):
        assert torch.isfinite(w).all(), (name, width, B, chain_model)
        assert torch.equal(g, w), (name, width, B, chain_model, d1k)
    return want


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("width", [21, 45, 93, 126])
def test_cx_forward_random_inputs(cuda, width, B, chain_model):
    """C bit-equal to its plain version (fl, tails) at Wp 24, 48, 96 and
    128 (one to four rows a thread), over lane counts that are no multiple
    of the lanes a block, both model forms, flush rows past the band, a
    partial last tile."""
    fl, _ = _cx_equal(cuda, width, B, chain_model, seed=width + B)
    assert fl.abs().max().item() > 0


@pytest.mark.parametrize("chain_model", [True, False])
@pytest.mark.parametrize("d1k", [1, 2, 8, 9])
def test_cx_forward_short_bands(cuda, d1k, chain_model):
    """C over one or two diagonals, a whole tile and a tile and one."""
    for width in (21, 45):
        _cx_equal(cuda, width, 33, chain_model, d1k, seed=d1k)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
def test_cx_forward_lanes_a_block(cuda, lanes, aligned):
    """C at each block size it takes (common.cuh `warp_lanes`), its codes
    copied as words and byte by byte."""
    B = _lanes_at(cuda, lanes, aligned)
    res = fb_circ_cuda.cx_forward_resources(cuda, 24, B)
    assert res["lanes_per_block"] == lanes, res
    _cx_equal(cuda, 21, B, True, seed=lanes)


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_cx_forward_resources(cuda, wp):
    """C at 8 and 16 lanes a block serves every Wp <= 128 with at least
    one block an SM; no spills at Wp 24 and 48."""
    for lanes in (8, 16):
        res = fb_circ_cuda.cx_forward_resources(
            cuda, wp, _lanes_at(cuda, lanes, True))
        if lanes == 16 and res["lanes_per_block"] == 8:
            continue    # 16 lanes do not fit shared memory at this Wp
        assert res["lanes_per_block"] == lanes, res
        assert res["blocks_per_sm"] >= 1, res
        if wp <= 48:
            assert res["local_bytes"] == 0, res


# ------------------------------------------ the generic pair: one warp per lane


def _random_generic(cuda, d1k, wp, B, seed, final_row=None):
    """The generic pair's inputs at random: the perturbed shipped model
    (gap emissions not flat), codes 0..4 and 2% each of -1 and 5 (outside
    0..4 at both ends), 90% valid cells, band shifts s1 of 0 or 1, each
    lane's terminal row anywhere in the band (`final_row` on every lane
    when given) and its terminal diagonal one where the plain forward's
    match state holds mass at that row (the last such on every third
    lane), or d = 0 where the row holds none, so logZ and the posteriors
    are finite.  Returns the tables, the
    forward's streams and the terminal diagonals."""
    from marginalign_trna_tpu_torch.ops import fb_generic_cuda as G

    hmm = PairHmm.load(MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    tables = tables_from_hmm(hmm)
    assert not fb_cuda.has_flat_gap_emissions(tables)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    rng = np.random.default_rng(seed)
    codes = [-1, 0, 1, 2, 3, 4, 5]
    p = [.02, .24, .24, .24, .24, 0., .02]
    fink = (rng.integers(0, wp, B) if final_row is None
            else np.full(B, final_row)).astype(np.int32)
    streams = tuple(torch.from_numpy(a) for a in (
        rng.choice(codes, p=p, size=(d1k, wp, B)).astype(np.int8),
        rng.choice(codes, p=p, size=(d1k, wp, B)).astype(np.int8),
        rng.random((d1k, wp, B)) < 0.9,
        rng.integers(0, 2, (d1k, B)).astype(np.int32), fink))
    fm = G.fb_generic_fwd_plain(*tabs, *streams)[0].numpy()
    held = fm[:, fink, np.arange(B)] > 0           # [d1k, B]
    held[0] = True   # d = 0: a zero terminal sum leaves logZ finite there
    find = np.array([rng.choice(np.flatnonzero(held[:, b])) if b % 3
                     else np.flatnonzero(held[:, b])[-1] for b in range(B)],
                    np.int32)
    return (tuple(t.to(cuda) for t in tabs),
            tuple(t.to(cuda) for t in streams), _t(cuda, find))


def _generic_equal(cuda, tabs, streams, find):
    """fb_generic_fwd and fb_generic_bwd bit-equal to their plain versions
    (F_match, lsf and term; the posterior band on the plain forward's
    outputs), each launched once; returns the posterior band."""
    from marginalign_trna_tpu_torch.ops import fb_generic_cuda as G

    names = ("fb_generic_fwd", "fb_generic_bwd")
    before = {k: _build.launch_counts[k] for k in names}
    got = G.fb_generic_fwd_cuda(*tabs, *streams)
    want = G.fb_generic_fwd_plain(*tabs, *streams)
    shape = tuple(streams[0].shape)
    for what, g, w in zip(("F_match", "lsf", "term"), got, want):
        assert torch.isfinite(w).all(), (what, shape)
        assert torch.equal(g, w), (what, shape)
    fm, lsf, term = want
    logZ = fb_counts.logz_from_terminal(lsf[None], term[None], find)[0]
    bargs = (*tabs, fm, lsf, *streams, find, logZ)
    post = G.fb_generic_bwd_cuda(*bargs)
    rpost = G.fb_generic_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.isfinite(rpost).all(), shape
    assert torch.equal(post, rpost), shape
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)
    return rpost


@pytest.mark.parametrize("B", [1, 7, 9, 33, 1027])
@pytest.mark.parametrize("wp", [8, 16, 24, 32])
def test_generic_pair_random_inputs(cuda, wp, B):
    """The generic pair (the checkpoint forward's MATCH mode and
    generic_bwd_kernel) bit-equal to its plain versions with 24 to none of
    a warp's rows idle, over lane counts that leave a tail in an 8-lane
    block (1027 lanes take 8 a block), five tiles."""
    post = _generic_equal(cuda, *_random_generic(cuda, 40, wp, B,
                                                 seed=wp + B))
    assert post.max().item() > 0


@pytest.mark.parametrize("wp", [8, 24, 32])
def test_generic_pair_single_tile(cuda, wp):
    """The generic pair over one tile of 8 diagonals (d1k = 8)."""
    _generic_equal(cuda, *_random_generic(cuda, 8, wp, 33, seed=wp))


@pytest.mark.parametrize("row", ["first", "last"])
@pytest.mark.parametrize("wp", [8, 24, 32])
def test_generic_pair_final_row(cuda, wp, row):
    """The generic pair with every lane's terminal cell on the band's first
    or last row (the forward's terminal sums and the backward's injection
    at a row whose shuffles wrap)."""
    final_row = 0 if row == "first" else wp - 1
    _generic_equal(cuda, *_random_generic(cuda, 40, wp, 33, seed=wp,
                                          final_row=final_row))


@pytest.mark.parametrize("shape", ["call_generic", "em_band"])
def test_generic_pair_path_shapes(cuda, shape):
    """Small batches shaped like the pair's largest launches on two of its
    paths: marginCaller's [128, 24, 32768] (16 lanes a block) at 16 x SMs
    + 4 lanes (a 16-lane tail, codes copied as words) and --updateTheBand's
    [512, 24, 2048] (8 lanes a block) at 45 lanes (codes copied byte by
    byte)."""
    d1k, lanes, aligned = {"call_generic": (128, 16, True),
                           "em_band": (512, 8, False)}[shape]
    B = _lanes_at(cuda, lanes, aligned)
    for backward in (False, True):
        res = fb_counts_cuda.generic_resources(cuda, 24, B, backward)
        assert res["lanes_per_block"] == lanes, res
    _generic_equal(cuda, *_random_generic(cuda, d1k, 24, B, seed=d1k))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("wp", [8, 24, 32])
def test_generic_pair_resources(cuda, wp, backward):
    """The generic pair builds without spills and fits at least one block
    per SM at 8 and 16 lanes a block."""
    for lanes in (8, 16):
        res = fb_counts_cuda.generic_resources(
            cuda, wp, _lanes_at(cuda, lanes, True), backward)
        assert res["lanes_per_block"] == lanes, res
        assert res["local_bytes"] == 0, res
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1, res


# ------------------------------------ the stored counts pair: one warp per lane


def _random_stored(cuda, d1k, wp, B, ntr, multi, seed, final_row=None):
    """The stored pair's inputs, with finite logZ, L and posteriors.
    Single-problem lanes: `_random_counts`' streams, each lane's terminal
    cell at row `final_row` (a random row when None) on a diagonal where the
    plain forward holds mass there (the last such on every third lane; d = 0
    where the row holds none).  Multi-problem lanes: random noisy pairs,
    about d1k / 20 a lane (at least one), packed at the width whose band
    holds wp rows (narrowed to wp, as `_narrow` does), L from `multi_logz`.
    Returns (tables, the forward's streams, find, logZ or L)."""
    K = fb_counts_cuda
    if multi:
        rng = np.random.default_rng(seed)
        width = {9: 7, 24: 21, 32: 29}[wp]
        hi = max(3, d1k // 5)
        refs = [rng.integers(0, 4, int(rng.integers(2, hi + 1))).astype(
            np.int8) for _ in range(B * max(1, d1k // 20))]
        reads = []
        for r in refs:
            read = np.delete(r, [len(r) // 2]).copy()
            read[rng.random(len(read)) < 0.1] = int(rng.integers(0, 4))
            reads.append(read)
        mb = pack_multi_banded_batch(reads, refs, width=width,
                                     pad_steps_to=d1k, pad_batch_to=B)
        mdev = multi_device_batch(mb, cuda)
        *ms, fk, fd = fb_counts.multi_kernel_inputs(mdev)
        assert int(fk.max()) < wp
        streams = tuple(a[:, :wp].contiguous() for a in ms[:3]) + (
            ms[3], ms[4], fk)
        tabs = tables_stacked(_em_models(ntr), cuda)
        tabs = (tabs.T, tabs.Ematch, tabs.Egap)
        _, lsf, term = K.counts_multi_fwd_all_plain(*tabs, *streams)
        return tabs, streams, fd, multi_logz(lsf, term, mdev)[0]
    args = _random_counts(cuda, d1k, wp, B, ntr, False, seed)
    tabs, streams = args[:3], list(args[3:])
    rng = np.random.default_rng(seed + 1)
    fwd = K.counts_fwd_all_plain
    mass = fwd(*tabs, *streams)[0].sum(dim=2)[0].cpu().numpy() > 0
    fink = (rng.integers(0, wp, B) if final_row is None
            else np.full(B, final_row)).astype(np.int32)
    held = mass[:, fink, np.arange(B)]          # [d1k, B]
    held[0] = True
    find = np.array([rng.choice(np.flatnonzero(held[:, b])) if b % 3
                     else np.flatnonzero(held[:, b])[-1] for b in range(B)],
                    np.int32)
    streams[-1] = _t(cuda, fink)
    _, lsf, term = fwd(*tabs, *streams)
    find = _t(cuda, find)
    return tabs, tuple(streams), find, fb_counts.logz_from_terminal(
        lsf, term, find)


def _stored_equal(cuda, tabs, streams, find, norm):
    """counts_fwd_all and counts_bwd (their counts_multi_ instances where
    the streams hold start) bit-equal to their plain versions on f_all, lsf,
    term and the posterior band (the backward on the plain forward's
    outputs), the lane-summed partials within rtol 1e-5, each launched
    once; returns the posterior band."""
    K = fb_counts_cuda
    multi = len(streams) == 6
    names = (("counts_multi_fwd_all", "counts_multi_bwd") if multi
             else ("counts_fwd_all", "counts_bwd"))
    before = {k: _build.launch_counts[k] for k in names}
    fwd, bwd = ((getattr(K, n + "_cuda"), getattr(K, n + "_plain"))
                for n in names)
    got = fwd[0](*tabs, *streams)
    want = fwd[1](*tabs, *streams)
    shape = (tabs[0].shape[0],) + tuple(streams[0].shape)
    for what, g, w in zip(("f_all", "lsf", "term"), got, want):
        assert torch.isfinite(w).all(), (what, shape)
        assert torch.equal(g, w), (what, shape)
    f_all, lsf, _ = want
    bargs = (*tabs, f_all, lsf, *streams, find, norm)
    got = bwd[0](*bargs)
    want = bwd[1](*bargs)
    torch.cuda.synchronize()
    assert torch.isfinite(want[0]).all(), shape
    assert torch.equal(got[0], want[0]), ("post", shape)
    for what, g, w in zip(("tcp", "egp"), got[1:], want[1:]):
        assert torch.allclose(g.sum(-1), w.sum(-1), rtol=1e-5, atol=1e-6), (
            what, shape)
    assert all(_build.launch_counts[k] == before[k] + 1 for k in names)
    return want[0]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("ntr", [1, 3])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_stored_pair_random_inputs(cuda, wp, ntr, multi):
    """The stored pair (the checkpoint forward's CF_ALL mode and
    counts_stored_bwd_kernel) bit-equal to its plain versions with 23 to
    none of a warp's rows idle, one and three trials, single and
    multi-problem lanes, 37 lanes (no multiple of the lanes a block or of
    4: the codes copied byte by byte), five tiles."""
    post = _stored_equal(cuda, *_random_stored(cuda, 40, wp, 37, ntr, multi,
                                               seed=wp + ntr))
    assert post.max().item() > 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("multi", [False, True])
def test_stored_pair_lanes_a_block(cuda, multi, lanes, aligned):
    """The stored pair at each block size it takes (common.cuh `warp_lanes`
    over lanes x trials), its codes copied as words (lanes a multiple of 4)
    and byte by byte."""
    B = _lanes_at(cuda, lanes, aligned)
    for backward in (False, True):
        res = fb_counts_cuda.stored_resources(cuda, 24, B, 1, multi,
                                              backward)
        assert res["lanes_per_block"] == lanes, (res, backward)
    _stored_equal(cuda, *_random_stored(cuda, 16, 24, B, 1, multi,
                                        seed=lanes))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_stored_pair_single_tile(cuda, wp, multi):
    """The stored pair over one tile of 8 diagonals (d1k = 8)."""
    _stored_equal(cuda, *_random_stored(cuda, 8, wp, 33, 3, multi, seed=wp))


@pytest.mark.parametrize("row", ["first", "last"])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_stored_pair_final_row(cuda, wp, row):
    """The stored pair with every lane's terminal cell on the band's first
    or last row (the forward's terminal sums and the backward's injection
    at a row whose shuffles wrap)."""
    final_row = 0 if row == "first" else wp - 1
    _stored_equal(cuda, *_random_stored(cuda, 40, wp, 33, 3, False, seed=wp,
                                        final_row=final_row))


@pytest.mark.parametrize("shape", ["em32", "em_band"])
def test_stored_pair_path_shapes(cuda, shape):
    """Batches shaped like the pair's launches on two of its paths: the EM
    parity run's [3, 512, 24, 1024] and --updateTheBand's E-step
    [3, 512, 24, 2048] (both 16 lanes a block), as random inputs."""
    B = {"em32": 1024, "em_band": 2048}[shape]
    for backward in (False, True):
        res = fb_counts_cuda.stored_resources(cuda, 24, B, 3, False,
                                              backward)
        assert res["lanes_per_block"] == 16, res
    _stored_equal(cuda, *_random_stored(cuda, 512, 24, B, 3, False,
                                        seed=B))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("wp", [9, 24, 32])
def test_stored_pair_resources(cuda, wp, multi, backward):
    """The stored pair builds without spills or stack and fits at least one
    block per SM at 8 lanes a block and, where its shared memory fits, at
    16."""
    for lanes in (8, 16):
        res = fb_counts_cuda.stored_resources(
            cuda, wp, _lanes_at(cuda, lanes, True), 1, multi, backward)
        if lanes == 16 and res["lanes_per_block"] == 8:
            continue    # 16 lanes do not fit shared memory at this Wp
        assert res["lanes_per_block"] == lanes, res
        assert res["local_bytes"] == 0, res
        assert res["registers"] > 0 and res["blocks_per_sm"] >= 1, res


# ------------------------------------------ K4: one warp per lane


def _random_mea(cuda, D1, wp, B, seed, invalid_lanes=(), final_d=None):
    """K4's inputs at random: wdiag in [0, 1) with 20% NEG (no match
    weight), wup / wleft in [0, 0.5), 80% valid cells (no valid cell in
    `invalid_lanes`), shifts s1 in {-1, 0, 1, 2} and s2 in {-1, ..., 3}
    (every move of the plain version's rows and the rows left in place),
    terminals on any diagonal (every fifth at d = 0, every eleventh past
    the band: the plain version's NEG) and any band row; or every terminal
    at `final_d`."""
    rng = np.random.default_rng(seed)
    wdiag = rng.random((D1, wp, B)).astype(np.float32)
    wdiag[rng.random(wdiag.shape) < 0.2] = NEG
    valid = rng.random((D1, wp, B)) < 0.8
    valid[..., list(invalid_lanes)] = False
    if final_d is None:
        fd = rng.integers(0, D1, B).astype(np.int32)
        fd[::5] = 0
        fd[3::11] = D1 + 3
    else:
        fd = np.full(B, final_d, np.int32)
    return (_t(cuda, wdiag),
            _t(cuda, (rng.random((D1, wp, B)) * 0.5).astype(np.float32)),
            _t(cuda, (rng.random((D1, wp, B)) * 0.5).astype(np.float32)),
            _t(cuda, valid),
            _t(cuda, rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05],
                                size=(D1, B)).astype(np.int32)),
            _t(cuda, rng.integers(-1, 4, (D1, B)).astype(np.int32)),
            _t(cuda, fd),
            _t(cuda, rng.integers(0, wp, B).astype(np.int32)))


def _mea_equal(cuda, args):
    """K4 against its plain version: pointers on every cell and scores bit
    for bit, one launch counted."""
    before = _build.launch_counts["banded_mea"]
    ptr, score = wavefront_cuda.banded_mea_cuda(*args)
    rptr, rscore = wavefront_cuda.banded_mea_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["banded_mea"] == before + 1
    assert torch.equal(ptr, rptr)
    assert torch.equal(score, rscore), (score - rscore).abs().max().item()


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_banded_mea_random_inputs(cuda, wp, B):
    """K4 bit-equal to its plain version at every rows-a-thread count (and
    tile length: 8 diagonals up to Wp 64, 4 above), over lane counts that
    are no multiple of the lanes a block, 67 diagonals (a partial last
    tile)."""
    _mea_equal(cuda, _random_mea(cuda, 67, wp, B, seed=wp + B))


@pytest.mark.parametrize("wp", [24, 48, 96])
def test_banded_mea_terminal_at_start(cuda, wp):
    """K4 with every terminal at d = 0 (the score of the initialisation),
    and with a third of the lanes holding no valid cell."""
    _mea_equal(cuda, _random_mea(cuda, 40, wp, 45, seed=wp, final_d=0))
    _mea_equal(cuda, _random_mea(cuda, 40, wp, 45, seed=wp + 1,
                                 invalid_lanes=range(0, 45, 3)))


@pytest.mark.parametrize("D1", [1, 2, 9])
def test_banded_mea_short_bands(cuda, D1):
    """K4 over one, two and nine diagonals (a tile and one more)."""
    for wp in (24, 96):
        _mea_equal(cuda, _random_mea(cuda, D1, wp, 33, seed=D1))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_banded_mea_lanes_a_block(cuda, lanes, aligned):
    """K4 at each block size it takes (csrc/mea.cu `mea_lanes`: the widest
    whose blocks reach 15/16 of the SMs, 32 at one row a thread only), its
    valid and pointer rows copied as words (lanes a multiple of 4) and
    byte by byte, bit-equal to plain."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = lanes * sms + (4 if aligned else 5) if lanes > 8 else 44 + (
        0 if aligned else 1)
    wp = 24 if lanes == 32 else 48
    res = wavefront_cuda.warp_lane_resources("banded_mea", cuda, wp, B)
    assert res["lanes_per_block"] == lanes, res
    _mea_equal(cuda, _random_mea(cuda, 40, wp, B, seed=lanes))


@pytest.mark.parametrize("wp", [24, 96])
def test_banded_mea_unaligned_weights(cuda, wp):
    """K4 on weight bands that start 4 bytes past a 16-byte boundary (no
    tensor map takes them: the tiles come by cp.async) over a lane count
    that is a multiple of 4, bit-equal to plain."""
    args = list(_random_mea(cuda, 40, wp, 1024, seed=wp))
    for i in range(3):
        buf = torch.empty(args[i].numel() + 1, dtype=torch.float32,
                          device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        assert view.data_ptr() % 16 == 4
        args[i] = view
    _mea_equal(cuda, tuple(args))


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_banded_mea_resources(cuda, wp):
    """K4 serves every Wp <= 128 at 8 lanes a block and, where its tiles
    fit, at 16 (and 32 at one row a thread), with at least one block an SM
    and no spills; no stack up to two rows a thread (at three and four,
    Wp > 64, mk::WarpRows's edge row takes one, as in K1 and D).  The
    REL path's 1024 lanes take 8 lanes a block (128 blocks), em_band's 2048
    16, the bucket's 4096 32."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for lanes in (8, 16, 32):
        res = wavefront_cuda.warp_lane_resources(
            "banded_mea", cuda, wp, lanes * sms)
        if res["lanes_per_block"] < lanes:
            continue    # wider blocks do not fit at this Wp
        assert res["lanes_per_block"] == lanes, res
        assert res["threads_per_block"] == 32 * lanes
        assert res["blocks_per_sm"] >= 1, res
        if wp <= 64:
            assert res["local_bytes"] == 0, res
    for B, lanes in ((1024, 8), (2048, 16), (4096, 32)):
        res = wavefront_cuda.warp_lane_resources("banded_mea", cuda, 24, B)
        assert res["lanes_per_block"] == lanes, (B, res)


# ------------------------------------------ K2, K3: one warp per lane


def _fb_coef():
    """The shipped model's coefficients A[s][u] = T[s][u] g_u."""
    st = fb_cuda.static_tables(tables_from_hmm(PairHmm.load(MODEL)))
    return fb_cuda._coefficients(st, fb_cuda.require_flat_gaps(st))


def _random_fb(cuda, D1, wp, B, seed, final_d=None, invalid_lanes=()):
    """K2's inputs at random: 80% valid cells and the origin (none in
    `invalid_lanes`), match emissions in [0, 1) premasked by valid, shifts
    s1 in {-1, 0, 1, 2} (every move of the plain versions' `shift` and the
    rows left in place), terminals on any diagonal (every fifth at d = 0, every
    eleventh past the band) and any row (every seventh past the band: no
    injection), or every terminal at `final_d`."""
    rng = np.random.default_rng(seed)
    valid = rng.random((D1, wp, B)) < 0.8
    valid[0, 0] = True
    valid[..., list(invalid_lanes)] = False
    em = (rng.random((D1, wp, B)) * valid).astype(np.float32)
    if final_d is None:
        fd = rng.integers(0, D1, B)
        fd[::5] = 0
        fd[3::11] = D1 + 3
    else:
        fd = np.full(B, final_d)
    fk = rng.integers(0, wp, B)
    fk[2::7] = wp + 1
    return (_fb_coef(), _t(cuda, em), _t(cuda, valid),
            _t(cuda, rng.choice([-1, 0, 1, 2], p=[.05, .45, .45, .05],
                                size=(D1, B)).astype(np.int32)),
            _t(cuda, fd.astype(np.int32)), _t(cuda, fk.astype(np.int32)))


def _same_bits(got, want):
    """Bit for bit, NaN included: random bands with no mass near the origin
    give the plain versions logZ below log(1e-30) + bls and non-finite
    posteriors, which the kernels must reproduce."""
    same = got.view(torch.int32) == want.view(torch.int32)
    assert bool(same.all()), "%d of %d differ" % (int((~same).sum()),
                                                  same.numel())


def _fb_rel_equal(cuda, args):
    """K2 against its plain version (bm, bls, logZ), K3 against its plain
    version on the plain backward's outputs and chained on the kernel's
    own: every output bit for bit, one launch each counted."""
    names = ("fb_backward", "fb_forward")
    before = [_build.launch_counts[k] for k in names]
    got = fb_cuda.fb_backward_cuda(*args)
    want = fb_cuda.fb_backward_plain(*args)
    fargs = args[:4] + tuple(want)
    post = fb_cuda.fb_forward_cuda(*fargs)
    torch.cuda.synchronize()
    assert [_build.launch_counts[k] for k in names] == [n + 1 for n in before]
    for g, w in zip(got, want):
        _same_bits(g, w)
    rpost = fb_cuda.fb_forward_plain(*fargs)
    _same_bits(post, rpost)
    _same_bits(fb_cuda.fb_forward_cuda(*args[:4], *got), rpost)


@pytest.mark.parametrize("B", [31, 1000])
@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_fb_rel_random_inputs(cuda, wp, B):
    """K2 and K3 bit-equal to their plain versions at one to four rows a
    thread (TMA up to Wp 64 where B is a multiple of 4, cp.async
    otherwise), over lane counts that are no multiple of the lanes a
    block, 67 diagonals (a partial tile)."""
    _fb_rel_equal(cuda, _random_fb(cuda, 67, wp, B, seed=wp + B))


@pytest.mark.parametrize("D1", [1, 2, 9])
def test_fb_rel_short_bands(cuda, D1):
    """K2 and K3 over one, two and nine diagonals (a tile and one more)."""
    for wp in (24, 96):
        _fb_rel_equal(cuda, _random_fb(cuda, D1, wp, 36, seed=D1))


@pytest.mark.parametrize("wp", [24, 48, 96])
def test_fb_rel_terminal_at_start(cuda, wp):
    """K2 and K3 with every terminal at d = 0, and with a third of the
    lanes holding no valid cell (no mass: every rescale factor 1)."""
    _fb_rel_equal(cuda, _random_fb(cuda, 40, wp, 45, seed=wp, final_d=0))
    _fb_rel_equal(cuda, _random_fb(cuda, 40, wp, 44, seed=wp + 1,
                                   invalid_lanes=range(0, 44, 3)))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
def test_fb_rel_lanes_a_block(cuda, lanes, aligned):
    """K2 and K3 at each block size mk::warp_lanes gives them, their bands
    by TMA and valid as words (B a multiple of 4) or by cp.async and byte
    by byte, bit-equal to plain."""
    B = _lanes_at(cuda, lanes, aligned)
    for backward in (True, False):
        res = fb_cuda.fb_rel_resources(cuda, 24, B, backward)
        assert res["lanes_per_block"] == lanes, res
    _fb_rel_equal(cuda, _random_fb(cuda, 20, 24, B, seed=lanes))


@pytest.mark.parametrize("wp", [24, 48])
def test_fb_rel_unaligned_bands(cuda, wp):
    """K2 and K3 on float bands that start 4 bytes past a 16-byte boundary
    (no tensor map takes them: the tiles come by cp.async) over a lane
    count that is a multiple of 4, bit-equal to plain."""
    args = list(_random_fb(cuda, 30, wp, 1024, seed=wp))
    buf = torch.empty(args[1].numel() + 1, dtype=torch.float32, device=cuda)
    view = buf[1:].view(args[1].shape)
    view.copy_(args[1])
    assert view.data_ptr() % 16 == 4
    args[1] = view
    _fb_rel_equal(cuda, tuple(args))


@pytest.mark.parametrize("wp", [24, 48, 96, 128])
def test_fb_rel_resources(cuda, wp):
    """K2 and K3 serve every Wp <= 128 at 8 lanes a block and, where their
    tiles fit, at 16, with at least one block an SM and no spills; no
    stack up to two rows a thread.  The REL path's 1024 lanes take 8 lanes
    a block (128 blocks), 16384 lanes 16."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for backward in (True, False):
        for lanes in (8, 16):
            res = fb_cuda.fb_rel_resources(cuda, wp, lanes * sms, backward)
            if res["lanes_per_block"] < lanes:
                continue    # 16 lanes do not fit at this Wp
            assert res["lanes_per_block"] == lanes, res
            assert res["threads_per_block"] == 32 * lanes
            assert res["blocks_per_sm"] >= 1, res
            if wp <= 64:
                assert res["local_bytes"] == 0, res
        for B, lanes in ((1024, 8), (16384, 16)):
            res = fb_cuda.fb_rel_resources(cuda, 24, B, backward)
            assert res["lanes_per_block"] == lanes, (B, res)


# ------------------------------------------ X: lane groups and windows


def _lanesum_inputs(cuda, C, D, B, rg, seed):
    """X's inputs at random: values in [0, 1) with 10% zeros, targets over
    [0, rg) with 30% -1 and 3% at or past rg."""
    rng = np.random.default_rng(seed)
    vals = rng.random((C, D, B)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = 0
    jm = rng.integers(0, rg, (D, B))
    u = rng.random((D, B))
    jm[u < 0.3] = -1
    jm[u > 0.97] = rg + rng.integers(0, 9, int((u > 0.97).sum()))
    return _t(cuda, vals), _t(cuda, jm.astype(np.int32))


def _lanesum_close(cuda, vals, jm, rg):
    """X against its plain version (rtol 1e-5, atol 1e-4), and two launches
    against each other (fixed-point sums: identical), two launches
    counted."""
    before = _build.launch_counts["scatter_lanesum"]
    out = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
    again = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
    ref = bucket_scatter.scatter_lanesum_plain(vals, jm, rg)
    torch.cuda.synchronize()
    assert _build.launch_counts["scatter_lanesum"] == before + 2
    assert out.shape == ref.shape
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-4), \
        (out - ref).abs().max().item()
    assert torch.equal(out, again)


@pytest.mark.parametrize("rg", [1, 700, 8192, 8193, 3 * 8192 + 5])
def test_scatter_lanesum_windows(cuda, rg):
    """X over outputs of one row, within its 7168-row window (C = 4), past
    it and many times past it (those rows added into the device-memory
    accumulator), with targets -1 and at or past rg adding nowhere; one
    lane group and many."""
    for B in (37, 9000):
        _lanesum_close(cuda, *_lanesum_inputs(cuda, 4, 41, B, rg,
                                              seed=rg + B), rg)


@pytest.mark.parametrize("rg", [1, 700, 8192, 8193, 3 * 8192 + 5])
def test_scatter_lanesum_launches_identical(cuda, rg):
    """Two X launches on test_scatter_lanesum_windows' inputs are bit for
    bit equal (integer sums: no order of the adds shows), and a third
    after a launch on other inputs too."""
    for B in (37, 9000):
        vals, jm = _lanesum_inputs(cuda, 4, 41, B, rg, seed=rg + B)
        out = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
        again = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
        bucket_scatter.scatter_lanesum_cuda(vals.flip(2).contiguous(), jm,
                                            rg)
        third = bucket_scatter.scatter_lanesum_cuda(vals, jm, rg)
        assert torch.equal(out, again) and torch.equal(out, third), rg


@pytest.mark.parametrize("C", [1, 3, 5])
def test_scatter_lanesum_channels(cuda, C):
    """X at channel counts other than the caller's 4 (the kernel's generic
    instance), its window then 32768 / C rows, the rest of the output
    past it."""
    rg = 40000 // C
    _lanesum_close(cuda, *_lanesum_inputs(cuda, C, 30, 3000, rg, seed=C),
                   rg)


def test_scatter_lanesum_plan(cuda):
    """X's lane groups (one block each) and window rows: one group where
    the lanes are few, more where they fill the SMs (at most one a block of
    every SM: the caller batch's [4, 152, 65536]); the window the whole
    output up to 28672 / C rows (64-bit sums)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bucket_scatter.scatter_lanesum_plan(cuda, 4, 20, 700) == (1, 700)
    g, rows = bucket_scatter.scatter_lanesum_plan(cuda, 4, 65536, 7168)
    assert 1 < g <= sms and rows == 7168, (g, rows)
    assert bucket_scatter.scatter_lanesum_plan(cuda, 4, 65536, 65536) == (
        g, 7168)
    assert bucket_scatter.scatter_lanesum_plan(cuda, 3, 9, 40000) == (
        1, 28672 // 3)


def test_scatter_lanesum_caller_shape(cuda):
    """X on flush streams shaped like the caller's: lanes of 40-60
    positions, each targeting its positions once over 128 flush and 24
    tail rows, offsets over rg 7168, 16 lanes repeated to 8192; values
    where -1 targets sit (they must add nothing)."""
    rng = np.random.default_rng(13)
    D, B, rg = 152, 8192, 7168
    jm = np.full((D, B), -1, np.int32)
    for b in range(0, B, 16):
        n = int(rng.integers(40, 61))
        off = int(rng.integers(0, rg - n))
        rows = np.sort(rng.choice(D, n, replace=False))
        jm[rows, b:b + 16] = (off + np.arange(n))[:, None]
    vals = _t(cuda, rng.random((4, D, B)).astype(np.float32))
    _lanesum_close(cuda, vals, _t(cuda, jm), rg)


def test_scatter_lanesum_resources(cuda):
    """X's window kernel: 1024 threads, one block an SM with its 224 KB
    window at the caller's rg 7168, no spills and no stack."""
    res = bucket_scatter.scatter_lanesum_resources(cuda, 4, 65536, 7168)
    assert res["threads_per_block"] == 1024, res
    assert res["blocks_per_sm"] >= 1, res
    assert res["local_bytes"] == 0, res
    assert res["smem_per_block"] >= 7168 * 4 * 4, res
    assert res["groups"] > 1 and res["window_rows"] == 7168, res


# ----------------------- the serving kernels: one warp per lane, sources


SERVE_BACKWARDS = ("circ_backward_emv", "circ_backward_codes",
                   "circ_backward_codes_es")
SERVE_FORWARDS = ("circ_post_es", "circ_post_emv", "circ_post_codes")


def _random_serve(cuda, d1k, wp, B, chain_model, seed, final_d=None):
    """The six serving kernels' inputs at random: codes in -1..5 (some
    outside 0..4, which emit 0), 75% valid cells, the signed stream es and
    the premasked em of those codes under the model's table (as
    ops/fb_circ.py `emission_stream` makes them), terminals on any row and
    at d = 0, d1k - 1, a rescale edge (8), a tile edge (16) or anywhere
    (or all at final_d); the forwards on the plain backward's outputs
    (S's, which every source's backward equals).  {name: arguments}."""
    rng = np.random.default_rng(seed)
    tables = _flat_gap_tables(chain_model)
    coef, chain = circ_coefficients(tables)
    table = tables.Ematch.numpy().reshape(-1)
    xb = rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8)
    yb = rng.integers(-1, 6, (d1k, wp, B)).astype(np.int8)
    valid = (rng.random((d1k, wp, B)) < 0.75).astype(np.int8)
    ok = (xb >= 0) & (xb < 5) & (yb >= 0) & (yb < 5)
    e = np.where(ok, table[np.clip(xb * 5 + yb, 0, 24)], 0.0) * valid
    em = e.astype(np.float32)
    es = (em - (1.0 - valid)).astype(np.float32)
    if final_d is None:
        find = rng.integers(0, d1k, B)
        find[::5] = 0
        find[1::5] = d1k - 1
        find[2::5] = min(8, d1k - 1)
        find[3::5] = min(16, d1k - 1)
    else:
        find = np.full(B, final_d)
    fink = rng.integers(0, wp, B)
    t = {name: _t(cuda, a) for name, a in (
        ("xb", xb), ("yb", yb), ("valid", valid), ("em", em), ("es", es),
        ("fink", fink.astype(np.int32)), ("find", find.astype(np.int32)))}
    back = fb_circ_cuda.sv_backward_plain(coef, chain, t["es"], t["fink"],
                                          t["find"])
    codes = (coef, chain, table, t["xb"], t["yb"], t["valid"])
    return {
        "circ_backward_emv": (coef, chain, t["em"], t["valid"], t["fink"],
                              t["find"]),
        "circ_backward_codes": (*codes, t["fink"], t["find"]),
        "circ_backward_codes_es": (*codes, t["fink"], t["find"]),
        "circ_post_es": (coef, chain, t["es"], *back),
        "circ_post_emv": (coef, chain, t["em"], t["valid"], *back),
        "circ_post_codes": (*codes, *back),
    }


def _serve_equal(cuda, cases, names=SERVE_BACKWARDS + SERVE_FORWARDS):
    """Each serving kernel of `names` against its plain version on its
    arguments in `cases`: every output bit for bit (NaN included), one
    launch counted; each forward also chained on its source's own kernel
    backward."""
    for name in names:
        args = cases[name]
        before = _build.launch_counts[name]
        got = getattr(fb_circ_cuda, name + "_cuda")(*args)
        want = getattr(fb_circ_cuda, name + "_plain")(*args)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1, name
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            _same_bits(g, w)
    chained = {"circ_post_emv": "circ_backward_emv",
               "circ_post_codes": "circ_backward_codes"}
    for name, bname in chained.items():
        if name not in names:
            continue
        bargs = cases[bname]
        back = getattr(fb_circ_cuda, bname + "_cuda")(*bargs)
        fargs = cases[name][:-3] + tuple(back)
        _same_bits(getattr(fb_circ_cuda, name + "_cuda")(*fargs),
                   getattr(fb_circ_cuda, name + "_plain")(*fargs))


@pytest.mark.parametrize("B", [1, 7, 9, 33, 1027])
@pytest.mark.parametrize("wp", [8, 24, 32, 64, 128])
def test_serve_kernels_random_inputs(cuda, wp, B):
    """The six serving kernels bit-equal to their plain versions at one to
    four rows a thread (the forwards by TMA up to Wp 64 where B is a
    multiple of 4, else cp.async), over lane counts that are no multiple of
    a block's, 67 diagonals (a partial tile), both model branches."""
    for chain_model in (True, False):
        _serve_equal(cuda, _random_serve(cuda, 67, wp, B, chain_model,
                                         seed=wp + B + chain_model))


@pytest.mark.parametrize("d1k", [1, 2, 9, 17])
def test_serve_kernels_short_bands(cuda, d1k):
    """The serving kernels over one, two, nine (part of a tile) and 17
    diagonals (a tile and one), every terminal at d = 0 too."""
    for wp in (24, 48):
        _serve_equal(cuda, _random_serve(cuda, d1k, wp, 36, True, seed=d1k))
        _serve_equal(cuda, _random_serve(cuda, d1k, wp, 36, False,
                                         seed=d1k + 1, final_d=0))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [8, 16])
def test_serve_kernels_lanes_a_block(cuda, lanes, aligned):
    """The serving forwards at each block size they take (the backwards
    take 8 lanes whatever B), their byte tiles as words (B a multiple of
    4, the forwards' bands by TMA) or byte by byte (cp.async), bit-equal to
    plain."""
    B = _lanes_at(cuda, lanes, aligned)
    for name in SERVE_BACKWARDS + SERVE_FORWARDS:
        res = fb_circ_cuda.serve_resources(cuda, name, 24, B)
        want = lanes if name in SERVE_FORWARDS else 8
        assert res["lanes_per_block"] == want, (name, res)
    _serve_equal(cuda, _random_serve(cuda, 20, 24, B, True, seed=lanes))


def test_serve_kernels_path_shapes(cuda):
    """The serve phase's realign shape [3072, 24, 1024] (8 lanes a block)
    and the caller's [128, 24, 32768] (the forwards 16 lanes a block):
    each kernel at its lanes a block, bit-equal to plain on a slice of the
    diagonals."""
    for B, lanes, d1k in ((1024, 8, 40), (32768, 16, 20)):
        for name in SERVE_BACKWARDS + SERVE_FORWARDS:
            res = fb_circ_cuda.serve_resources(cuda, name, 24, B)
            want = lanes if name in SERVE_FORWARDS else 8
            assert res["lanes_per_block"] == want, (name, B, res)
        _serve_equal(cuda, _random_serve(cuda, d1k, 24, B, True, seed=B))


@pytest.mark.parametrize("wp", [8, 24, 32, 64, 96, 128])
def test_serve_kernels_resources(cuda, wp):
    """The serving kernels serve every Wp <= 128 at 8 and 16 lanes a
    block where they fit, one block an SM at least, no stack or spill up
    to two rows a thread; ptxas reports no spill in any variant."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name in SERVE_BACKWARDS + SERVE_FORWARDS:
        for lanes in (8, 16):
            res = fb_circ_cuda.serve_resources(cuda, name, wp,
                                               lanes * sms + 4)
            if res["lanes_per_block"] < lanes:
                continue    # 16 lanes do not fit at this Wp
            assert res["lanes_per_block"] == lanes, (name, res)
            assert res["blocks_per_sm"] >= 1, (name, res)
            if wp <= 64:
                assert res["local_bytes"] == 0, (name, res)
    fn, spills = None, {}
    for line in _build.build_log().splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif "spill stores" in line and fn and "serve_" in fn:
            spills[fn] = line.strip()
    assert spills, "no ptxas report for the serving kernels"
    bad = {f: s for f, s in spills.items()
           if not s.split("bytes stack frame, ")[1].startswith("0 bytes")}
    assert not bad, bad


# ----------------- the checkpoint pair: a replay warp and a forward warp


def _ckpt_equal(cuda, codes, kb):
    """circ_ckpt_backward and circ_ckpt_post (csrc/fb_ckpt.cu) on the codes
    arguments `codes` (coef, chain, table, xb, yb, valid, fink, find) at kb
    diagonals a checkpoint: ck, cs, logZ and post bit for bit against the
    plain versions (the posterior pass on the plain checkpoints and on the
    card's own), one launch each."""
    names = ("circ_ckpt_backward", "circ_ckpt_post")
    before = {n: _build.launch_counts[n] for n in names}
    got = fb_circ_cuda.circ_ckpt_backward_cuda(*codes, kb)
    want = fb_circ_cuda.circ_ckpt_backward_plain(*codes, kb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same_bits(g, w)
    post = fb_circ_cuda.circ_ckpt_post_cuda(*codes, *want, kb)
    wpost = fb_circ_cuda.circ_ckpt_post_plain(*codes, *want, kb)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[n] == before[n] + 1 for n in names)
    _same_bits(post, wpost)
    _same_bits(fb_circ_cuda.circ_ckpt_post_cuda(*codes, *got, kb), wpost)


@pytest.mark.parametrize("wp", [24, 32, 48, 64, 128])
def test_ckpt_pair_random_inputs(cuda, wp):
    """The checkpoint pair at its KB (ops/fb_circ_cuda.py `ckpt_block`: 32,
    16, 8, 32, 32) over one block (G = 1: the pipeline only fills), two
    with a partial top block and four with a partial top tile, lane counts
    that are no multiple of a block (byte by byte) and a multiple of 4
    (words), below and above 16 lanes an SM (the posterior pass
    pipelined, then sequential up to Wp 56), both model branches, codes
    outside 0..4, terminals at d = 0, a rescale edge, a tile edge and
    anywhere."""
    kb = fb_circ_cuda.ckpt_block(wp)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for d1k, B, chain_model in ((kb, 9, True), (kb + 5, 36, False),
                                (3 * kb + 11, 1027, True),
                                (2 * kb + 3, 16 * sms + 5, False)):
        cases = _random_serve(cuda, d1k, wp, B, chain_model,
                              seed=wp + d1k + B)
        _ckpt_equal(cuda, cases["circ_backward_codes"], kb)


@pytest.mark.parametrize("d1k", [1, 2, 9, 17])
def test_ckpt_pair_short_bands(cuda, d1k):
    """One, two, nine (part of a tile) and 17 diagonals (a tile and one) at
    Wp 24 and 48, every terminal at d = 0 too."""
    for wp in (24, 48):
        kb = fb_circ_cuda.ckpt_block(wp)
        _ckpt_equal(cuda, _random_serve(cuda, d1k, wp, 36, True, seed=d1k)[
            "circ_backward_codes"], kb)
        _ckpt_equal(cuda, _random_serve(cuda, d1k, wp, 36, False,
                                        seed=d1k + 1, final_d=0)[
            "circ_backward_codes"], kb)


def test_ckpt_pair_refuses_partial_tiles(cuda):
    """A KB that is no multiple of the kernels' tile (16 diagonals at one
    row a thread) raises; nothing falls back to the plain versions."""
    codes = _random_serve(cuda, 40, 24, 16, True, seed=5)[
        "circ_backward_codes"]
    with pytest.raises(RuntimeError, match="circ_ckpt_backward"):
        fb_circ_cuda.circ_ckpt_backward_cuda(*codes, 8)
    ck = fb_circ_cuda.circ_ckpt_backward_plain(*codes, 8)
    with pytest.raises(RuntimeError, match="circ_ckpt_post"):
        fb_circ_cuda.circ_ckpt_post_cuda(*codes, *ck, 8)


@pytest.mark.parametrize("wp", [24, 32, 48, 64, 96, 128])
def test_ckpt_pair_resources(cuda, wp):
    """At the serve phase's lane counts (1024 and 32768) and KB: the
    backward 8 lanes a block; the posterior pass up to Wp 56 pipelined at
    8 lanes of two warps at 1024 lanes and sequential at 16 lanes of one
    warp at 32768, above Wp 56 pipelined at 4 lanes, its tiles in shared
    memory up to Wp 64 and in device memory at Wp 96 and 128; one block
    an SM at least; no spill and no stack (local memory) at Wp <= 64."""
    kb = fb_circ_cuda.ckpt_block(wp)
    for B in (1024, 32768):
        bwd = fb_circ_cuda.ckpt_resources(cuda, "circ_ckpt_backward", wp, B,
                                          kb)
        post = fb_circ_cuda.ckpt_resources(cuda, "circ_ckpt_post", wp, B,
                                           kb)
        assert bwd["lanes_per_block"] == 8, bwd
        sequential = wp <= 56 and B == 32768
        assert post["lanes_per_block"] == (
            16 if sequential else 8 if wp <= 56 else 4), post
        assert post["warps_per_lane"] == (1 if sequential else 2), post
        assert post["threads_per_block"] == 32 * post["lanes_per_block"] * \
            post["warps_per_lane"], post
        assert (post["scratch_floats_per_block"] > 0) == (wp > 64), post
        for res in (bwd, post):
            assert res["blocks_per_sm"] >= 1, res
            if wp <= 64:
                assert res["local_bytes"] == 0, res



# ------------------------------------------------------ device tracebacks


def _moves_lanes(B, width, seed):
    """Band offsets and lengths of B lanes (random pairs of 0-90 bases, a
    lane with m = 0, one with n = 0, one of a single base each, then
    padding lanes) and a random final state a lane."""
    rng = np.random.default_rng(seed)
    sizes = [(int(rng.integers(0, 90)), int(rng.integers(0, 90)))
             for _ in range(max(B - 4, 0))]
    sizes = ([(0, 5), (6, 0), (1, 1)] + sizes)[:max(B - 1, 1)]
    reads = [rng.integers(0, 4, m).astype(np.int8) for m, _ in sizes]
    refs = [rng.integers(0, 4, n).astype(np.int8) for _, n in sizes]
    batch = pack_banded_batch(reads, refs, width=width, pad_batch_to=B)
    fs = rng.integers(0, 3, B).astype(np.int32)
    return batch, fs


def _moves_args(cuda, batch, ptr, fs=None):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
    args = (ptr, t(batch.lo), t(batch.m), t(batch.n))
    return args if fs is None else args + (t(fs),)


def _check_moves(name, args):
    from marginalign_trna_tpu_torch.ops import traceback_device as tb

    before = _build.launch_counts[name]
    got = getattr(tb, name + "_cuda")(*args)
    want = getattr(tb, name + "_plain")(*args)
    torch.cuda.synchronize()
    D1, _, B = args[0].shape
    assert got.shape == want.shape == (-(-(D1 - 1) // 4), B)
    assert torch.equal(got, want)
    assert _build.launch_counts[name] == before + (1 if got.numel() else 0)
    return got


@pytest.mark.parametrize("width", [9, 40])
def test_nw_moves_kernel_on_k1_pointers(cuda, width):
    """nw_moves on K1's pointers and final states (the guide's inputs),
    byte-equal to its plain version."""
    batch = _batch(width)
    dev = device_batch(batch, cuda)
    ptr, _, state = wavefront_cuda.banded_nw_cuda(
        (1.0, -2.0, -3.0, -1.0), dev.xb, dev.yb, dev.valid, dev.s1, dev.s2,
        dev.final_d, dev.final_k)
    _check_moves("nw_moves", _moves_args(cuda, batch, ptr) + (state,))


@pytest.mark.parametrize("B", [1, 13, 33, 1027])
@pytest.mark.parametrize("name", ["nw_moves", "mea_moves"])
def test_moves_kernels_random_pointers(cuda, name, B):
    """Random pointer values (every NW bit pattern; MEA 0-3), so that walks
    leave the band and read pointer 0 there, random final states, lanes
    with m = 0, n = 0 and length 1, B not a multiple of 32: byte-equal to
    the plain versions."""
    batch, fs = _moves_lanes(B, 21, B)
    D1, Wp, _ = batch.valid.shape
    rng = np.random.default_rng(B + 1)
    hi = 16 if name == "nw_moves" else 4
    ptr = torch.from_numpy(rng.integers(0, hi, (D1, Wp, B)).astype(
        np.uint8)).to(cuda)
    args = _moves_args(cuda, batch, ptr, fs if name == "nw_moves" else None)
    _check_moves(name, args)


@pytest.mark.parametrize("D1", [1, 2, 5, 6, 9])
def test_moves_kernels_short_bands(cuda, D1):
    """D1 - 1 below, at and past a multiple of 4 (D1 = 1: no move, no
    launch): byte-equal to the plain versions."""
    B = 7
    rng = np.random.default_rng(D1)
    lo = np.zeros((D1, B), np.int32)
    m = rng.integers(0, D1, B).astype(np.int32)
    n = np.array([max(0, D1 - 1 - x - int(rng.integers(0, 2))) for x in m],
                 np.int32)
    ptr = torch.from_numpy(rng.integers(0, 16, (D1, 8, B)).astype(
        np.uint8)).to(cuda)

    def t(a):
        return torch.from_numpy(a).to(cuda)
    fs = t(rng.integers(0, 3, B).astype(np.int32))
    _check_moves("nw_moves", (ptr, t(lo), t(m), t(n), fs))
    _check_moves("mea_moves", ((ptr % 3).contiguous(), t(lo), t(m), t(n)))
