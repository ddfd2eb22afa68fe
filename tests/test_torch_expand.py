"""Port stream expansion (plain version of the expand_streams CUDA kernel)
vs the JAX package's delay-line Pallas kernel `_expand_streams` (interpret
mode) and its `monotone_gather` feeds, on the same compact batch."""
import os

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import band as jband
from marginalign_trna_tpu.ops.bucket_scatter import GROUP, monotone_gather
from marginalign_trna_tpu.ops.fb import make_tables
from marginalign_trna_tpu.ops.fb_pallas import (
    _expand_streams, compact_device_batch as jax_compact_device_batch,
    static_tables,
)
from marginalign_trna_tpu_torch.ops import band as tband
from marginalign_trna_tpu_torch.ops.bucket_scatter import (
    monotone_gather_plain,
)
from marginalign_trna_tpu_torch.ops.fb_circ import compact_device_batch
from marginalign_trna_tpu_torch.ops.fb_circ_cuda import expand_streams_plain

MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "marginalign_trna_tpu_torch", "models",
                     "last_hmm_20.txt")
WIDTH = 21


def _inputs(seed):
    """Five pairs (one with an indel-ful guide path, one of 5 x 8 bases)
    and padded lanes, as tests/test_expand.py builds them."""
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, size=mm).astype(np.int8)
             for mm in (40, 73, 80, 5, 64)]
    refs = [rng.integers(0, 4, size=nn).astype(np.int8)
            for nn in (45, 70, 77, 8, 60)]
    reads[1][7] = 4
    paths = [None] * len(reads)
    m0, n0 = len(reads[2]), len(refs[2])
    c = min(m0, n0) // 2
    paths[2] = tband.path_from_cigar([(0, c), (1, m0 - c), (2, n0 - c)])
    return reads, refs, paths


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    reads, refs, paths = _inputs(request.param)
    comp_t = tband.pack_compact_batch(reads, refs, width=WIDTH, paths=paths,
                                      quantize=True)
    comp_j = jband.pack_compact_batch(reads, refs, width=WIDTH, paths=paths,
                                      quantize=True)
    hmm = PairHmm.load(MODEL)
    return comp_t, comp_j, hmm


def test_pack_compact_batch_copy_matches_jax(case):
    comp_t, comp_j, _ = case
    for field in ("lo", "m", "n", "final_d", "final_k", "reads_p", "refs_p",
                  "x_init", "y_init"):
        assert np.array_equal(getattr(comp_t, field), getattr(comp_j, field))
    assert comp_t.dp_cells() == comp_j.dp_cells()


def test_expand_plain_matches_pallas(case):
    """es and fr equal exactly; yb equal on every valid cell (elsewhere
    the delay line holds window leftovers, masked by es = -1)."""
    comp_t, comp_j, hmm = case
    st = static_tables(make_tables(hmm))
    d1k = -(-comp_j.num_steps // 8) * 8
    es_j, yb_j, fr_j, _, _ = _expand_streams(
        st, jax_compact_device_batch(comp_j), WIDTH, d1k, want_yb=True)
    es_j, yb_j, fr_j = (np.asarray(a) for a in (es_j, yb_j, fr_j))

    dev = compact_device_batch(comp_t, "cpu")
    ematch = np.asarray(hmm.match_emissions_5x5(), np.float32).reshape(-1)
    es, yb, fr = expand_streams_plain(ematch, dev.reads, dev.refs, dev.lo,
                                      dev.m, dev.n, WIDTH, comp_t.wp, d1k)
    assert es.shape == es_j.shape == (d1k, comp_t.wp, comp_t.batch)
    assert np.array_equal(es.numpy(), es_j)
    assert np.array_equal(fr.numpy(), fr_j)
    valid = es_j >= 0
    assert valid.sum() == comp_t.dp_cells()
    assert np.array_equal(yb.numpy()[valid], yb_j[valid])


def test_monotone_gather_plain_matches_pallas(case):
    """The three index streams the delay line is fed with (read codes at
    lo + Wp - 2, ref codes at gu - 1 and gu - Wp), gathered by the TPU
    kernel and by the plain version that the expand kernel's direct loads
    stand for."""
    comp_t, _, _ = case
    Wp = comp_t.wp
    lo = comp_t.lo.astype(np.int64)
    D1, B = lo.shape
    d1kg = -(-D1 // GROUP) * GROUP
    lo = np.concatenate([lo, np.repeat(lo[-1:], d1kg - D1, axis=0)])
    gu = np.arange(d1kg)[:, None] - lo
    for src, idx in (
        (comp_t.reads_p, lo + Wp - 2),
        (comp_t.refs_p, gu - 1),
        (comp_t.refs_p, gu - Wp),
    ):
        idx = np.clip(idx, 0, src.shape[0] - 1).astype(np.int32)
        srcf = src.astype(np.float32)
        want = np.asarray(monotone_gather(srcf, idx))
        got = monotone_gather_plain(torch.from_numpy(srcf),
                                    torch.from_numpy(idx))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_packer_copies_match_jax(seed):
    """The port's copies of the host band packers equal the JAX package's
    full band streams; the port's flush-row streams (circ_mw_streams, and
    the expand kernel's fr) equal the JAX package's host constructors."""
    reads, refs, paths = _inputs(seed)
    full_t = tband.pack_banded_batch(reads, refs, width=WIDTH, paths=paths,
                                     quantize=True)
    full_j = jband.pack_banded_batch(reads, refs, width=WIDTH, paths=paths,
                                     quantize=True)
    for field in ("xb", "yb", "valid", "s1", "s2", "lo", "final_d",
                  "final_k", "m", "n"):
        assert np.array_equal(getattr(full_t, field), getattr(full_j, field))
    d1k = -(-full_t.num_steps // 8) * 8 + 8
    streams = tband.circ_mw_streams(torch.from_numpy(full_t.lo), WIDTH,
                                    full_t.wp, d1k)
    for fn, got in zip(("circ_flush_rows", "circ_row_flush_rows",
                        "circ_lo_mod_rows"), streams):
        assert np.array_equal(got.numpy(), getattr(jband, fn)(full_j, d1k))
    dev = compact_device_batch(tband.pack_compact_batch(
        reads, refs, width=WIDTH, paths=paths, quantize=True), "cpu")
    _, _, fr = expand_streams_plain(np.zeros(25, np.float32), dev.reads,
                                    dev.refs, dev.lo, dev.m, dev.n, WIDTH,
                                    full_t.wp, d1k)
    assert np.array_equal(fr.numpy(), jband.circ_flush_rows(full_j, d1k))
