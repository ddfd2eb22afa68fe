"""The port's device tracebacks (ops/traceback_device.py: the plain
versions of the nw_moves and mea_moves kernels) against the JAX package's
scans (`nw_moves_device`, `mea_moves_device`, `pack_moves`) and the native
host tracebacks, on the CPU, all exactly.

Pointer bands come from the JAX package's banded_nw / banded_mea (XLA) on
seeded random batches, as tests/test_traceback_device.py builds them, and
from the port's plain K1, K4 and D on the same inputs.  The batches hold
lanes with m = 0, n = 0 and length 1, padding lanes and D1 - 1 not a
multiple of 4.  MEA pointer value 3 follows the host traceback, not the
JAX scan.  The guide and the fused and REL realignments on device="cpu"
run with the native tracebacks refusing, and give the SAM records of the
route that pulls the pointer band and walks it with them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marginalign_trna_tpu.ops.band import pack_banded_batch as jpack
from marginalign_trna_tpu.ops.fb import device_batch as jdevice_batch
from marginalign_trna_tpu.ops.mea import (
    NEG as JNEG, banded_mea as jbanded_mea, mea_weights as jmea_weights,
)
from marginalign_trna_tpu.ops.nw import banded_nw as jbanded_nw
from marginalign_trna_tpu.ops.traceback_device import (
    mea_moves_device, nw_moves_device, pack_moves as jpack_moves,
)
from marginalign_trna_tpu_torch import native
from marginalign_trna_tpu_torch import pipeline as tpipeline
from marginalign_trna_tpu_torch.align import guide as tguide
from marginalign_trna_tpu_torch.align.realign import realign_sam_file
from marginalign_trna_tpu_torch.models.hmm import PairHmm
from marginalign_trna_tpu_torch.ops import mea as tmea
from marginalign_trna_tpu_torch.ops import traceback_device as tb
from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
from marginalign_trna_tpu_torch.ops.fb import device_batch
from marginalign_trna_tpu_torch.ops.mea import NEG, mea_weights
from marginalign_trna_tpu_torch.ops.wavefront_cuda import (
    banded_mea_plain, banded_nw_plain, mea_dl_plain,
)

NW_PARAMS = (1.0, -2.0, -3.0, -1.0)
WIDTH = 21


def _mutate(rng, x, sub=0.12, ind=0.06):
    out = []
    for c in x:
        r = rng.random()
        if r < ind / 2:
            continue  # deletion
        if r < ind:
            out.append(int(rng.integers(0, 4)))  # insertion
        out.append(int(c) if rng.random() > sub else int(rng.integers(0, 4)))
    return np.asarray(out, np.int8)


def _pairs(seed, sizes=(9, 40, 85, 1, 130, 62)):
    """Noisy pairs of the given reference sizes, plus a lane with an empty
    read (m = 0), one with an empty reference (n = 0) and one with a
    single base on each side."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, size=n).astype(np.int8) for n in sizes]
    reads = [_mutate(rng, x) for x in refs]
    reads += [np.zeros(0, np.int8), rng.integers(0, 4, 5).astype(np.int8),
              np.array([2], np.int8)]
    refs += [rng.integers(0, 4, 7).astype(np.int8), np.zeros(0, np.int8),
             np.array([1], np.int8)]
    return reads, refs


def _lanes(batch):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return t(batch.lo), t(batch.m), t(batch.n)


def _nw_band(source, seed):
    """(host batch, pointers [D1, Wp, B] uint8, final states [B]) of the
    guide Viterbi from the JAX package (XLA) or the port's plain K1."""
    reads, refs = _pairs(seed)
    if source == "jax":
        batch = jpack(reads, refs, width=40, pad_batch_to=13)
        res = jbanded_nw(jnp.asarray(NW_PARAMS, jnp.float32),
                         jdevice_batch(batch))
        return (batch, np.array(res.pointers),
                np.asarray(res.final_state).astype(np.int32))
    batch = pack_banded_batch(reads, refs, width=40, pad_batch_to=13)
    dev = device_batch(batch, "cpu")
    ptr, _, state = banded_nw_plain(NW_PARAMS, dev.xb, dev.yb, dev.valid,
                                    dev.s1, dev.s2, dev.final_d, dev.final_k)
    return batch, ptr.numpy(), state.numpy()


def _mea_band(source, seed):
    """(host batch, pointers [D1, Wp, B] uint8) of the MEA decode over a
    random posterior band: the JAX package's banded_mea (XLA), the port's
    plain K4 on the same weights, or the port's plain D (weights derived
    from the band and random row and column sums)."""
    reads, refs = _pairs(seed)
    rng = np.random.default_rng(seed + 100)
    if source == "jax":
        batch = jpack(reads, refs, width=WIDTH, pad_batch_to=13)
    else:
        batch = pack_banded_batch(reads, refs, width=WIDTH, pad_batch_to=13)
    D1, Wp, B = batch.valid.shape
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid
    if source == "jax":
        wup, wleft = jmea_weights(post, batch, 0.5)
        wdiag = np.where(post > 0, post, JNEG).astype(np.float32)
        res = jbanded_mea(
            jnp.asarray(wdiag), jnp.asarray(wup), jnp.asarray(wleft),
            jnp.asarray(batch.valid), jnp.asarray(batch.s1),
            jnp.asarray(batch.s2), jnp.asarray(batch.final_d),
            jnp.asarray(batch.final_k))
        return batch, np.array(res.pointers)
    dev = device_batch(batch, "cpu")
    lo, m, n = _lanes(batch)
    tpost = torch.from_numpy(post)
    if source == "k4":
        wup, wleft = mea_weights(tpost, dev.valid, lo, 0.5,
                                 int(batch.m.max()), int(batch.n.max()))
        ptr, _ = banded_mea_plain(torch.where(tpost > 0, tpost, NEG), wup,
                                  wleft, dev.valid, dev.s1, dev.s2,
                                  dev.final_d, dev.final_k)
        return batch, ptr.numpy()
    accr = torch.from_numpy(rng.random((256, B)).astype(np.float32) * 1.2)
    accc = torch.from_numpy(rng.random((256, B)).astype(np.float32) * 1.2)
    ptr, _ = mea_dl_plain(tpost, lo, m, n, WIDTH, dev.final_d, dev.final_k,
                          accr, accc, 0.5, 0.0)
    return batch, ptr.numpy()


def _check_lanes(batch, ptrs, moves, walk):
    """Every lane's ops from the move stream equal the native traceback's
    (`walk(pointers, lo, lane, m, n)`)."""
    assert ptrs.flags.c_contiguous
    for b in range(ptrs.shape[2]):
        want = walk(ptrs, batch.lo[:, b], b, int(batch.m[b]),
                    int(batch.n[b]))
        assert want is not None, "native traceback unavailable (lane %d)" % b
        assert tb.ops_from_moves(moves, b) == want, "lane %d" % b


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("source", ["jax", "k1"])
def test_nw_moves_match_jax_and_native(source, seed):
    """The plain nw_moves walk equals the JAX scan move for move, its packed
    stream equals JAX pack_moves byte for byte, and every lane's ops equal
    the native NW traceback's."""
    batch, ptrs, fs = _nw_band(source, seed)
    T = ptrs.shape[0] - 1
    lo, m, n = _lanes(batch)
    args = (torch.from_numpy(ptrs), lo, m, n, torch.from_numpy(fs))
    got = tb.nw_walk_plain(*args).numpy()
    want = np.asarray(nw_moves_device(
        jnp.asarray(ptrs), jnp.asarray(batch.lo), jnp.asarray(batch.m),
        jnp.asarray(batch.n), jnp.asarray(fs)))
    assert got.shape == (T, ptrs.shape[2])
    assert np.array_equal(got, want)
    packed = tb.nw_moves_plain(*args).numpy()
    assert np.array_equal(packed, np.asarray(jpack_moves(jnp.asarray(want))))
    moves = tb.unpack_moves(packed, T)
    assert np.array_equal(moves, want.astype(np.uint8))
    _check_lanes(batch, ptrs, moves,
                 lambda p, lo_b, b, mb, nb: native.nw_traceback(
                     p, lo_b, b, mb, nb, int(fs[b])))


def test_nw_moves_every_final_state():
    """Walks started in each of the three states (forced, lane by lane)
    equal the JAX scan move for move and pack as JAX pack_moves does."""
    batch, ptrs, _ = _nw_band("k1", 2)
    lo, m, n = _lanes(batch)
    B = ptrs.shape[2]
    fs = (np.arange(B) % 3).astype(np.int32)
    got = tb.nw_moves_plain(torch.from_numpy(ptrs), lo, m, n,
                            torch.from_numpy(fs)).numpy()
    want = np.asarray(jpack_moves(nw_moves_device(
        jnp.asarray(ptrs), jnp.asarray(batch.lo), jnp.asarray(batch.m),
        jnp.asarray(batch.n), jnp.asarray(fs))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("source", ["jax", "k4", "d"])
def test_mea_moves_match_jax_and_native(source):
    """The plain mea_moves walk equals the JAX scan move for move on
    pointers in {0, 1, 2}, its packed stream equals JAX pack_moves, and
    every lane's ops equal the native MEA traceback's."""
    batch, ptrs = _mea_band(source, 3)
    T = ptrs.shape[0] - 1
    assert set(np.unique(ptrs)) <= {0, 1, 2}
    lo, m, n = _lanes(batch)
    args = (torch.from_numpy(ptrs), lo, m, n)
    got = tb.mea_walk_plain(*args).numpy()
    want = np.asarray(mea_moves_device(
        jnp.asarray(ptrs), jnp.asarray(batch.lo), jnp.asarray(batch.m),
        jnp.asarray(batch.n)))
    assert np.array_equal(got, want)
    packed = tb.mea_moves_plain(*args).numpy()
    assert np.array_equal(packed, np.asarray(jpack_moves(jnp.asarray(want))))
    _check_lanes(batch, ptrs, tb.unpack_moves(packed, T),
                 native.mea_traceback)


def test_mea_pointer_three_follows_native():
    """A band holding MEA pointer value 3 on cells the walks read: the
    plain walk takes it as I with i decremented alone, as the native
    traceback does, where the JAX scan decrements i and j."""
    batch, ptrs = _mea_band("k4", 4)
    lo, m, n = _lanes(batch)
    clean = tb.mea_walk_plain(torch.from_numpy(ptrs), lo, m, n).numpy()
    # Turn every second up move (2) that the clean walk takes into 3.
    ptrs = ptrs.copy()
    hit = 0
    for b in range(ptrs.shape[2]):
        i, j = int(batch.m[b]), int(batch.n[b])
        for op in clean[::-1, b]:
            if op == tb.NO_MOVE:
                continue
            d = i + j
            k = i - int(batch.lo[d, b])
            if op == 1 and i > 0 and j > 0 and ptrs[d, k, b] == 2:
                hit += 1
                if hit % 2:
                    ptrs[d, k, b] = 3
            i -= op != 2
            j -= op != 1
    assert hit > 4
    got = tb.mea_moves_plain(torch.from_numpy(ptrs), lo, m, n).numpy()
    moves = tb.unpack_moves(got, ptrs.shape[0] - 1)
    assert np.array_equal(moves, clean.astype(np.uint8))
    _check_lanes(batch, ptrs, moves, native.mea_traceback)
    jax_moves = np.asarray(mea_moves_device(
        jnp.asarray(ptrs), jnp.asarray(batch.lo), jnp.asarray(batch.m),
        jnp.asarray(batch.n)))
    assert not np.array_equal(jax_moves.astype(np.uint8), moves)


@pytest.mark.parametrize("T", [0, 1, 4, 7])
def test_pack_moves_matches_jax(T):
    """pack_moves on random moves, T a multiple of 4 and not, equals JAX
    pack_moves byte for byte and unpacks to its input."""
    mvs = np.random.default_rng(T).integers(0, 4, (T, 37)).astype(np.int8)
    got = tb.pack_moves(torch.from_numpy(mvs)).numpy()
    assert got.shape == (-(-T // 4), 37)
    if T:
        assert np.array_equal(got, np.asarray(jpack_moves(jnp.asarray(mvs))))
    assert np.array_equal(tb.unpack_moves(got, T), mvs.astype(np.uint8))


def _corpus(tmp_path, n_reads=8, seed=5):
    """Two references; reads of 250-450 bases with 10% substitutions and
    short indels, every third one reverse-complemented."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    refs = [rng.integers(0, 4, size=700), rng.integers(0, 4, size=640)]
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    fa.write_text("".join(">ref%d\n%s\n" % (i, "".join(bases[r]))
                          for i, r in enumerate(refs)))
    lines = []
    for idx in range(n_reads):
        ref = refs[idx % 2]
        length = int(rng.integers(250, 450))
        start = int(rng.integers(0, len(ref) - length))
        read = ref[start:start + length].copy()
        subs = rng.random(len(read)) < 0.10
        read[subs] = rng.integers(0, 4, size=int(subs.sum()))
        read = read[rng.random(len(read)) >= 0.04]
        ins = np.flatnonzero(rng.random(len(read)) < 0.04)
        read = np.insert(read, ins + 1, rng.integers(0, 4, size=len(ins)))
        if idx % 3 == 1:
            read = (3 - read)[::-1]
        seq = "".join(bases[read])
        lines.append("@r%d\n%s\n+\n%s\n" % (idx, seq, "I" * len(seq)))
    fq.write_text("".join(lines))
    return str(fq), str(fa)


def _host_nw_lane_ops(ptrs, lo, m, n, final_state):
    """The route before the device tracebacks: the pointer band pulled to
    the host and walked lane by lane by the native NW traceback."""
    p = np.ascontiguousarray(ptrs.cpu().numpy())
    lo, m, n, fs = (t.cpu().numpy() for t in (lo, m, n, final_state))
    return [native.nw_traceback(p, lo[:, b], b, int(m[b]), int(n[b]),
                                int(fs[b])) for b in range(p.shape[2])]


def _host_mea_lane_ops(ptrs, lo, m, n):
    p = np.ascontiguousarray(ptrs.cpu().numpy())
    lo, m, n = (t.cpu().numpy() for t in (lo, m, n))
    return [native.mea_traceback(p, lo[:, b], b, int(m[b]), int(n[b]))
            for b in range(p.shape[2])]


def _refuse(*args, **kwargs):
    raise AssertionError("a native traceback ran")


@pytest.mark.parametrize("fused", [True, False])
def test_paths_without_native_tracebacks(tmp_path, monkeypatch, fused):
    """The guide (K1's bucketed path) and the realignment (fused: D, REL:
    K4) on device="cpu" with native.nw_traceback / mea_traceback refusing
    to run write the same SAM records as the route that pulls each pointer
    band to the host and walks it with them."""
    fq, fa = _corpus(tmp_path)
    hmm = PairHmm.load(tpipeline.DEFAULT_MODEL)

    def run(tag):
        chained = str(tmp_path / ("chained_%s.sam" % tag))
        out = str(tmp_path / ("out_%s.sam" % tag))
        tpipeline.align(fq, fa, chained,
                        tpipeline.AlignOptions(no_realign=True),
                        device="cpu")
        realign_sam_file(chained, out, fq, fa, hmm, "cpu", no_chain=True,
                         fused=fused)
        with open(chained) as a, open(out) as b:
            return a.read(), b.read()

    with monkeypatch.context() as mp:
        mp.setattr(tguide, "nw_lane_ops", _host_nw_lane_ops)
        mp.setattr(tmea, "mea_lane_ops", _host_mea_lane_ops)
        host_guide, host_out = run("host")
    monkeypatch.setattr(native, "nw_traceback", _refuse)
    monkeypatch.setattr(native, "mea_traceback", _refuse)
    dev_guide, dev_out = run("device")
    assert dev_guide == host_guide
    assert dev_out == host_out
    assert sum(1 for ln in dev_out.splitlines()
               if not ln.startswith("@")) >= 7
