"""Port guide Viterbi (plain PyTorch version of the banded_nw CUDA kernel)
vs the JAX package's Pallas kernel (interpret mode) and XLA scan."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from marginalign_trna_tpu.ops import nw as jnw
from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.fb import device_batch as jax_device_batch
from marginalign_trna_tpu.ops.wavefront_pallas import banded_nw_pallas
from marginalign_trna_tpu_torch.ops import nw as tnw
from marginalign_trna_tpu_torch.ops.fb import device_batch


def _mutate(rng, seq, rate=0.1):
    out = seq.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = rng.integers(0, 4, size=int(hit.sum()))
    return out


def _batch(width):
    """Random pairs plus mutated copies with indels along a guide path, and
    one N code; lane count padded past the real pairs."""
    rng = np.random.default_rng(11)
    if width == 9:
        reads = [rng.integers(0, 4, size=m).astype(np.int8)
                 for m in (9, 17, 30)]
        refs = [rng.integers(0, 4, size=n).astype(np.int8)
                for n in (12, 15, 28)]
        refs[2] = _mutate(rng, reads[2][:28])
        paths = [None, None, path_from_cigar([(0, 10), (1, 2), (0, 18)])]
        return pack_banded_batch(reads, refs, width=9, paths=paths,
                                 pad_batch_to=4)
    ref = rng.integers(0, 4, size=150).astype(np.int8)
    read_a = _mutate(rng, np.concatenate([ref[:60], ref[72:140]]))
    read_b = _mutate(rng, np.concatenate(
        [ref[5:50], rng.integers(0, 4, size=9).astype(np.int8), ref[50:120]]))
    read_b[7] = 4  # N scores 0 against anything
    reads = [read_a, read_b, rng.integers(0, 4, size=40).astype(np.int8)]
    refs = [ref[:140], ref[5:120], rng.integers(0, 4, size=35).astype(np.int8)]
    paths = [path_from_cigar([(0, 60), (2, 12), (0, 68)]),
             path_from_cigar([(0, 45), (1, 9), (0, 70)]), None]
    return pack_banded_batch(reads, refs, width=40, paths=paths,
                             pad_batch_to=8)


@pytest.mark.parametrize("width", [9, 40])
def test_nw_plain_matches_jax(width):
    batch = _batch(width)
    params = tnw.NwParams(1.0, -2.0, -3.0, -1.0)
    got = tnw.banded_nw(params, device_batch(batch, "cpu"))
    jdev = jax_device_batch(batch)
    jparams = jnp.asarray(list(params), jnp.float32)
    pallas = banded_nw_pallas(jparams, jdev)
    xla = jnw.banded_nw(jparams, jdev)

    ptr = got.pointers.numpy()
    states = got.final_state.numpy()
    # Same arithmetic and circular shifts as the Pallas kernel: every
    # pointer byte agrees, in band or not.
    assert np.array_equal(ptr, np.asarray(pallas.pointers))
    assert np.array_equal(states, np.asarray(pallas.final_state))
    assert np.array_equal(got.score.numpy(), np.asarray(pallas.score))
    # The XLA scan agrees on in-band cells of the real lanes (it reads its
    # padded lanes' terminal one step late).
    n_real = int((batch.m + batch.n > 0).sum())
    ok = batch.valid
    assert np.array_equal(ptr[ok], np.asarray(xla.pointers)[ok])
    assert np.array_equal(states[:n_real],
                          np.asarray(xla.final_state)[:n_real])
    assert np.allclose(got.score.numpy()[:n_real],
                       np.asarray(xla.score)[:n_real], rtol=0, atol=1e-4)
    for b in range(n_real):
        ops = tnw.traceback(ptr, batch, b, int(states[b]))
        assert ops == jnw.traceback(np.asarray(xla.pointers), batch, b,
                                    int(np.asarray(xla.final_state)[b]))
        assert sum(ln for op, ln in ops if op != 2) == batch.m[b]
        assert sum(ln for op, ln in ops if op != 1) == batch.n[b]


def test_nw_traceback_python_fallback_matches_native():
    from marginalign_trna_tpu import native

    batch = _batch(9)
    got = tnw.banded_nw(tnw.NwParams(), device_batch(batch, "cpu"))
    ptr = np.ascontiguousarray(got.pointers.numpy())
    for b in range(3):
        st = int(got.final_state[b])
        nat = tnw.traceback(ptr, batch, b, st)
        m, n = int(batch.m[b]), int(batch.n[b])
        # An unloaded native library forces the Python walk.
        saved = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            py = tnw._traceback_arrays(ptr, batch.lo[:, b], b, m, n, st)
        finally:
            native._lib, native._tried = saved
        assert py == nat


def test_nw_dispatch_by_device(monkeypatch):
    """Device decides the route: CUDA tensors go to the kernel wrapper,
    CPU tensors to the plain version, anything else raises."""
    from marginalign_trna_tpu_torch.ops import dispatch

    called = []
    monkeypatch.setattr(tnw, "banded_nw_cuda",
                        lambda *a: called.append("cuda") or (None,) * 3)
    monkeypatch.setattr(tnw, "banded_nw_plain",
                        lambda *a: called.append("plain") or (None,) * 3)
    dev = device_batch(_batch(9), "cpu")
    tnw.banded_nw(tnw.NwParams(), dev)
    monkeypatch.setattr(tnw, "use_kernel", lambda t: True)
    tnw.banded_nw(tnw.NwParams(), dev)
    assert called == ["plain", "cuda"]
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.empty(1, device="meta"))
