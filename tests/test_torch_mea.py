"""Port MEA decode (gap weights in plain torch + the plain PyTorch version
of the banded_mea CUDA kernel) vs the JAX package's host weights, Pallas
kernel (interpret mode) and host decode."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from marginalign_trna_tpu.ops import mea as jmea
from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.wavefront_pallas import banded_mea_pallas
from marginalign_trna_tpu_torch.ops import mea as tmea
from marginalign_trna_tpu_torch.ops.fb import device_batch


@pytest.fixture(scope="module")
def case():
    """Width-21 batch with a moving band and random in-band posteriors."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 4, size=70).astype(np.int8)
    reads = [np.concatenate([x[:30], x[38:]]),
             rng.integers(0, 4, 17).astype(np.int8),
             rng.integers(0, 4, 30).astype(np.int8)]
    refs = [x, rng.integers(0, 4, 15).astype(np.int8),
            rng.integers(0, 4, 28).astype(np.int8)]
    paths = [path_from_cigar([(0, 30), (2, 8), (0, 32)]), None, None]
    batch = pack_banded_batch(reads, refs, width=21, paths=paths,
                              pad_batch_to=4)
    D1, Wp, B = batch.xb.shape
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid
    post *= 0.6
    return batch, post


def _weights(batch, post, gap_gamma):
    return tmea.mea_weights(
        torch.from_numpy(post), torch.from_numpy(batch.valid),
        torch.from_numpy(batch.lo), gap_gamma, int(batch.m.max()),
        int(batch.n.max()),
    )


@pytest.mark.parametrize("gap_gamma", [0.5, 0.9])
def test_mea_weights_match_jax(case, gap_gamma):
    batch, post = case
    wup, wleft = _weights(batch, post, gap_gamma)
    jup, jleft = jmea.mea_weights(post, batch, gap_gamma)
    assert np.allclose(wup.numpy(), jup, rtol=0, atol=1e-5)
    assert np.allclose(wleft.numpy(), jleft, rtol=0, atol=1e-5)


def test_mea_plain_matches_pallas(case):
    batch, post = case
    wup, wleft = _weights(batch, post, 0.5)
    wdiag = np.where(post > 0, post, jmea.NEG).astype(np.float32)
    dev = device_batch(batch, "cpu")
    got = tmea.banded_mea(torch.from_numpy(wdiag), wup, wleft, dev.valid,
                          dev.s1, dev.s2, dev.final_d, dev.final_k)
    ref = banded_mea_pallas(
        jnp.asarray(wdiag), jnp.asarray(wup.numpy()),
        jnp.asarray(wleft.numpy()), jnp.asarray(batch.valid),
        jnp.asarray(batch.s1), jnp.asarray(batch.s2),
        jnp.asarray(batch.final_d), jnp.asarray(batch.final_k),
    )
    ptr = np.ascontiguousarray(got.pointers.numpy())
    # Same adds and compares in the same order: bit-identical pointers.
    assert np.array_equal(ptr, np.asarray(ref.pointers))
    assert np.allclose(got.score.numpy(), np.asarray(ref.score), rtol=0,
                       atol=1e-4)
    for b in range(3):
        assert (tmea._traceback_one(ptr, batch, b)
                == jmea._traceback_one(np.asarray(ref.pointers), batch, b))


@pytest.mark.parametrize("match_gamma", [0.0, 0.3])
def test_mea_decode_matches_jax(case, match_gamma):
    batch, post = case
    dev = device_batch(batch, "cpu")
    got = tmea.mea_decode(torch.from_numpy(post), batch, dev, 0.5,
                          match_gamma)
    ref = jmea.mea_decode(post, batch, 0.5, match_gamma)
    assert got[:3] == ref[:3]
    for b in range(3):
        assert sum(ln for op, ln in got[b] if op != 2) == batch.m[b]
        assert sum(ln for op, ln in got[b] if op != 1) == batch.n[b]
