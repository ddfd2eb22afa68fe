"""Host band packing, shared with the JAX package.

The [D1, Wp, B] band geometry and its host packers are numpy code in
marginalign_trna_tpu/ops/band.py, free of jax at import and reused
unchanged; this module names them inside the port, so callers of the port
import the port only.
"""
from marginalign_trna_tpu.ops.band import (  # noqa: F401
    BandedBatch,
    band_offsets,
    pack_banded_batch,
    padded_band_width,
    path_from_cigar,
)
