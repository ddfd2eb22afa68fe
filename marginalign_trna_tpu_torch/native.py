"""ctypes bindings for the native host-runtime library (native/).

Auto-builds native/libmargin_native.so on first use when a toolchain is
available; every entry point has a pure-Python fallback so the framework
works without the native layer (just slower host-side tracebacks/chaining).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmargin_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MARGINALIGN_NO_NATIVE"):
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.nw_traceback.restype = i64
    lib.nw_traceback.argtypes = [
        p(ctypes.c_uint8), p(ctypes.c_int32),
        i64, i64, i64, i64, i64, i64, ctypes.c_int32,
        p(ctypes.c_uint8), i64,
    ]
    lib.mea_traceback.restype = i64
    lib.mea_traceback.argtypes = [
        p(ctypes.c_uint8), p(ctypes.c_int32),
        i64, i64, i64, i64, i64, i64,
        p(ctypes.c_uint8), i64,
    ]
    lib.chain_seeds.restype = i64
    lib.chain_seeds.argtypes = [
        p(i64), p(i64), i64, i64, i64, p(i64), i64,
    ]
    if hasattr(lib, "nw_traceback_b"):
        lib.nw_traceback_b.restype = i64
        lib.nw_traceback_b.argtypes = [
            p(ctypes.c_uint8), p(ctypes.c_int32),
            i64, i64, i64, i64, i64, i64, ctypes.c_int32, ctypes.c_int32,
            p(ctypes.c_uint8), i64,
        ]
        lib.mea_traceback_b.restype = i64
        lib.mea_traceback_b.argtypes = [
            p(ctypes.c_uint8), p(ctypes.c_int32),
            i64, i64, i64, i64, i64, i64, ctypes.c_int32,
            p(ctypes.c_uint8), i64,
        ]
    lib.pack_band_lane.restype = None
    lib.pack_band_lane.argtypes = [
        p(ctypes.c_int8), i64, p(ctypes.c_int8), i64,
        p(ctypes.c_int32), i64,
        i64, i64, i64, i64,
        p(ctypes.c_int8), p(ctypes.c_int8), p(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def has_packed_readers() -> bool:
    """True when the built .so exposes the bit-packed traceback entry
    points (nw_traceback_b / mea_traceback_b).  A stale library without
    them makes the per-call tracebacks return None, and callers that kept
    pointers packed would then unpack the WHOLE array once per read —
    the per-lane-recopy pathology; check once per bucket instead."""
    lib = _load()
    return (lib is not None and hasattr(lib, "nw_traceback_b")
            and hasattr(lib, "mea_traceback_b"))


def unpack_ptrs(packed: np.ndarray, bits: int, wp: int) -> np.ndarray:
    """Host-side inverse of wavefront_pallas.pack_ptr_bits (for the pure-
    Python traceback fallback): [D1, Wq, B] uint8 -> [D1, wp, B] uint8."""
    if bits == 8:
        return packed
    per = 8 // bits
    D1, Wq, B = packed.shape
    mask = (1 << bits) - 1
    out = np.empty((D1, Wq * per, B), np.uint8)
    for t in range(per):
        out[:, t::per, :] = (packed >> (t * bits)) & mask
    return np.ascontiguousarray(out[:, :wp])


def _rle(ops: np.ndarray) -> List[Tuple[int, int]]:
    """Run-length encode a reversed op array into [(op, len)] (fwd order).
    Vectorised: the per-element Python loop cost ~1.3ms per 7kb-read
    traceback, which at production read counts was a visible slice of the
    guide/realign walls."""
    if len(ops) == 0:
        return []
    ops = ops[::-1]
    change = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(ops)]])
    return [(int(ops[s]), int(e - s)) for s, e in zip(starts, ends)]


def nw_traceback(
    pointers: np.ndarray,  # [D1, Wp_arr, B] uint8, C-contiguous
    lo: np.ndarray,        # [D1] int32
    lane: int,
    m: int,
    n: int,
    final_state: int,
    bits: int = 8,         # cells packed (8 // bits) per byte along Wp
) -> Optional[List[Tuple[int, int]]]:
    lib = _load()
    if lib is None:
        return None
    if bits != 8 and not hasattr(lib, "nw_traceback_b"):
        return None  # stale .so without the packed entry point
    d1, wp, b = pointers.shape
    out = np.empty(m + n + 2, dtype=np.uint8)
    lo_p = np.ascontiguousarray(lo, dtype=np.int32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int32))
    ptr_p = pointers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out_p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if bits == 8:
        cnt = lib.nw_traceback(
            ptr_p, lo_p, d1, wp, b, lane, m, n, final_state, out_p,
            len(out),
        )
    else:
        cnt = lib.nw_traceback_b(
            ptr_p, lo_p, d1, wp, b, lane, m, n, final_state, bits, out_p,
            len(out),
        )
    if cnt < 0:
        return None
    return _rle(out[:cnt])


def mea_traceback(
    pointers: np.ndarray, lo: np.ndarray, lane: int, m: int, n: int,
    bits: int = 8,
) -> Optional[List[Tuple[int, int]]]:
    lib = _load()
    if lib is None:
        return None
    if bits != 8 and not hasattr(lib, "mea_traceback_b"):
        return None
    d1, wp, b = pointers.shape
    out = np.empty(m + n + 2, dtype=np.uint8)
    lo_p = np.ascontiguousarray(lo, dtype=np.int32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int32))
    ptr_p = pointers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out_p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if bits == 8:
        cnt = lib.mea_traceback(
            ptr_p, lo_p, d1, wp, b, lane, m, n, out_p, len(out),
        )
    else:
        cnt = lib.mea_traceback_b(
            ptr_p, lo_p, d1, wp, b, lane, m, n, bits, out_p, len(out),
        )
    if cnt < 0:
        return None
    return _rle(out[:cnt])


def pack_band_lane(
    read_codes: np.ndarray,
    ref_codes: np.ndarray,
    lo: np.ndarray,
    width: int,
    xb: np.ndarray,
    yb: np.ndarray,
    valid: np.ndarray,
    lane: int,
) -> bool:
    """Fill one lane of the [D1, Wp, B] banded arrays.  Returns False when
    the native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    d1, wp, b = xb.shape
    assert xb.flags.c_contiguous and yb.flags.c_contiguous
    assert valid.flags.c_contiguous and valid.dtype == np.bool_
    read_codes = np.ascontiguousarray(read_codes, dtype=np.int8)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.int8)
    lo32 = np.ascontiguousarray(lo, dtype=np.int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.pack_band_lane(
        read_codes.ctypes.data_as(i8p), len(read_codes),
        ref_codes.ctypes.data_as(i8p), len(ref_codes),
        lo32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width,
        d1, wp, b, lane,
        xb.ctypes.data_as(i8p), yb.ctypes.data_as(i8p),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return True


def chain_seeds(
    q: np.ndarray, r: np.ndarray, max_gap2: int, max_drift: int
) -> Optional[np.ndarray]:
    """Indices (chain order) of the best colinear chain, or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    out = np.empty(len(q), dtype=np.int64)
    cnt = lib.chain_seeds(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(q), max_gap2, max_drift,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(out),
    )
    if cnt < 0:
        return None
    return out[:cnt]
