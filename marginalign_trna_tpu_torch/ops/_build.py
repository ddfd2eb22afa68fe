"""Build, load and launch the port's CUDA kernels.

Every `csrc/*.cu` source compiles with nvcc for Hopper (sm_90a), one
process per source in parallel, and links into one shared library with a
plain C interface, loaded with ctypes.  The build runs
at first CUDA use, from the sources in this package only, into
`build/torch_kernels/<hash of the sources and flags>/` at the repository
root (listed in .gitignore), so an edited source rebuilds and an unchanged
one loads the cached library.  Nothing here runs at import time: the CPU
tests import every module of the port on machines with no CUDA toolkit.

Each C entry point returns a cudaError_t; `launch` raises on anything but
cudaSuccess and counts the launch, so a run can show which kernels it went
through (`launch_counts`, `reset_launch_counts`).  `check_tensor` is the
wrappers' argument check.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_NAME = "libmarginalign_kernels.so"
LOG_NAME = "build.log"
# -fmad=false: no multiply-add contraction, so the forward-backward kernels
# round exactly like their plain versions (separate torch mul and add).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Kernel name -> argument types of its C entry point `<name>_launch`
# (csrc/*.cu); every entry point returns int (a cudaError_t) and takes the
# CUDA stream last.
_SIGNATURES: Dict[str, List] = {
    # xb, yb, valid, s1, s2, final_d, final_k, D1, Wp, B,
    # match, mismatch, gap_open, gap_extend, ptr, score, final_state, stream
    "banded_nw": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P] * 4,
    # wdiag, wup, wleft, valid, s1, s2, final_d, final_k, D1, Wp, B,
    # ptr, score, stream
    "banded_mea": [_P] * 8 + [_I] * 3 + [_P] * 3,
    # valid, em, s1, final_d, final_k, coef(host), D1, Wp, B,
    # bm, bls, logZ, stream
    "fb_backward": [_P] * 6 + [_I] * 3 + [_P] * 4,
    # em, valid, s1, bm, bls, logZ, coef(host), D1, Wp, B, post, stream
    "fb_forward": [_P] * 7 + [_I] * 3 + [_P] * 2,
    # reads, refs, lo, m, n, ematch(host), Mp, Np, D1, d1k, Wp, B, width,
    # es, yb, fr, stream
    "expand_streams": [_P] * 6 + [_I] * 7 + [_P] * 4,
    # es, fink, find, coef(host), chain, d1k, Wp, B, bm, bls, logZ, stream
    "sv_backward": [_P] * 4 + [_I] * 4 + [_P] * 4,
    # es, yb, fr, bm, bls, logZ, coef(host), chain, d1k, Wp, B, fl, tails,
    # stream
    "cx_forward": [_P] * 7 + [_I] * 4 + [_P] * 3,
    # vals, jm, C, D, B, rg, scratch (int64), groups, out, stream
    "scatter_lanesum": [_P] * 2 + [_I] * 4 + [_P, _I] + [_P] * 2,
    # reads, refs, lo, m, n, Mp, Np, D1, d1k, Wp, B, xb, yb, stream
    "expand_rel": [_P] * 5 + [_I] * 6 + [_P] * 3,
    # es, fr, frr, lom, bm, bls, logZ, coef(host), chain, d1k, Wp, B,
    # post, flc, flr, tc, tr, stream
    "mw_forward": [_P] * 8 + [_I] * 4 + [_P] * 6,
    # vals, jm, D, B, rg, out, stream
    "scatter_lanes": [_P] * 2 + [_I] * 3 + [_P] * 2,
    # post, lo, m, n, accr, accc, final_d, final_k, D1, Wp, B, width, rgm,
    # rgn, gap_gamma, match_gamma, ptr, score, stream
    "mea_dl": [_P] * 8 + [_I] * 6 + [_F] * 2 + [_P] * 3,
    # T, Em, Eg, xb, yb, valid, s1, fink, ntr, d1k, Wp, B, band, cs, lsf,
    # term, stream
    "counts_fwd_all": [_P] * 8 + [_I] * 4 + [_P] * 5,
    "counts_fwd_ckpt": [_P] * 8 + [_I] * 4 + [_P] * 5,
    # T, Em, Eg, band, lsf or cs, xb, yb, valid, s1, fink, find, logZ, ntr,
    # d1k, Wp, B, post, tcp, egp, mcp, stream
    "counts_bwd": [_P] * 12 + [_I] * 4 + [_P] * 5,
    "counts_bwd_ckpt": [_P] * 12 + [_I] * 4 + [_P] * 5,
    # T, Em, Eg, xb, yb, valid, s1, fink, d1k, Wp, B, fmatch, lsf, term,
    # stream
    "fb_generic_fwd": [_P] * 8 + [_I] * 3 + [_P] * 4,
    # T, Em, Eg, fmatch, lsf, xb, yb, valid, s1, fink, find, logZ, d1k, Wp,
    # B, post, stream
    "fb_generic_bwd": [_P] * 12 + [_I] * 3 + [_P] * 2,
    # em, valid, fink, find, coef(host), chain, d1k, Wp, B, bm, bls, logZ,
    # stream
    "circ_backward_emv": [_P] * 5 + [_I] * 4 + [_P] * 4,
    # xb, yb, valid, table(host), fink, find, coef(host), chain, d1k, Wp,
    # B, bm, bls, logZ, stream (+ es before the stream for the _es variant)
    "circ_backward_codes": [_P] * 7 + [_I] * 4 + [_P] * 4,
    "circ_backward_codes_es": [_P] * 7 + [_I] * 4 + [_P] * 5,
    # es, bm, bls, logZ, coef(host), chain, d1k, Wp, B, post, stream
    "circ_post_es": [_P] * 5 + [_I] * 4 + [_P] * 2,
    # em, valid, bm, bls, logZ, coef(host), chain, d1k, Wp, B, post, stream
    "circ_post_emv": [_P] * 6 + [_I] * 4 + [_P] * 2,
    # xb, yb, valid, table(host), bm, bls, logZ, coef(host), chain, d1k,
    # Wp, B, post, stream
    "circ_post_codes": [_P] * 8 + [_I] * 4 + [_P] * 2,
    # xb, yb, valid, table(host), fink, find, coef(host), chain, d1k, Wp,
    # B, KB, ck, cs, logZ, stream
    "circ_ckpt_backward": [_P] * 7 + [_I] * 5 + [_P] * 4,
    # xb, yb, valid, table(host), fink, find, ck, cs, logZ, coef(host),
    # chain, d1k, Wp, B, KB, scratch (or null: circ_ckpt_post_scratch),
    # post, stream
    "circ_ckpt_post": [_P] * 10 + [_I] * 5 + [_P] * 3,
    # Multi-problem lanes.  xb, yb, valid, s1, s2, start, fink, find, D1,
    # Wp, B, match, mismatch, gap_open, gap_extend, ptr, term, stream
    "nw_multi": [_P] * 8 + [_I] * 3 + [_F] * 4 + [_P] * 3,
    # wdiag, wup, wleft, valid, s1, s2, start, fink, find, D1, Wp, B, ptr,
    # term, stream
    "mea_multi": [_P] * 9 + [_I] * 3 + [_P] * 3,
    # em, valid, s1, start, fink, coef(host), chain, D1, Wp, B, fm, lsf,
    # term, stream
    "fb_multi_forward": [_P] * 6 + [_I] * 4 + [_P] * 4,
    # fm, lsf, L, em, valid, s1, fink, find, coef(host), chain, D1, Wp, B,
    # post, stream
    "fb_multi_backward": [_P] * 9 + [_I] * 4 + [_P] * 2,
    # T, Em, Eg, xb, yb, valid, s1, start, fink, ntr, d1k, Wp, B, band, cs,
    # lsf, term, stream
    "counts_multi_fwd_all": [_P] * 9 + [_I] * 4 + [_P] * 5,
    "counts_multi_fwd_ckpt": [_P] * 9 + [_I] * 4 + [_P] * 5,
    # T, Em, Eg, band, lsf or cs, xb, yb, valid, s1, start, fink, find, L,
    # ntr, d1k, Wp, B, post, tcp, egp, mcp, stream
    "counts_multi_bwd": [_P] * 13 + [_I] * 4 + [_P] * 5,
    "counts_multi_bwd_ckpt": [_P] * 13 + [_I] * 4 + [_P] * 5,
    # Device tracebacks (csrc/traceback.cu).  ptrs, lo, m, n, final_state,
    # D1, Wp, B, out, stream (mea_moves: no final_state)
    "nw_moves": [_P] * 5 + [_I] * 3 + [_P] * 2,
    "mea_moves": [_P] * 4 + [_I] * 3 + [_P] * 2,
}

# Entry points that launch nothing: name -> argument types; each returns
# a cudaError_t.
_QUERIES: Dict[str, List] = {
    # multi, Wp, out[5]: registers, shared bytes per block, blocks per SM,
    # threads per block, local bytes (csrc/fb_counts.cu; `resources`)
    "counts_bwd_ckpt_info": [_I, _I, _P],
    # multi, ntr, Wp, B, out[5] (csrc/fb_counts.cu)
    "counts_fwd_ckpt_info": [_I, _I, _I, _I, _P],
    # backward, Wp, B, out[5] (csrc/fb_counts.cu: the generic pair)
    "fb_generic_info": [_I, _I, _I, _P],
    # backward, multi, ntr, Wp, B, out[5] (csrc/fb_counts.cu: the stored
    # pair)
    "counts_stored_info": [_I, _I, _I, _I, _I, _P],
    # Wp, B, out[5] (csrc/fb_circ.cu); Wp, out[5] (csrc/expand.cu)
    "mw_forward_info": [_I, _I, _P],
    "cx_forward_info": [_I, _I, _P],
    "sv_backward_info": [_I, _I, _P],
    # source, Wp, B, out[5] (csrc/fb_serve.cu: the serving backwards and
    # forwards)
    "serve_backward_info": [_I, _I, _I, _P],
    "serve_post_info": [_I, _I, _I, _P],
    # backward, Wp, B, KB, out[8]: out[5] and lanes a block, warps a lane,
    # scratch floats a block (csrc/fb_ckpt.cu: the checkpoint pair)
    "circ_ckpt_info": [_I, _I, _I, _I, _P],
    # Wp, B, KB, out[2]: scratch floats a block (0: none), blocks
    "circ_ckpt_post_scratch": [_I, _I, _I, _P],
    # Wp, B, out[6]: out[5] and the lanes a block (csrc/nw.cu,
    # csrc/mea.cu; ops/wavefront_cuda.py `warp_lane_resources`)
    "banded_nw_info": [_I, _I, _P],
    "mea_dl_info": [_I, _I, _P],
    "banded_mea_info": [_I, _I, _P],
    "nw_multi_info": [_I, _I, _P],
    "mea_multi_info": [_I, _I, _P],
    # backward, Wp, B, out[5] (csrc/fb.cu: K2, K3; csrc/fb_multi.cu: the
    # multi-lane pair)
    "fb_rel_info": [_I, _I, _I, _P],
    "fb_multi_info": [_I, _I, _I, _P],
    # C, B, rg, out[5] or out[2]: groups, window rows (csrc/scatter.cu: X)
    "scatter_lanesum_info": [_I, _I, _I, _P],
    "scatter_lanesum_plan": [_I, _I, _I, _P],
    "expand_streams_info": [_I, _P],
    "expand_rel_info": [_I, _P],
}

launch_counts: Dict[str, int] = {name: 0 for name in _SIGNATURES}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from source at first "
            "use and need the CUDA toolkit (set CUDA_HOME)"
        )
    return path


def _build_dir(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join([nvcc] + NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists;
    returns its path.  One nvcc per source, all started together, then one
    link.  nvcc's output is kept beside the library (`build_log`).  Raises
    with it if compilation fails."""
    nvcc = _nvcc()
    out_dir = _build_dir(nvcc)
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        cu = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in cu]
        procs = [
            subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(cu, objs)
        ]
        outs = [(p.communicate()[0], p.returncode) for p in procs]
        tmp = os.path.join(work, LIB_NAME)
        if all(rc == 0 for _, rc in outs):
            link = subprocess.run(
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", tmp] + objs,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            outs.append((link.stdout, link.returncode))
        text = "".join(out for out, _ in outs)
        bad = [rc for _, rc in outs if rc != 0]
        if bad:
            raise RuntimeError("nvcc failed (exit %d):\n%s" % (bad[0], text))
        with open(os.path.join(out_dir, LOG_NAME), "w") as fh:
            fh.write(text)
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """nvcc's output (ptxas -v: registers, spills and shared memory per
    kernel) from the build of the library that `load` uses, cached or not;
    "" if there is none."""
    path = os.path.join(_build_dir(_nvcc()), LOG_NAME)
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name + "_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.marginalign_cuda_error_string.argtypes = [ctypes.c_int]
        lib.marginalign_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_tensor(t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel's entry point assumes of its pointers."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError("expected %s%s, got %s%s"
                         % (dtype, tuple(shape), t.dtype, tuple(t.shape)))
    if t.device != device or not t.is_contiguous():
        raise ValueError("expected a contiguous tensor on %s" % device)


def query(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` of `_QUERIES` with `device` current; raise
    if it reports a CUDA error."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.marginalign_cuda_error_string(err).decode()
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (name, err, msg))


def resources(name: str, device: torch.device, *args) -> Dict[str, int]:
    """What a kernel's launches get on `device`, from the `_QUERIES` entry
    point `name` (csrc/common.cuh `kernel_info`): registers per thread,
    shared memory per block (bytes), blocks resident per SM, threads per
    block and local memory per thread (bytes; spills)."""
    out = (ctypes.c_int * 5)()
    query(name, device, *args, ctypes.addressof(out))
    return dict(zip(("registers", "smem_per_block", "blocks_per_sm",
                     "threads_per_block", "local_bytes"), out))


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device` (made current for the call) and its
    current stream, which is appended to `args`; raise if the entry point
    reports a CUDA error."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name + "_launch")(*args, stream)
    if err != 0:
        msg = lib.marginalign_cuda_error_string(err).decode()
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (name, err, msg))
    launch_counts[name] += 1
