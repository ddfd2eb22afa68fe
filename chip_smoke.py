#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (marginalign_trna_tpu_torch) on one
CUDA card.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):
  1. build    nvcc compiles the port's kernels (csrc/*.cu) for sm_90a.
  2. tiny     each kernel against its plain PyTorch version on the card at a
              tiny shape, so a broken kernel fails before the long run.
  3. main     marginAlign (guide -> chain -> realign -> SAM) through
              pipeline.align on a synthetic 1024-read x 3.5 kb corpus with
              two references and both strands; every kernel must launch,
              and the reads must land where they were simulated from.  The
              shape of every launch is logged and the inputs of each
              kernel's largest launch are kept (one device copy each).
  4. kernels  each kernel against its plain version on the inputs of its
              largest main-path launch, with kernel and plain times.
  5. parity   a 32-read subset through the same entry on device="cpu"
              (plain versions) and "cuda" (kernels): guide records
              identical, >= 95% of realigned cigars identical.
  6. card     name and power limit from nvidia-smi.
The line before the last is the kernel report (JSON); the last line is the
result (JSON).  Corpus and weights come from numpy seeds; nothing is read
from outside the repository.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

N_READS = 1024
READ_LEN = 3500
PARITY_READS = 32
NW_PARAMS = (1.0, -2.0, -3.0, -1.0)
# Kernel name -> (source, TPU kernel it replaces, wrapper in ops/).
KERNELS = {
    "banded_nw": ("marginalign_trna_tpu_torch/csrc/nw.cu",
                  "marginalign_trna_tpu/ops/wavefront_pallas.py:77",
                  "wavefront_cuda.banded_nw_cuda"),
    "fb_backward": ("marginalign_trna_tpu_torch/csrc/fb.cu",
                    "marginalign_trna_tpu/ops/fb_pallas.py:823",
                    "fb_cuda.fb_backward_cuda"),
    "fb_forward": ("marginalign_trna_tpu_torch/csrc/fb.cu",
                   "marginalign_trna_tpu/ops/fb_pallas.py:971",
                   "fb_cuda.fb_forward_cuda"),
    "banded_mea": ("marginalign_trna_tpu_torch/csrc/mea.cu",
                   "marginalign_trna_tpu/ops/wavefront_pallas.py:375",
                   "wavefront_cuda.banded_mea_cuda"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ corpora


def noisy(rng, seq):
    """10% substitutions, 5% deletions, 5% insertions (benchmarks/e2e.py)."""
    import numpy as np

    read = seq.copy()
    hit = rng.random(len(read)) < 0.10
    read[hit] = rng.integers(0, 4, size=int(hit.sum()))
    read = read[rng.random(len(read)) >= 0.05]
    where = np.flatnonzero(rng.random(len(read)) < 0.05)
    return np.insert(read, where + 1,
                     rng.integers(0, 4, size=len(where)).astype(read.dtype))


def write_corpus(tmpdir, n_reads, read_len, seed=7):
    """Two references of read_len + 64 bases; reads start in the first 48
    bases of their reference, every third one reverse-complemented.
    Returns (fastq, fasta, truth {name: (ref, reverse, start)})."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    refs = [rng.integers(0, 4, size=read_len + 64) for _ in range(2)]
    fa = os.path.join(tmpdir, "ref.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(refs):
            fh.write(">ref%d\n%s\n" % (i, "".join(bases[r])))
    fq = os.path.join(tmpdir, "reads.fq")
    truth = {}
    with open(fq, "w") as fh:
        for idx in range(n_reads):
            ri = int(rng.integers(0, 2))
            start = int(rng.integers(0, 48))
            read = noisy(rng, refs[ri][start:start + read_len])
            reverse = idx % 3 == 1
            if reverse:
                read = (3 - read)[::-1]
            seq = "".join(bases[read])
            fh.write("@r%d\n%s\n+\n%s\n" % (idx, seq, "I" * len(seq)))
            truth["r%d" % idx] = ("ref%d" % ri, reverse, start)
    return fq, fa, truth


def subset_fastq(fq, out, n):
    with open(fq) as src, open(out, "w") as dst:
        for _ in range(4 * n):
            dst.write(src.readline())


class SamLine(NamedTuple):
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based, as written
    cigar: tuple      # ((op letter, length), ...)
    seq: str
    line: str


def sam_records(path):
    """The alignment lines of a SAM file (header lines skipped)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("@") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            cigar = tuple((op, int(n))
                          for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]))
            out.append(SamLine(f[0], int(f[1]), f[2], int(f[3]), cigar, f[9],
                               line.rstrip("\n")))
    return out


# ------------------------------------------------- kernel vs plain version


def compare_nw(args, reps):
    import torch

    from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf

    ptr, score, state = wf.banded_nw_cuda(*args)
    rptr, rscore, rstate = wf.banded_nw_plain(*args)
    torch.cuda.synchronize()
    ok = args[3]
    check(torch.equal(ptr[ok], rptr[ok]), "NW pointers differ on valid cells")
    check(torch.equal(state, rstate), "NW final_state differs")
    err = (score - rscore).abs().max().item()
    check(err == 0.0, "NW score differs by %g" % err)
    return {
        "max_abs_err": err,
        "all_cells_equal": bool(torch.equal(ptr, rptr)),
        "ms": time_ms(lambda: wf.banded_nw_cuda(*args), reps),
        "plain_ms": time_ms(lambda: wf.banded_nw_plain(*args), 1),
    }


def compare_fb(bargs, fargs, reps):
    """bargs: inputs of fb_backward; fargs: inputs of fb_forward, or None
    to take them from the plain backward on bargs."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_cuda

    bm, bls, logZ = fb_cuda.fb_backward_cuda(*bargs)
    rbm, rbls, rlogZ = fb_cuda.fb_backward_plain(*bargs)
    torch.cuda.synchronize()
    check(torch.isfinite(logZ).all().item(), "FB logZ not finite")
    check(torch.allclose(logZ, rlogZ, rtol=1e-4, atol=1e-4),
          "FB logZ differs (rtol/atol 1e-4)")
    lerr = (logZ - rlogZ).abs().max().item()
    if fargs is None:
        fargs = bargs[:4] + (rbm, rbls, rlogZ)
    post = fb_cuda.fb_forward_cuda(*fargs)
    rpost = fb_cuda.fb_forward_plain(*fargs)
    torch.cuda.synchronize()
    perr = (post - rpost).abs().max().item()
    check(perr <= 2e-4, "FB posterior differs by %g (atol 2e-4)" % perr)
    # Both kernels chained against both plain versions chained.
    full = fb_cuda.fb_forward_cuda(*bargs[:4], bm, bls, logZ)
    rfull = fb_cuda.fb_forward_plain(*bargs[:4], rbm, rbls, rlogZ)
    ferr = (full - rfull).abs().max().item()
    check(ferr <= 2e-4, "FB chained posterior differs by %g" % ferr)
    return (
        {"max_abs_err": lerr,
         "ms": time_ms(lambda: fb_cuda.fb_backward_cuda(*bargs), reps),
         "plain_ms": time_ms(lambda: fb_cuda.fb_backward_plain(*bargs), 1)},
        {"max_abs_err": perr, "chained_max_abs_err": ferr,
         "ms": time_ms(lambda: fb_cuda.fb_forward_cuda(*fargs), reps),
         "plain_ms": time_ms(lambda: fb_cuda.fb_forward_plain(*fargs), 1)},
    )


def compare_mea(args, reps):
    import torch

    from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf

    ptr, score = wf.banded_mea_cuda(*args)
    rptr, rscore = wf.banded_mea_plain(*args)
    torch.cuda.synchronize()
    ok = args[3]
    check(torch.equal(ptr[ok], rptr[ok]), "MEA pointers differ on valid cells")
    err = (score - rscore).abs().max().item()
    check(err <= 1e-4, "MEA score differs by %g (atol 1e-4)" % err)
    return {
        "max_abs_err": err,
        "all_cells_equal": bool(torch.equal(ptr, rptr)),
        "ms": time_ms(lambda: wf.banded_mea_cuda(*args), reps),
        "plain_ms": time_ms(lambda: wf.banded_mea_plain(*args), 1),
    }


def compare_kernels(tag, inputs, reps):
    """Every kernel against its plain version on `inputs` (kernel name ->
    wrapper arguments; fb_forward may be None)."""
    nw = compare_nw(inputs["banded_nw"], reps)
    fbb, fbf = compare_fb(inputs["fb_backward"], inputs["fb_forward"], reps)
    mea = compare_mea(inputs["banded_mea"], reps)
    report = {"banded_nw": nw, "fb_backward": fbb, "fb_forward": fbf,
              "banded_mea": mea}
    for name, res in report.items():
        log("kernels[%s] %-11s %s" % (tag, name, json.dumps(res)))
    return report


def tiny_inputs(device):
    """Kernel inputs at a tiny shape: 5 noisy pairs of 60 bases at width 40
    for NW; 5 pairs of 40 bases at width 21 for FB and MEA, with the MEA
    weights from the plain posterior."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import fb_cuda
    from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_file
    from marginalign_trna_tpu_torch.ops.mea import NEG, mea_weights
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(11)

    def pairs(n, length):
        refs = [rng.integers(0, 4, size=length).astype(np.int8)
                for _ in range(n)]
        return [noisy(rng, r) for r in refs], refs

    dev = device_batch(pack_banded_batch(*pairs(5, 60), width=40,
                                         quantize=True), device)
    nw = (NW_PARAMS, dev.xb, dev.yb, dev.valid, dev.s1, dev.s2, dev.final_d,
          dev.final_k)
    batch = pack_banded_batch(*pairs(5, 40), width=21, quantize=True)
    dev = device_batch(batch, device)
    tables = tables_from_file(DEFAULT_MODEL, device)
    coef, em = fb_cuda.fb_inputs(tables, dev)
    _, post = fb_cuda.posteriors_pre_plain(tables, dev)
    lo = torch.from_numpy(batch.lo).to(device)
    wup, wleft = mea_weights(post, dev.valid, lo, 0.5, int(batch.m.max()),
                             int(batch.n.max()))
    return {
        "banded_nw": nw,
        "fb_backward": (coef, em, dev.valid, dev.s1, dev.final_d,
                        dev.final_k),
        "fb_forward": None,
        "banded_mea": (torch.where(post > 0, post, NEG), wup, wleft,
                       dev.valid, dev.s1, dev.s2, dev.final_d, dev.final_k),
    }


@contextlib.contextmanager
def recording_launches():
    """Inside the block every port module's reference to a kernel wrapper
    goes through a recorder: it logs the [D1, Wp, B] of each call and keeps
    a device copy of the inputs of the largest call per kernel.  Yields
    (shapes {name: [[D1, Wp, B], ...]}, largest {name: inputs})."""
    import importlib

    import torch

    from marginalign_trna_tpu_torch import pipeline  # noqa: F401 (the path)

    originals = {}
    for name, (_, _, wrapper) in KERNELS.items():
        module, fn = wrapper.split(".")
        originals[name] = getattr(importlib.import_module(
            "marginalign_trna_tpu_torch.ops." + module), fn)
    shapes = {name: [] for name in KERNELS}
    largest, sizes = {}, {}

    def recorder(name, fn):
        def call(*args):
            band = next(a for a in args if torch.is_tensor(a) and a.dim() == 3)
            shapes[name].append(list(band.shape))
            if band.numel() > sizes.get(name, -1):
                sizes[name] = band.numel()
                largest[name] = tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)
            return fn(*args)
        return call

    patched = []
    for modname, mod in list(sys.modules.items()):
        if modname.split(".")[0] != "marginalign_trna_tpu_torch":
            continue
        for attr, val in list(vars(mod).items()):
            for name, fn in originals.items():
                if val is fn:
                    patched.append((mod, attr, val))
                    setattr(mod, attr, recorder(name, fn))
    try:
        yield shapes, largest
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


# ------------------------------------------------------------------ phases


def phase_main(tmpdir):
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.ops import _build

    fq, fa, truth = write_corpus(tmpdir, N_READS, READ_LEN)
    out = os.path.join(tmpdir, "out.sam")
    with recording_launches() as (shapes, largest):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stages = pipeline.align(fq, fa, out, device="cuda")
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    recs = sam_records(out)
    log("main: %d reads in, %d records out, %.3f s, %.2f reads/s"
        % (N_READS, len(recs), total, len(recs) / total))
    log("main: stages %s" % json.dumps(stages))
    log("main: launches %s" % json.dumps(launches))
    log("main: launch shapes [D1, Wp, B] %s" % json.dumps(shapes))
    for name in KERNELS:
        check(launches[name] > 0, "kernel %s never launched on the main "
              "path" % name)
        check(len(shapes[name]) == launches[name], "kernel %s: %d wrapper "
              "calls, %d launches" % (name, len(shapes[name]),
                                      launches[name]))
    check(len(recs) >= 0.95 * N_READS, "only %d of %d reads aligned"
          % (len(recs), N_READS))
    placed = 0
    for r in recs:
        ref, reverse, start = truth[r.qname]
        check(len(r.seq) == sum(ln for op, ln in r.cigar if op in "MIS=X"),
              "cigar of %s does not span its read" % r.qname)
        placed += (r.rname == ref and bool(r.flag & 16) == reverse
                   and abs(r.pos - 1 - start) <= 64)
    log("main: %d of %d records on their true reference, strand and "
        "position" % (placed, len(recs)))
    check(placed >= 0.95 * len(recs), "too few reads placed correctly")
    return fq, fa, launches, largest, {
        "reads_out": len(recs), "total_s": total,
        "reads_per_s": len(recs) / total, **stages}


def phase_main_kernels(largest):
    """Kernel vs plain on the inputs of each kernel's largest main-path
    launch."""
    shapes = {name: list(next(a for a in largest[name]
                              if hasattr(a, "dim") and a.dim() == 3).shape)
              for name in KERNELS}
    log("kernels[main] inputs of the largest main-path launch %s"
        % json.dumps(shapes))
    return compare_kernels("main", largest, 5)


def phase_parity(tmpdir, fq, fa):
    from marginalign_trna_tpu_torch import pipeline

    sub = os.path.join(tmpdir, "subset.fq")
    subset_fastq(fq, sub, PARITY_READS)
    out = {}
    for dev in ("cpu", "cuda"):
        guide = os.path.join(tmpdir, "guide_%s.sam" % dev)
        full = os.path.join(tmpdir, "full_%s.sam" % dev)
        t0 = time.perf_counter()
        pipeline.align(sub, fa, guide,
                       pipeline.AlignOptions(no_realign=True, no_chain=True),
                       device=dev)
        pipeline.align(sub, fa, full, device=dev)
        out[dev] = (sam_records(guide), sam_records(full))
        log("parity: device %s %.3f s" % (dev, time.perf_counter() - t0))
    (gc, fc), (gg, fg) = out["cpu"], out["cuda"]
    check([r.line for r in gc] == [r.line for r in gg],
          "guide records differ between cpu and cuda")
    check([(r.qname, r.flag, r.rname, r.pos) for r in fc]
          == [(r.qname, r.flag, r.rname, r.pos) for r in fg],
          "realigned records differ in placement between cpu and cuda")
    same = sum(a.cigar == b.cigar for a, b in zip(fc, fg))
    log("parity: guide records identical (%d); realigned cigars identical "
        "%d of %d" % (len(gc), same, len(fc)))
    check(same >= 0.95 * len(fc), "fewer than 95% of cigars identical")
    return {"guide_records": len(gc), "cigars_identical": same,
            "cigars": len(fc)}


def card_identity():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, "nvidia-smi failed: %s" % proc.stderr)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from marginalign_trna_tpu_torch.ops import _build
    except ImportError as exc:
        print("chip_smoke: the port is not importable from %s (%s); run "
              "from the repository root" % (ROOT, exc), file=sys.stderr)
        return 2

    try:
        t0 = time.perf_counter()
        _build.load()
        log("build: %.2f s" % (time.perf_counter() - t0))
        for line in _build.build_log().splitlines():
            if "Used" in line or "Function properties" in line:
                log("build: " + line.strip())

        compare_kernels("tiny", tiny_inputs(torch.device("cuda")), 3)
        with tempfile.TemporaryDirectory() as tmpdir:
            fq, fa, launches, largest, main_res = phase_main(tmpdir)
            kernels = phase_main_kernels(largest)
            del largest
            parity = phase_parity(tmpdir, fq, fa)
        card = card_identity()
    except SmokeFailure as exc:
        print("chip_smoke: FAIL: %s" % exc, file=sys.stderr)
        return 1

    log("main-path: %s" % json.dumps(main_res))
    log("parity: %s" % json.dumps(parity))
    log(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep, _) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
