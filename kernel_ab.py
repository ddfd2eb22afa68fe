"""A/B timing of the port's redesigned kernels against another checkout of
the port, on the same inputs, in one process on one CUDA card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 kernel_ab.py build/parent

The other checkout's package is imported under another name and builds its
own kernels beside its sources.  Every kernel runs on one set of inputs made
from a seed, at the shape of its largest launch in chip_smoke.py:
scatter_lanes (L) on a realign row-flush stream [3096, 4096]; the
checkpoint backwards on the EM batch [3, 512, 24, 8192] and the em_multi
batch [3, 1024, 24, 4096] (and its first trial); and the instances that
must not move: counts_bwd, counts_multi_bwd and fb_generic_bwd.  A time is
the CUDA-event mean over REPS launches after a warm-up, taken in the order
other, this, this, other; the two checkouts' outputs are held against each
other (bit-equal where the function and its order of additions did not
change, lane-summed counts within rtol 1e-5 where they did).  The E-step
rows time one `counts_trials` / `counts_multi_trials` call with the
checkpoint pair (both kernels, the lane sums, a sync) on the host clock.
Prints one JSON line per kernel group as it goes, then the whole report.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "marginalign_trna_tpu_torch"
REPS = 20
EM_REPS = 3
# Input sizes: L's flush stream (d1k, Wp, B), the EM batch's lanes and
# diagonals, the em_multi batch's problems and lanes, the generic batch's
# lanes and diagonals.
FLUSH = (3072, 24, 4096)
EM_LANES, EM_STEPS = 8192, 512
MULTI_PROBLEMS, MULTI_LANES = 14300, 4096
GENERIC_LANES, GENERIC_STEPS = 1024, 3072
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def load_port(root, alias):
    """The port package under `root`, imported as `alias`."""
    path = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def sub(port, name):
    return importlib.import_module(port.__name__ + "." + name)


def time_ms(fn, reps=REPS):
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


def ab(this_fn, other_fn, reps=REPS):
    """Times in the order other, this, this, other: (this, other, spreads)."""
    o1 = time_ms(other_fn, reps)
    t1 = time_ms(this_fn, reps)
    t2 = time_ms(this_fn, reps)
    o2 = time_ms(other_fn, reps)
    return {"ms": (t1 + t2) / 2, "other_ms": (o1 + o2) / 2,
            "speedup": (o1 + o2) / (t1 + t2),
            "ms_runs": [t1, t2], "other_ms_runs": [o1, o2]}


def noisy(rng, ref, sub=0.1, indel=0.03):
    out = []
    for base in ref:
        u = rng.random()
        if u < indel:
            continue
        out.append(base if rng.random() >= sub else int(rng.integers(0, 4)))
        if u > 1 - indel:
            out.append(int(rng.integers(0, 4)))
    return np.asarray(out, np.int8)


def models(P, ntr):
    out = []
    for t in range(ntr):
        hmm = P.PairHmm.random(seed=20 + t)
        hmm.apply_model_type_constraints()
        out.append(hmm)
    return out


def flush_stream(port, dev, seed=1):
    """(vals [d1k + wp, B], jm, rg): a mw pass's row-flush stream and tails
    (ops/expectations.py `fused_row_jmaps`) for bands whose lower edge
    steps on about half the diagonals, random values."""
    import torch

    ex = sub(port, "ops.expectations")
    d1k, wp, B = FLUSH
    rng = np.random.default_rng(seed)
    steps = rng.random((d1k, B)) < 0.5
    steps[0] = False
    lo = torch.from_numpy(np.cumsum(steps, axis=0).astype(np.int32)).to(dev)
    m = (lo[-1] + wp - 3).to(torch.int32)
    jmap, jtail = ex.fused_row_jmaps(lo, m, wp, d1k)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fl = torch.rand((d1k, B), device=dev, generator=gen)
    tail = torch.rand((wp, B), device=dev, generator=gen)
    vals, jm = ex.concat_flush_tails(fl, tail, jmap, jtail)
    rg = -(-int(m.max()) // 256) * 256
    return vals.contiguous(), jm.contiguous(), rg


def em_batch(band, seed=2):
    """EM_LANES noisy pairs of up to 250 bases, width 21 (Wp 24)."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    hi = min(251, EM_STEPS // 2 - 5)
    while len(reads) < EM_LANES:
        ref = rng.integers(0, 4, int(rng.integers(hi - 50, hi))).astype(
            np.int8)
        read = noisy(rng, ref)
        if len(read) + len(ref) + 1 <= EM_STEPS:
            reads.append(read)
            refs.append(ref)
    return band.pack_banded_batch(reads, refs, width=21,
                                  pad_steps_to=EM_STEPS)


def multi_batch(band, seed=3):
    """tRNA-scale problems (references of 70-90 bases, 12% substitutions)
    packed several per 1024-diagonal lane, width 21, to 4096 lanes."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, int(rng.integers(70, 91))).astype(np.int8)
            for _ in range(MULTI_PROBLEMS)]
    reads = [noisy(rng, r, sub=0.12) for r in refs]
    return band.pack_multi_banded_batch(reads, refs, width=21,
                                        pad_steps_to=1024,
                                        pad_batch_to=MULTI_LANES)


def generic_batch(band, seed=4):
    """Kilobase pairs (m + n near GENERIC_STEPS) for the generic pair,
    width 21."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    while len(reads) < GENERIC_LANES:
        ref = rng.integers(0, 4, GENERIC_STEPS // 2 - 56).astype(np.int8)
        read = noisy(rng, ref, indel=0.005)
        if len(read) + len(ref) + 1 <= GENERIC_STEPS:
            reads.append(read)
            refs.append(ref)
    return band.pack_banded_batch(reads, refs, width=21,
                                  pad_steps_to=GENERIC_STEPS)


def counts_rel(got, want):
    return max(((g.sum(-1) - w.sum(-1)).abs()
                / w.sum(-1).abs().clamp(min=1e-6)).max().item()
               for g, w in zip(got, want))


def bound_ms(ops, moved):
    return 1e3 * max(ops / F32_OPS_PER_S, moved / HBM_BYTES_PER_S)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main(argv):
    import torch

    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    this = importlib.import_module(PKG)
    other = load_port(argv[1], "other_port")
    t0 = time.perf_counter()
    for port in (this, other):
        sub(port, "ops._build").load()
    report = {"card": card(), "build_s": time.perf_counter() - t0,
              "other": os.path.abspath(argv[1]), "reps": REPS}
    run(this, other, torch.device("cuda"), report)
    print(json.dumps(report), flush=True)
    return 0


def run(this, other, cuda, report):
    """Fills `report` with the A/B rows of the two port packages on device
    `cuda`."""
    import torch

    tc, oc = (sub(p, "ops.fb_counts_cuda") for p in (this, other))
    tb, ob = (sub(p, "ops.bucket_scatter") for p in (this, other))
    fbc = sub(this, "ops.fb_counts")
    fb = sub(this, "ops.fb")
    band = sub(this, "ops.band")
    P = sub(this, "models.hmm")

    # L on a realign flush stream.
    args = flush_stream(this, cuda)
    vals, jm, rg = args
    got, ref = tb.scatter_lanes_cuda(*args), ob.scatter_lanes_cuda(*args)
    plain = tb.scatter_lanes_plain(*args)
    hit = int(((jm >= 0) & (jm < rg)).sum())
    tgt = torch.where((jm >= 0) & (jm < rg), jm, rg).long()
    lib_out = vals.new_zeros((rg + 1, vals.shape[1]))
    report["scatter_lanes"] = {
        "shape": list(vals.shape), "rg": rg,
        "max_abs_err_plain": (got - plain).abs().max().item(),
        "max_abs_err_other": (got - ref).abs().max().item(),
        "repeat_identical": bool(torch.equal(
            got, tb.scatter_lanes_cuda(*args))),
        **ab(lambda: tb.scatter_lanes_cuda(*args),
             lambda: ob.scatter_lanes_cuda(*args)),
        "library_ms": time_ms(lambda: lib_out.scatter_add_(0, tgt, vals)),
        "bound_ms": bound_ms(4 * hit, jm.numel() * 4 + rg * vals.shape[1]
                             * 4 + hit * 4)}
    del args, vals, jm, got, ref, plain, tgt, lib_out
    print(json.dumps({"scatter_lanes": report["scatter_lanes"]}), flush=True)

    # The single-lane EM batch: the checkpoint backward, the stored one.
    hmms = models(P, 3)
    tables = fb.tables_stacked(hmms, cuda)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    batch = em_batch(band)
    dev = fb.device_batch(batch, cuda)
    xb, yb, valid, s1, fk, fd = fbc.kernel_inputs(dev)
    streams = (xb, yb, valid, s1, fk)
    ck, cs, lsf, term = tc.counts_fwd_ckpt_cuda(*tabs, *streams)
    logZ = fbc.logz_from_terminal(lsf, term, fd)
    cargs = (*tabs, ck, cs, *streams, fd, logZ)
    cells = 3 * xb.numel()
    got = tc.counts_bwd_ckpt_cuda(*cargs)
    report["counts_bwd_ckpt"] = {
        "shape": [3] + list(xb.shape),
        "counts_rel_err_plain": counts_rel(got, tc.counts_bwd_ckpt_plain(
            *cargs)),
        "counts_rel_err_other": counts_rel(got, oc.counts_bwd_ckpt_cuda(
            *cargs)),
        **ab(lambda: tc.counts_bwd_ckpt_cuda(*cargs),
             lambda: oc.counts_bwd_ckpt_cuda(*cargs)),
        "bound_ms": bound_ms(225 * cells, sum(
            t.numel() * t.element_size() for t in (*cargs, *got)
            if torch.is_tensor(t))),
        "resources": tc.ckpt_backward_resources(cuda, xb.shape[1])}
    one = (*(t[:1].contiguous() for t in tabs), ck[:1].contiguous(),
           cs[:1].contiguous(), *streams, fd, logZ[:1].contiguous())
    report["counts_bwd_ckpt"]["one_trial"] = ab(
        lambda: tc.counts_bwd_ckpt_cuda(*one),
        lambda: oc.counts_bwd_ckpt_cuda(*one))
    del ck, cs, cargs, one, got
    print(json.dumps({"counts_bwd_ckpt": report["counts_bwd_ckpt"]}),
          flush=True)
    f_all, lsf, term = tc.counts_fwd_all_cuda(*tabs, *streams)
    bargs = (*tabs, f_all, lsf, *streams, fd, logZ)
    got, ref = tc.counts_bwd_cuda(*bargs), oc.counts_bwd_cuda(*bargs)
    report["counts_bwd"] = {
        "bit_equal_other": all(torch.equal(g, r) for g, r in zip(got, ref)),
        **ab(lambda: tc.counts_bwd_cuda(*bargs),
             lambda: oc.counts_bwd_cuda(*bargs))}
    del f_all, bargs, got, ref
    # The E-step of --em on this batch (checkpoint pair, 3 trials).
    odev = sub(other, "ops.fb").device_batch(batch, cuda)
    otables = sub(other, "ops.fb").tables_stacked(hmms, cuda)
    ofbc = sub(other, "ops.fb_counts")
    report["estep_em"] = estep(
        lambda: fbc.counts_trials(tables, dev, kernel="ckpt"),
        lambda: ofbc.counts_trials(otables, odev, kernel="ckpt"))
    del dev, odev, batch
    torch.cuda.empty_cache()

    # The multi-lane EM batch.
    mb = multi_batch(band)
    mdev = fb.multi_device_batch(mb, cuda)
    *mstreams, mfk, mfd = fbc.multi_kernel_inputs(mdev)
    mstreams = (*mstreams, mfk)
    ck, cs, lsf, term = tc.counts_multi_fwd_ckpt_cuda(*tabs, *mstreams)
    L, _ = fb.multi_logz(lsf, term, mdev)
    cargs = (*tabs, ck, cs, *mstreams, mfd, L)
    got = tc.counts_multi_bwd_ckpt_cuda(*cargs)
    report["counts_multi_bwd_ckpt"] = {
        "shape": [3] + list(mstreams[0].shape),
        "counts_rel_err_plain": counts_rel(
            got, tc.counts_multi_bwd_ckpt_plain(*cargs)),
        "counts_rel_err_other": counts_rel(
            got, oc.counts_multi_bwd_ckpt_cuda(*cargs)),
        **ab(lambda: tc.counts_multi_bwd_ckpt_cuda(*cargs),
             lambda: oc.counts_multi_bwd_ckpt_cuda(*cargs)),
        "bound_ms": bound_ms(231 * 3 * mstreams[0].numel(), sum(
            t.numel() * t.element_size() for t in (*cargs, *got)
            if torch.is_tensor(t))),
        "resources": tc.ckpt_backward_resources(
            cuda, mstreams[0].shape[1], multi=True)}
    one = (*(t[:1].contiguous() for t in tabs), ck[:1].contiguous(),
           cs[:1].contiguous(), *mstreams, mfd, L[:1].contiguous())
    report["counts_multi_bwd_ckpt"]["one_trial"] = ab(
        lambda: tc.counts_multi_bwd_ckpt_cuda(*one),
        lambda: oc.counts_multi_bwd_ckpt_cuda(*one))
    del ck, cs, cargs, one, got
    print(json.dumps({"counts_multi_bwd_ckpt":
                      report["counts_multi_bwd_ckpt"]}), flush=True)
    f_all, lsf, term = tc.counts_multi_fwd_all_cuda(*tabs, *mstreams)
    bargs = (*tabs, f_all, lsf, *mstreams, mfd, L)
    got = tc.counts_multi_bwd_cuda(*bargs)
    ref = oc.counts_multi_bwd_cuda(*bargs)
    report["counts_multi_bwd"] = {
        "bit_equal_other": all(torch.equal(g, r) for g, r in zip(got, ref)),
        **ab(lambda: tc.counts_multi_bwd_cuda(*bargs),
             lambda: oc.counts_multi_bwd_cuda(*bargs))}
    del f_all, bargs, got, ref
    omdev = sub(other, "ops.fb").multi_device_batch(mb, cuda)
    report["estep_em_multi"] = estep(
        lambda: fbc.counts_multi_trials(tables, mdev, kernel="ckpt"),
        lambda: ofbc.counts_multi_trials(otables, omdev, kernel="ckpt"))
    del mdev, omdev, mb
    torch.cuda.empty_cache()

    # The generic backward (non-flat model, one trial).
    tg, og = (sub(p, "ops.fb_generic_cuda") for p in (this, other))
    hmm = P.PairHmm.load(os.path.join(ROOT, PKG, "models", "last_hmm_20.txt"))
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    gt = fb.tables_from_hmm(hmm, cuda)
    gtabs = (gt.T, gt.Ematch, gt.Egap)
    gdev = fb.device_batch(generic_batch(band), cuda)
    xb, yb, valid, s1, fk, fd = fbc.kernel_inputs(gdev)
    gstreams = (xb, yb, valid, s1, fk)
    fm, lsf, term = tg.fb_generic_fwd_cuda(*gtabs, *gstreams)
    lz = fbc.logz_from_terminal(lsf[None], term[None], fd)[0]
    gargs = (*gtabs, fm, lsf, *gstreams, fd, lz)
    report["fb_generic_bwd"] = {
        "shape": list(xb.shape),
        "bit_equal_other": bool(torch.equal(tg.fb_generic_bwd_cuda(*gargs),
                                            og.fb_generic_bwd_cuda(*gargs))),
        **ab(lambda: tg.fb_generic_bwd_cuda(*gargs),
             lambda: og.fb_generic_bwd_cuda(*gargs))}


def estep(this_fn, other_fn):
    """Host seconds of one E-step call of each checkout (other, this, this,
    other; EM_REPS calls each after a warm-up), and what 5 and 100 EM
    iterations of it come to."""
    import torch

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EM_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / EM_REPS

    o1, t1, t2, o2 = wall(other_fn), wall(this_fn), wall(this_fn), \
        wall(other_fn)
    s, o = (t1 + t2) / 2, (o1 + o2) / 2
    return {"s": s, "other_s": o, "iterations_5_s": 5 * s,
            "other_iterations_5_s": 5 * o, "iterations_100_s": 100 * s,
            "other_iterations_100_s": 100 * o}


if __name__ == "__main__":
    sys.exit(main(sys.argv))
