#!/usr/bin/env python3
"""Float32 error of the port's two pair-HMM posterior formulations on
chip_smoke.py's corpus, measured with their plain versions on the CPU.
Run from the repository root:

    python3 precision_port.py [n_reads]

It maps and chains the corpus's first n_reads reads (default 6) on the
CPU, cuts their records into realign segments as marginAlign does (split
size 3000) and computes every segment's posterior band twice per
formulation, in float32 (as the kernels do) and in float64:

  REL       the band-relative forward-backward (fb_backward / fb_forward,
            ops/fb_cuda.py; realign_sam_file(..., fused=False));
  circular  the expand -> sv_backward -> mw_forward chain
            (ops/fb_circ_cuda.py; marginAlign's default path).

The float64 runs swap the plain versions' float32 buffers for float64
ones; the model constants stay the float32 values the kernels take.  The
last line is a JSON summary of the largest differences over valid cells.
Nothing is checked here.
"""
import contextlib
import json
import os
import sys
import tempfile
import types

import chip_smoke


@contextlib.contextmanager
def float64_plain(*modules):
    """Inside the block the plain versions of `modules` compute in float64:
    their module-level `torch` becomes a view of torch whose float32 is
    float64."""
    import torch

    view = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                    if not k.startswith("__")})
    view.float32 = torch.float64
    for mod in modules:
        mod.torch = view
    try:
        yield
    finally:
        for mod in modules:
            mod.torch = torch


def posteriors(segs, f64):
    """(REL posterior, circular posterior, REL logZ, circular logZ, valid)
    of the segments, float64 tensors; computed in float64 when f64."""
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import band, fb, fb_circ, fb_cuda
    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    tables = fb.tables_from_hmm(PairHmm.load(pipeline.DEFAULT_MODEL), "cpu")
    args = ([s.read_region for s in segs], [s.ref_region for s in segs])
    paths = [s.path for s in segs]
    full = band.pack_banded_batch(*args, 21, paths=paths, quantize=True)
    comp = band.pack_compact_batch(*args, 21, paths=paths, quantize=True)
    dev = fb.device_batch(full, "cpu")
    cdev = fb_circ.compact_device_batch(comp, "cpu")
    as_run = (lambda t: t.double()) if f64 else (lambda t: t)
    with (float64_plain(fb_cuda, fc) if f64 else contextlib.nullcontext()):
        coef, em = fb_cuda.fb_inputs(tables, dev)
        bm, bls, logz_rel = fb_cuda.fb_backward_plain(
            coef, as_run(em), dev.valid, dev.s1, dev.final_d, dev.final_k)
        rel = fb_cuda.fb_forward_plain(coef, as_run(em), dev.valid, dev.s1,
                                       bm, bls, logz_rel)
        ccoef, chain = fb_circ.circ_coefficients(tables)
        es, _, _ = fc.expand_streams_plain(
            tables.Ematch.numpy().reshape(-1), cdev.reads, cdev.refs,
            cdev.lo, cdev.m, cdev.n, 21, comp.wp, comp.num_steps, False)
        fr, frr, lom = band.circ_mw_streams(cdev.lo, 21, comp.wp,
                                            comp.num_steps)
        bm, bls, logz_circ = fc.sv_backward_plain(ccoef, chain, as_run(es),
                                                  cdev.fink, cdev.final_d)
        circ = fc.mw_forward_plain(ccoef, chain, as_run(es), fr, frr, lom,
                                   bm, bls, logz_circ)[0]
    return (rel.double(), circ.double(), logz_rel.double(),
            logz_circ.double(), dev.valid)


def main() -> int:
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.utils.seq import encode

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    with tempfile.TemporaryDirectory() as tmpdir:
        fq, fa, _ = chip_smoke.write_corpus(tmpdir, chip_smoke.N_READS,
                                            chip_smoke.READ_LEN)
        sub = os.path.join(tmpdir, "subset.fq")
        chip_smoke.subset_fastq(fq, sub, n_reads)
        chained = os.path.join(tmpdir, "chained.sam")
        pipeline.align(sub, fa, chained,
                       pipeline.AlignOptions(no_realign=True), device="cpu")
        jobs = realign._jobs_from_sam(SamFile.read(chained),
                                      get_fasta_dictionary(fa), encode)
    segs, _, _ = realign.split_jobs_at_anchors(jobs,
                                               realign.DEFAULT_SPLIT_SIZE)
    rel32, circ32, lr32, lc32, valid = posteriors(segs, False)
    rel64, circ64, lr64, lc64, _ = posteriors(segs, True)

    def worst(a, b):
        return float((a - b).abs()[valid].max())

    res = {
        "segments": len(segs), "steps": int(rel32.shape[0]),
        "max_abs_logz": float(lr64.abs().max()),
        "logz_rel32_vs_rel64": float((lr32 - lr64).abs().max()),
        "logz_circ32_vs_circ64": float((lc32 - lc64).abs().max()),
        "logz_rel64_vs_circ64": float((lr64 - lc64).abs().max()),
        "post_rel32_vs_rel64": worst(rel32, rel64),
        "post_circ32_vs_circ64": worst(circ32, circ64),
        "post_rel64_vs_circ64": worst(rel64, circ64),
        "post_rel32_vs_circ32": worst(rel32, circ32),
    }
    for k, v in res.items():
        chip_smoke.log("%-24s %s" % (k, v))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
