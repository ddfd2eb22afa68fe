#!/usr/bin/env python3
"""Where the port's wall time goes on one CUDA card.  Run from the
repository root:

    python3 profile_port.py

It writes chip_smoke.py's corpus (1024 reads x 3.5 kb, two references,
both strands) and profiles marginAlign on it (pipeline.align, the default
path), then plants chip_smoke's SNVs in a copy of the reference and
profiles marginCaller on the aligned SAM, then marginAlign --em on the
corpus's first 256 reads (chip_smoke's EM phase: default EmOptions but 5
iterations).  Each command runs three times:
unprofiled, under cProfile (host functions of the port by cumulative
seconds, and the host band packers' share of the wall) and under
torch.profiler (the card's busy time: kernels, copies, memsets).  The last
line is a JSON summary.  Nothing is checked here; chip_smoke.py holds the
commands to their references.
"""
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

import chip_smoke
from chip_smoke import log

# Host functions that build band-shaped arrays or their offsets.
PACKERS = ("pack_banded_batch", "pack_compact_batch", "band_offsets")


def profile(label, run):
    """Profile `run` (a callable that ends on the card): returns the wall
    seconds of each run, the packers' cumulative seconds under cProfile
    and the card's busy seconds under torch.profiler."""
    import torch

    def timed():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = timed()
    prof = cProfile.Profile()
    prof.enable()
    host_wall = timed()
    prof.disable()
    stats = pstats.Stats(prof).stats
    port = [(v[3], os.path.basename(k[0]), k[2]) for k, v in stats.items()
            if "marginalign_trna_tpu_torch" in k[0]]
    for cum, path, fn in sorted(port, reverse=True)[:14]:
        log("%s host: %8.3f s cumulative  %s:%s" % (label, cum, path, fn))
    packers = {fn: cum for cum, _, fn in port if fn in PACKERS}
    for fn, cum in sorted(packers.items()):
        log("%s host: %s %.3f s = %.2f%% of the cProfile run"
            % (label, fn, cum, 100 * cum / host_wall))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tprof:
        wall = timed()
    # Only the card's own events (kernels, copies, memsets) count, as in
    # the total of torch's profiler table.
    on_card = sorted(((e.self_device_time_total, e.key)
                      for e in tprof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    device_s = sum(us for us, _ in on_card) / 1e6
    for us, key in on_card[:10]:
        log("%s device: %9.3f ms  %s" % (label, us / 1e3, key[:70]))
    log("%s: unprofiled %.3f s; cProfile run %.3f s; torch.profiler run "
        "%.3f s, card busy %.4f s (%.2f%%)"
        % (label, warm, host_wall, wall, device_s, 100 * device_s / wall))
    return {"unprofiled_wall_s": warm, "cprofile_wall_s": host_wall,
            "cprofile_packers_s": packers, "profiled_wall_s": wall,
            "device_busy_s": device_s, "device_busy_share": device_s / wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.models.hmm import PairHmm

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        fq, fa, _ = chip_smoke.write_corpus(tmpdir, chip_smoke.N_READS,
                                            chip_smoke.READ_LEN)
        sam = os.path.join(tmpdir, "out.sam")
        res["marginAlign"] = profile(
            "align", lambda: pipeline.align(fq, fa, sam, device="cuda"))
        mut_fa, _ = chip_smoke.write_mutated_reference(tmpdir, fa)
        hmm = PairHmm.load(pipeline.DEFAULT_MODEL)
        vcf = os.path.join(tmpdir, "profiled.vcf")
        res["marginCaller"] = profile(
            "caller", lambda: caller.margin_caller(sam, mut_fa, vcf, hmm, hmm,
                                                   device="cuda"))
        sub = os.path.join(tmpdir, "em_subset.fq")
        chip_smoke.subset_fastq(fq, sub, chip_smoke.EM_READS)
        em_sam = os.path.join(tmpdir, "em.sam")
        opts = pipeline.AlignOptions(em=True, em_options=em.EmOptions(
            iterations=chip_smoke.EM_ITERATIONS))
        res["marginAlign --em"] = profile(
            "em", lambda: pipeline.align(sub, fa, em_sam, opts, device="cuda"))
    log(chip_smoke.card_identity())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
