#!/usr/bin/env python3
"""Where marginCaller's wall time goes on one CUDA card.  Run from the
repository root:

    python3 profile_caller.py

It writes chip_smoke.py's corpus (1024 reads x 3.5 kb, two references,
both strands), aligns it with marginAlign on the card, plants chip_smoke's
SNVs in a copy of the reference, and runs the caller on that SAM twice:
once under cProfile (host functions of the port by cumulative seconds)
and once under torch.profiler (the card's busy time: kernels, copies,
memsets).  The last line is a JSON summary.  Nothing is checked here;
chip_smoke.py holds the caller to its references.
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


def profile_caller(tmpdir, fa, sam):
    import torch

    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    hmm = PairHmm.load(DEFAULT_MODEL)
    vcf = os.path.join(tmpdir, "profiled.vcf")

    def run():
        t0 = time.perf_counter()
        caller.margin_caller(sam, fa, vcf, hmm, hmm, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = run()
    prof = cProfile.Profile()
    prof.enable()
    host_wall = run()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(((v[3], "%s:%s" % (os.path.basename(k[0]), k[2]))
                  for k, v in stats.items()
                  if "marginalign_trna_tpu_torch" in k[0]), reverse=True)
    for cum, name in top[:12]:
        log("host: %8.3f s cumulative  %s" % (cum, name))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tprof:
        wall = run()
    # Only the card's own events (kernels, copies, memsets) count, as in
    # the total of torch's profiler table.
    on_card = sorted(((e.self_device_time_total, e.key)
                      for e in tprof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    device_s = sum(us for us, _ in on_card) / 1e6
    for us, key in on_card[:8]:
        log("device: %9.3f ms  %s" % (us / 1e3, key[:70]))
    log("caller: unprofiled %.3f s; cProfile run %.3f s; torch.profiler run "
        "%.3f s, card busy %.4f s (%.2f%%)" % (warm, host_wall, wall,
                                              device_s, 100 * device_s / wall))
    return {"unprofiled_wall_s": warm, "cprofile_wall_s": host_wall,
            "profiled_wall_s": wall, "device_busy_s": device_s,
            "device_busy_share": device_s / wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_caller: needs a CUDA card", file=sys.stderr)
        return 2
    from marginalign_trna_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmpdir:
        fq, fa, _ = chip_smoke.write_corpus(tmpdir, chip_smoke.N_READS,
                                            chip_smoke.READ_LEN)
        sam = os.path.join(tmpdir, "out.sam")
        pipeline.align(fq, fa, sam, device="cuda")
        mut_fa, _ = chip_smoke.write_mutated_reference(tmpdir, fa)
        res = profile_caller(tmpdir, mut_fa, sam)
    log(chip_smoke.card_identity())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
