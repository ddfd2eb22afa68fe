#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (marginalign_trna_tpu_torch) on one
CUDA card.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):
  1. build    nvcc compiles the port's kernels (csrc/*.cu) for sm_90a;
              ptxas must report no spill in a counts or generic kernel,
              none in K1, K2, K3, K4, nw_multi, mea_multi, the multi-lane
              FB pair or the warp-per-lane serving kernels, and no stack
              frame in these up to two rows a thread (nw_multi up to Wp
              48) nor in X.
  2. tiny     each of the thirty-six kernels against its plain PyTorch
              version on the card at a tiny shape, so a broken kernel fails
              before the long runs; the two traceback kernels byte-equal
              on 37 lanes (m = 0, n = 0 and length-1 lanes, padding lanes,
              D1 - 1 not a multiple of 4, NW walks started in M, Ix and
              Iy); the eight serving kernels
              bit-equal, with a gap-chain model and again with a flat-gap
              model whose gap states 1 and 2 exchange mass (their generic
              5x5 branch), and at WIDE_BANDS (Wp 64 and 128, where the
              checkpoint posterior pass takes blocks of 4 lanes, at Wp 128
              with its tiles in device memory); the four
              multi-lane kernels bit-equal on packed lanes, the FB pair on
              both model branches and at WIDE_BANDS (two and four rows a
              thread), nw_multi at Wp 24 and 48; the four
              multi-lane counts kernels at Wp 24 on lanes of three or more
              problems, with three trials and with one.
  3. main     marginAlign (guide -> chain -> realign -> SAM) through
              pipeline.align on a synthetic 1024-read x 3.5 kb corpus with
              two references and both strands, on its default path: the
              guide through R, K1 and nw_moves, realignment through E, S,
              M, L, D and mea_moves.  Every one of those kernels must
              launch, no other kernel, no host band packer
              (pack_banded_batch) and no native host traceback may run, no
              pointer band may be copied to the host, and the reads must
              land where they were simulated from.  The shape of every
              launch is logged and the inputs of each kernel's largest
              launch are kept (one device copy each).
  4. kernels  each of those kernels against its plain version on the inputs
              of its largest main-path launch, with times and bounds (R,
              E, S, M, K1 and D bit-equal, with their resources:
              registers, shared memory a block, blocks an SM, spills, lanes
              a block of the warp-per-lane kernels S, M, K1 and D; the
              traceback kernels byte-equal, every lane's ops equal to the
              native traceback's, beside the time of what they replace:
              the pageable copy of the pointer band to the host and the
              native traceback of its lanes).
  5. rel      the REL realign path (fused=False: host band arrays, K2, K3,
              K4, mea_moves) on the chained records of the corpus's first
              256 reads; only K2, K3, K4 and mea_moves may launch, no
              native traceback run and no pointer band leave the card;
              >= 90% of its cigars must equal
              the main phase's and every other one must be an MEA near-tie
              of it (objective within 1e-5 under the fused weights).  Then
              K2, K3 and K4 against their plain versions on their largest
              REL launch (K4 with its resources).
  6. serve    the unfused circular serving route in each of its five
              modes (sv, em, lean, emw, ckpt), after the REL phase:
              realign.realign_sam_file(..., serve=mode) on the REL phase's
              chained records (only the mode's serving kernels, K4 and
              mea_moves launch, no native traceback; every record placed
              as in the REL phase; >= 90% of
              cigars equal to the REL phase's and every other one an MEA
              near-tie of it, within 1e-5 under the fused weights), then
              call.caller.margin_caller(..., serve=mode) on the main SAM's
              records of those reads against the caller phase's mutated
              reference (only the mode's serving kernels launch; the call
              set identical to the fused caller's on the same records,
              expectations within 1e-3).  Then each serving kernel
              bit-equal to its plain version on the inputs of its largest
              launch over the modes' realign runs and again over their
              caller runs, with times and bounds (the six warp-per-lane
              ones with their resources), and CPU/card parity on
              PARITY_READS reads for SERVE_PARITY_MODES (cigars >= 90%
              identical, every other one an MEA near-tie; identical call
              sets, expectations within 1e-3).
  7. parity   a 32-read subset through the same entry on device="cpu"
              (plain versions) and "cuda" (kernels): guide records
              identical, >= 95% of realigned cigars identical.
  8. caller   marginCaller (compact streams -> backward -> fused expectation
              forward -> scatter) through call.caller.margin_caller on the
              main phase's SAM against a copy of the reference with an SNV
              planted every 150 bases; only E, S, C and X may launch, and
              recall and precision on the planted SNVs must reach 95%.
              Then those kernels against their plain versions on their
              largest caller launch (S and C bit-equal; S, C and X with
              their resources).
  9. parity   the caller on the SAM's first 32 records on "cpu" and "cuda":
              identical call sets, expectations within 1e-3.
 10. em       marginAlign --em (pipeline.align with em=True: guide -> chain
              -> Baum-Welch EM -> realign with the trained model) on the
              corpus's first 256 reads at the default EmOptions but 5
              iterations: full width (band 21, 3 lockstep trials, anchor
              split 300, 88 M cells per E-step batch), depth cut to 256
              reads and 5 iterations.  Only the counts pair that the policy
              (ops/fb_counts.py use_ckpt) picks for each batch, R, K1, E,
              S, M, L and D may launch; every trial's log-likelihood must
              not fall (within 1e-5 relative), the trained models must be
              stochastic and >= 95% of the reads placed.  Then all four
              counts kernels against their plain versions on the largest
              E-step batch (the other pair forced through the policy's
              keyword), timed again with one trial (a serial EM trial),
              and S and M on their largest launch with the trained
              model, which runs their generic 5x5 branch; the four counts
              kernels with their resources.
 11. parity   EM (3 iterations, trial 0 from the shipped model) + realign
              of the first 32 reads on "cpu" and "cuda": trained
              parameters within 1e-4, likelihood histories within rtol
              1e-5, guide records identical, placements identical; with
              the card's trained model on both devices >= 90% of cigars
              identical; with that model and with each device's own, every
              cigar that differs an MEA near-tie (1e-5).
 12. generic  marginAlign --inputModel <trial 0 of the card's EM parity
              run, un-normalised: gap emissions not flat> on the REL phase's
              reads: the guide through R, K1 and nw_moves, realignment on
              the REL path through the generic pair (fb_generic_fwd,
              fb_generic_bwd), K4 and mea_moves, and only those, with no
              native traceback; every record placed
              as in the main phase.  Then the generic pair against its
              plain versions on its largest launch (bit-equal), and
              marginCaller --alignmentModel <trial 0> on that SAM (only the
              generic pair launches; recall and precision printed), and
              the pair against its plain versions on its largest caller
              launch (bit-equal).
 13. parity   both on PARITY_READS reads on "cpu" and "cuda": >= 90% of
              cigars identical and every other one an MEA near-tie (1e-5);
              identical call sets, expectations within 1e-3.
 14. band     marginAlign --em --updateTheBand on BAND_READS reads
              (BAND_ITERATIONS iterations, 3 lockstep trials): the policy's
              counts pair, the generic pair once per band update, K4 and
              the main path's kernels, no native traceback; reads placed;
              the generic pair
              against its plain versions on its largest launch there
              (bit-equal).  Then EM with band
              updates on BAND_PARITY_READS reads on "cpu" and "cuda":
              trained parameters within 1e-3, differing segment paths
              counted.
 15. multi    multi-problem lanes (multi=True) on a synthetic direct-tRNA
              corpus: TRNA_READS reads of 60-150 nt from TRNA_REFS
              references of 70-90 nt (~12% substitutions, short indels,
              both strands).  marginAlign through pipeline.align(...,
              multi=True): only nw_multi, fb_multi_forward,
              fb_multi_backward and mea_multi may launch; >= 80% of reads
              mapped, >= 95% of records on their simulated reference and
              strand.  The same corpus through the default single-lane
              path: guide records identical, >= MULTI_MIN_EQUAL of
              realigned cigars equal and every other one an MEA near-tie
              (1e-5 relative under the multi run's posteriors); reads/s,
              stage seconds, host packing seconds and the share of padded
              cells that are valid for both.  marginCaller with
              multi=True on the main phase's SAM's first
              CALL_MULTI_RECORDS records against the caller
              phase's mutated reference (split 100: every segment in
              multi lanes): only the FB multi pair launches; the fused
              caller's call set, expectations within 3e-4 of each
              position's coverage.  The four kernels bit-equal to their
              plain versions on their largest launch, with times and
              bounds, and CPU/card parity of both entries on PARITY_READS
              reads / records.
 16. em_multi marginAlign --em with multi=True (pipeline.align: guide,
              chain, Baum-Welch EM whose E-step packs the training pairs
              several per lane, realign, all in multi-problem lanes) on
              the multi phase's tRNA corpus at the default EmOptions but
              EM_ITERATIONS iterations (band 21, 3 lockstep trials, split
              300, 88 M cells per batch): only nw_multi, the multi counts
              pair that use_ckpt picks for each batch, fb_multi_forward,
              fb_multi_backward and mea_multi may launch, never
              pack_banded_batch; likelihoods non-decreasing, trained
              models load, >= 95% of records on their simulated reference
              and strand.  EM on the same chained jobs in single-problem
              lanes: final per-trial log-likelihoods within 1e-5
              relative, parameters within 1e-3; em_s, train_em,
              prepare_em_batches and E-step seconds of both.  The four
              multi counts kernels against their plain versions on the
              largest E-step batch (the other pair forced), with three
              trials and one, with times and bounds; then CPU/card parity
              of pipeline.align(em=True, multi=True) on PARITY_READS tRNA
              reads (3 iterations, trial 0 from the shipped model; the
              card takes the stored pair): parameters within 1e-4,
              histories rtol 1e-5, guide records identical, >=
              MULTI_MIN_EQUAL of cigars identical and the rest MEA
              near-ties.
 17. card     name and power limit from nvidia-smi.
Each phase logs "time: <phase> done at <seconds>" and, on a line of its
own, "phase-seconds: <phase> <seconds>" (the seconds it took); the last
lines repeat them all as one JSON object.  Kernels are timed after a
warm-up call; a plain version's one timed call follows the comparison
that has just run it on the same inputs, so it takes no warm-up of its
own.  The line before the last
is the kernel report (JSON); the last line is the result (JSON).  Corpus and weights come from numpy seeds; nothing is read
from outside the repository.
"""
import contextlib
import functools
import importlib
import json
import os
import re
import shutil
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
# Planted SNVs of the caller phase: every SNV_STEP bases from SNV_FIRST to
# SNV_LAST on each reference.
SNV_FIRST, SNV_LAST, SNV_STEP = 100, 3400, 150
# Kernel name -> (source, TPU kernel it replaces, wrapper in ops/, paths it
# runs on: "align" = marginAlign's main (default, fused) path, "rel" = its
# REL realign path, "call" = marginCaller's, "em" = marginAlign --em, which
# also runs the "align" kernels).
KERNELS = {
    "banded_nw": ("marginalign_trna_tpu_torch/csrc/nw.cu",
                  "marginalign_trna_tpu/ops/wavefront_pallas.py:77",
                  "wavefront_cuda.banded_nw_cuda", ("align",)),
    "expand_rel": ("marginalign_trna_tpu_torch/csrc/expand.cu",
                   "marginalign_trna_tpu/ops/fb_pallas.py:3584",
                   "fb_circ_cuda.expand_rel_cuda", ("align",)),
    "expand_streams": ("marginalign_trna_tpu_torch/csrc/expand.cu",
                       "marginalign_trna_tpu/ops/fb_pallas.py:3375",
                       "fb_circ_cuda.expand_streams_cuda", ("align", "call")),
    "sv_backward": ("marginalign_trna_tpu_torch/csrc/fb_circ.cu",
                    "marginalign_trna_tpu/ops/fb_pallas.py:2269",
                    "fb_circ_cuda.sv_backward_cuda", ("align", "call")),
    "mw_forward": ("marginalign_trna_tpu_torch/csrc/fb_circ.cu",
                   "marginalign_trna_tpu/ops/fb_pallas.py:3047",
                   "fb_circ_cuda.mw_forward_cuda", ("align",)),
    "scatter_lanes": ("marginalign_trna_tpu_torch/csrc/scatter.cu",
                      "marginalign_trna_tpu/ops/bucket_scatter.py:57",
                      "bucket_scatter.scatter_lanes_cuda", ("align",)),
    "mea_dl": ("marginalign_trna_tpu_torch/csrc/mea.cu",
               "marginalign_trna_tpu/ops/wavefront_pallas.py:475",
               "wavefront_cuda.mea_dl_cuda", ("align",)),
    "fb_backward": ("marginalign_trna_tpu_torch/csrc/fb.cu",
                    "marginalign_trna_tpu/ops/fb_pallas.py:823",
                    "fb_cuda.fb_backward_cuda", ("rel",)),
    "fb_forward": ("marginalign_trna_tpu_torch/csrc/fb.cu",
                   "marginalign_trna_tpu/ops/fb_pallas.py:971",
                   "fb_cuda.fb_forward_cuda", ("rel",)),
    "banded_mea": ("marginalign_trna_tpu_torch/csrc/mea.cu",
                   "marginalign_trna_tpu/ops/wavefront_pallas.py:375",
                   "wavefront_cuda.banded_mea_cuda", ("rel",)),
    "cx_forward": ("marginalign_trna_tpu_torch/csrc/fb_circ.cu",
                   "marginalign_trna_tpu/ops/fb_pallas.py:2772",
                   "fb_circ_cuda.cx_forward_cuda", ("call",)),
    "scatter_lanesum": ("marginalign_trna_tpu_torch/csrc/scatter.cu",
                        "marginalign_trna_tpu/ops/bucket_scatter.py:180",
                        "bucket_scatter.scatter_lanesum_cuda", ("call",)),
    # The counts kernels replace each TPU kernel body in its serial and its
    # lockstep-trials pallas_call (a trials grid axis of 1 or Ntr).
    "counts_fwd_all": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                       "marginalign_trna_tpu/ops/fb_pallas_counts.py:42",
                       "fb_counts_cuda.counts_fwd_all_cuda", ("em",)),
    "counts_bwd": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                   "marginalign_trna_tpu/ops/fb_pallas_counts.py:155",
                   "fb_counts_cuda.counts_bwd_cuda", ("em",)),
    "counts_fwd_ckpt": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                        "marginalign_trna_tpu/ops/fb_pallas_counts.py:1245",
                        "fb_counts_cuda.counts_fwd_ckpt_cuda", ("em",)),
    "counts_bwd_ckpt": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                        "marginalign_trna_tpu/ops/fb_pallas_counts.py:1358",
                        "fb_counts_cuda.counts_bwd_ckpt_cuda", ("em",)),
    # The generic pair replaces the body that both variants of each TPU
    # kernel run (tables as arrays or baked in): one warp per lane, the
    # forward the checkpoint forward's kernel in its CF_MATCH mode
    # (counts_fwd_ckpt_kernel), the backward generic_bwd_kernel; its
    # paths: "generic" =
    # marginAlign --inputModel with a non-flat model, "call_generic" =
    # marginCaller --alignmentModel with one, "em_band" = marginAlign --em
    # --updateTheBand.
    "fb_generic_fwd": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                       "marginalign_trna_tpu/ops/fb_pallas.py:330",
                       "fb_generic_cuda.fb_generic_fwd_cuda",
                       ("generic", "call_generic", "em_band")),
    "fb_generic_bwd": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                       "marginalign_trna_tpu/ops/fb_pallas.py:550",
                       "fb_generic_cuda.fb_generic_bwd_cuda",
                       ("generic", "call_generic", "em_band")),
    # The unfused circular serving route (realign and caller with
    # serve=<mode>); S (sv_backward) serves mode "sv" too.
    "circ_backward_emv": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                          "marginalign_trna_tpu/ops/fb_pallas.py:1625",
                          "fb_circ_cuda.circ_backward_emv_cuda", ("serve",)),
    "circ_post_emv": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                      "marginalign_trna_tpu/ops/fb_pallas.py:1749",
                      "fb_circ_cuda.circ_post_emv_cuda", ("serve",)),
    "circ_backward_codes": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                            "marginalign_trna_tpu/ops/fb_pallas.py:1868",
                            "fb_circ_cuda.circ_backward_codes_cuda",
                            ("serve",)),
    "circ_post_codes": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                        "marginalign_trna_tpu/ops/fb_pallas.py:1999",
                        "fb_circ_cuda.circ_post_codes_cuda", ("serve",)),
    "circ_post_es": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                     "marginalign_trna_tpu/ops/fb_pallas.py:2390",
                     "fb_circ_cuda.circ_post_es_cuda", ("serve",)),
    "circ_backward_codes_es": ("marginalign_trna_tpu_torch/csrc/fb_serve.cu",
                               "marginalign_trna_tpu/ops/fb_pallas.py:2503",
                               "fb_circ_cuda.circ_backward_codes_es_cuda",
                               ("serve",)),
    "circ_ckpt_backward": ("marginalign_trna_tpu_torch/csrc/fb_ckpt.cu",
                           "marginalign_trna_tpu/ops/fb_pallas.py:3721",
                           "fb_circ_cuda.circ_ckpt_backward_cuda",
                           ("serve",)),
    "circ_ckpt_post": ("marginalign_trna_tpu_torch/csrc/fb_ckpt.cu",
                       "marginalign_trna_tpu/ops/fb_pallas.py:3856",
                       "fb_circ_cuda.circ_ckpt_post_cuda", ("serve",)),
    # Multi-problem lanes: "multi" = marginAlign with multi=True,
    # "call_multi" = marginCaller with multi=True.
    "nw_multi": ("marginalign_trna_tpu_torch/csrc/nw.cu",
                 "marginalign_trna_tpu/ops/wavefront_pallas.py:225",
                 "wavefront_cuda.nw_multi_cuda", ("multi",)),
    "fb_multi_forward": ("marginalign_trna_tpu_torch/csrc/fb_multi.cu",
                         "marginalign_trna_tpu/ops/fb_pallas.py:1243",
                         "fb_multi_cuda.fb_multi_forward_cuda",
                         ("multi", "call_multi")),
    "fb_multi_backward": ("marginalign_trna_tpu_torch/csrc/fb_multi.cu",
                          "marginalign_trna_tpu/ops/fb_pallas.py:1389",
                          "fb_multi_cuda.fb_multi_backward_cuda",
                          ("multi", "call_multi")),
    "mea_multi": ("marginalign_trna_tpu_torch/csrc/mea.cu",
                  "marginalign_trna_tpu/ops/wavefront_pallas.py:668",
                  "wavefront_cuda.mea_multi_cuda", ("multi",)),
    # The counts pairs over multi-problem lanes: "em_multi" = marginAlign
    # --em with multi=True (each replaces its TPU body's serial and
    # lockstep-trials pallas_call, as the single-lane counts kernels do).
    "counts_multi_fwd_all": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                             "marginalign_trna_tpu/ops/fb_pallas_counts.py:475",
                             "fb_counts_cuda.counts_multi_fwd_all_cuda",
                             ("em_multi",)),
    "counts_multi_bwd": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                         "marginalign_trna_tpu/ops/fb_pallas_counts.py:572",
                         "fb_counts_cuda.counts_multi_bwd_cuda",
                         ("em_multi",)),
    "counts_multi_fwd_ckpt": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                              "marginalign_trna_tpu/ops/fb_pallas_counts.py:1898",
                              "fb_counts_cuda.counts_multi_fwd_ckpt_cuda",
                              ("em_multi",)),
    "counts_multi_bwd_ckpt": ("marginalign_trna_tpu_torch/csrc/fb_counts.cu",
                              "marginalign_trna_tpu/ops/fb_pallas_counts.py:1996",
                              "fb_counts_cuda.counts_multi_bwd_ckpt_cuda",
                              ("em_multi",)),
    # The device tracebacks (in the JAX package XLA scans, not Pallas, on
    # its default device path): nw_moves after K1 on the guide's
    # one-read-a-lane buckets, mea_moves after D on the fused realign and
    # after K4 wherever K4 decodes (the REL, generic, serve and em_band
    # paths: MOVES_AFTER_K4).  The multi-lane decodes walk their bands on
    # the host, as in the JAX package.
    "nw_moves": ("marginalign_trna_tpu_torch/csrc/traceback.cu",
                 "marginalign_trna_tpu/ops/traceback_device.py:36",
                 "traceback_device.nw_moves_cuda", ("align",)),
    "mea_moves": ("marginalign_trna_tpu_torch/csrc/traceback.cu",
                  "marginalign_trna_tpu/ops/traceback_device.py:90",
                  "traceback_device.mea_moves_cuda", ("align",)),
}
ALIGN_KERNELS = [k for k, v in KERNELS.items() if "align" in v[3]]
REL_KERNELS = [k for k, v in KERNELS.items() if "rel" in v[3]]
CALLER_KERNELS = [k for k, v in KERNELS.items() if "call" in v[3]]
COUNTS_KERNELS = [k for k, v in KERNELS.items() if "em" in v[3]]
GENERIC_KERNELS = [k for k, v in KERNELS.items() if "generic" in v[3]]
SERVE_NEW = [k for k, v in KERNELS.items() if "serve" in v[3]]
MULTI_KERNELS = [k for k, v in KERNELS.items() if "multi" in v[3]]
CALL_MULTI_KERNELS = [k for k, v in KERNELS.items() if "call_multi" in v[3]]
EM_MULTI_KERNELS = [k for k, v in KERNELS.items() if "em_multi" in v[3]]
MOVES = ("nw_moves", "mea_moves")
# What every K4 decode launches besides K4.
MOVES_AFTER_K4 = ["banded_mea", "mea_moves"]
# The kernels of each serving mode (ops/fb_circ.py posteriors_circ).
SERVE_KERNELS = {
    "sv": ["sv_backward", "circ_post_es"],
    "em": ["circ_backward_emv", "circ_post_emv"],
    "lean": ["circ_backward_codes", "circ_post_codes"],
    "emw": ["circ_backward_codes_es", "circ_post_es"],
    "ckpt": ["circ_ckpt_backward", "circ_ckpt_post"],
}
# The serving kernels of one warp per lane (csrc/fb_serve.cu
# serve_backward_kernel, serve_post_kernel), their resources logged.
SERVE_WARP = ("circ_backward_emv", "circ_backward_codes",
              "circ_backward_codes_es", "circ_post_es", "circ_post_emv",
              "circ_post_codes")
# The multi-lane FB pair (csrc/fb_multi.cu, one warp per lane), its
# resources logged.
FB_MULTI = ("fb_multi_forward", "fb_multi_backward")
# The serving modes held to CPU/card parity.
SERVE_PARITY_MODES = ("sv", "ckpt")
# Band widths beyond the shipped 21 at which the tiny check runs the
# serving kernels: Wp 64 and 128 (two and four rows per thread), where the
# checkpoint posterior pass takes blocks of 4 lanes (at Wp 128 its tiles
# in device memory).
WIDE_BANDS = (61, 126)
COUNTS_PAIRS = {"stored": ("counts_fwd_all", "counts_bwd"),
                "ckpt": ("counts_fwd_ckpt", "counts_bwd_ckpt")}
COUNTS_MULTI_PAIRS = {"stored": ("counts_multi_fwd_all", "counts_multi_bwd"),
                      "ckpt": ("counts_multi_fwd_ckpt",
                               "counts_multi_bwd_ckpt")}
# Records of the main phase's corpus that the REL phase realigns.
REL_RECORDS = 256
# The EM phase: reads of the corpus it trains on and realigns, iterations;
# the EM parity phase's iterations (on PARITY_READS reads).
EM_READS = 256
EM_ITERATIONS = 5
EM_PARITY_ITERATIONS = 3
# The updateTheBand phase: reads, iterations (3 lockstep trials); the reads
# of its CPU / card parity (8 since the em_multi phase: 16 took 36 s, most
# of it the CPU run).
BAND_READS = 64
BAND_ITERATIONS = 3
BAND_PARITY_READS = 8
# The multi phase's synthetic direct-tRNA corpus: reads, references; the
# main SAM's records that marginCaller with multi=True calls on (512 since
# the em_multi phase: all 1024 took 51 s).
TRNA_READS = 16384
TRNA_REFS = 48
CALL_MULTI_RECORDS = 512
# The least share of the tRNA records whose cigars must agree between two
# realignments (multi against single lanes, CPU against card); every other
# one must be an MEA near-tie.  The corpus's unaligned stretches (inserted
# bases, fragment ends) have gap weights of exactly gap_gamma, so ~12% of
# its records hold exact MEA ties (objectives equal to 1e-15) that float
# noise in the posteriors breaks either way (a CPU rehearsal of 3000 reads:
# 88.1% equal, every other record a tie within 3.5e-16).
MULTI_MIN_EQUAL = 0.80

# The least time the card could take: the bytes a kernel must move (each
# input read once, each output written once) at the H100 SXM's 3.35 TB/s,
# or its operations at the 67 TFLOP/s of float32 outside the tensor cores,
# whichever is larger.  Operations per band cell (per targeted (row, lane)
# for the scatters, which read values only where a target is), counted
# from each kernel's arithmetic on the branch this run takes (the shipped
# model's gap-chain form for sv/cx/mw on the main path): a multiply, add,
# max, compare or select on the data is one.  The counts kernels count per
# cell and trial what the counts need, not how the kernels bin them: the
# forward's emission lookups (17), cell (10), rescale (1.25) and five
# mixes (45); the backward's cell (58), rescale, posterior (2), transition
# partials (55), gap-by-code partials (12: gamma of each of the four gap
# states and one add into its code's bin) and published e * b (22); the
# checkpoint backward adds the match-by-code partials (3: gamma and one
# add into bin x * 5 + y) and the recomputed forward (73) and drops the
# posterior.  The generic pair runs the same forward (73) and the backward
# without its partials (cell 58, rescale 2, posterior 2, e * b 22).  The
# serving kernels: S's 23 with the emission decode of their source (emv
# 22: one compare; codes 25: a compare, the table index and the mask; 27
# writing es), the posterior forward (C's recursion without the
# accumulators: 25; emv 24, codes 27), the checkpoint backward as codes
# (25) and the checkpoint posterior pass a codes backward and a codes
# forward (52).  The multi-lane kernels on the shipped model's gap-chain
# branch: nw_multi K1's 14 and the seed select (16), mea_multi K4's 10 and
# the seed select (11), fb_multi_forward the emission and shift products,
# the seed selects, the rescale and the gap-chain mixes it publishes (28),
# fb_multi_backward the gap-chain cell, injection selects, valid mask,
# rescale, posterior and e * b (31).  The multi-lane counts kernels do the
# single-lane ones' work plus, in each forward, the start injection (a
# select and five adds: 79 = 73 + 6), which the checkpoint backward's
# recomputed forward does too (231 = 225 + 6); the backwards' terminal
# injection, scale restart and start mask are per lane and diagonal, not
# per cell (151).  The tracebacks count per move made, not per band cell:
# the activity test, the row index, the state or pointer decode and the
# two position updates (nw_moves 14, mea_moves 10); their bytes are one
# pointer byte and one 4-byte offset a move, the move stream and the lane
# arrays, so the bytes bound them.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_CELL = {
    "banded_nw": 14, "fb_backward": 56, "fb_forward": 52, "banded_mea": 10,
    "expand_streams": 16, "sv_backward": 23, "cx_forward": 28,
    "scatter_lanesum": 4, "expand_rel": 14, "mw_forward": 32,
    "scatter_lanes": 4, "mea_dl": 36,
    "counts_fwd_all": 73, "counts_bwd": 151, "counts_fwd_ckpt": 73,
    "counts_bwd_ckpt": 225, "fb_generic_fwd": 73, "fb_generic_bwd": 84,
    "circ_backward_emv": 22, "circ_backward_codes": 25,
    "circ_backward_codes_es": 27, "circ_post_es": 25, "circ_post_emv": 24,
    "circ_post_codes": 27, "circ_ckpt_backward": 25, "circ_ckpt_post": 52,
    "nw_multi": 16, "mea_multi": 11, "fb_multi_forward": 28,
    "fb_multi_backward": 31, "counts_multi_fwd_all": 79,
    "counts_multi_bwd": 151, "counts_multi_fwd_ckpt": 79,
    "counts_multi_bwd_ckpt": 231, "nw_moves": 14, "mea_moves": 10,
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def nbytes(*objs):
    """Bytes of every tensor among objs."""
    import torch

    return sum(t.numel() * t.element_size() for t in objs
               if torch.is_tensor(t))


def bound(name, cells, moved):
    """{"bound_ms", "bound_by"} of kernel `name` over `cells` band cells
    (target cells for the scatter) that must move `moved` bytes."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL[name] * cells / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, reps, warm=True):
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call unless the caller has just made one (warm=False)."""
    import torch

    if warm:
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


def timed_once(fn):
    """(fn(), the milliseconds of that one call on the card, CUDA events):
    a plain version's comparison run, timed, so that it runs once."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    _, wp, B = ptr.shape
    return {
        "max_abs_err": err,
        "all_cells_equal": bool(torch.equal(ptr, rptr)),
        "ms": time_ms(lambda: wf.banded_nw_cuda(*args), reps),
        "plain_ms": time_ms(lambda: wf.banded_nw_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("banded_nw", ptr.numel(), nbytes(*args, ptr, score, state)),
        "resources": wf.warp_lane_resources("banded_nw", ptr.device, wp, B),
    }


def compare_fb(bargs, fargs, reps):
    """bargs: inputs of fb_backward; fargs: inputs of fb_forward, or None
    to take them from the plain backward on bargs.  K2's bm, bls and logZ
    and K3's post, on fargs and chained on K2's outputs, must equal their
    plain versions bit for bit (and stay within the FB tolerances: logZ
    1e-4, posteriors 2e-4).  Each plain version runs once on each input,
    that run timed; K3's chained run reuses the plain forward's output
    where fargs hold the plain backward's."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_cuda

    bm, bls, logZ = fb_cuda.fb_backward_cuda(*bargs)
    (rbm, rbls, rlogZ), bplain_ms = timed_once(
        lambda: fb_cuda.fb_backward_plain(*bargs))
    check(torch.isfinite(logZ).all().item(), "FB logZ not finite")
    check(torch.allclose(logZ, rlogZ, rtol=1e-4, atol=1e-4),
          "FB logZ differs (rtol/atol 1e-4)")
    for name, got, want in (("bm", bm, rbm), ("bls", bls, rbls),
                            ("logZ", logZ, rlogZ)):
        check(torch.equal(got, want), "fb_backward: %s differs from the "
              "plain version by %g" % (name, (got - want).abs().max().item()))
    lerr = (logZ - rlogZ).abs().max().item()
    if fargs is None:
        fargs = bargs[:4] + (rbm, rbls, rlogZ)
    post = fb_cuda.fb_forward_cuda(*fargs)
    rpost, fplain_ms = timed_once(lambda: fb_cuda.fb_forward_plain(*fargs))
    perr = (post - rpost).abs().max().item()
    check(perr <= 2e-4, "FB posterior differs by %g (atol 2e-4)" % perr)
    check(torch.equal(post, rpost), "fb_forward: post differs from the "
          "plain version by %g" % perr)
    # Both kernels chained against both plain versions chained.
    full = fb_cuda.fb_forward_cuda(*bargs[:4], bm, bls, logZ)
    plain_inputs = all(torch.equal(a, b)
                       for a, b in zip(fargs[4:], (rbm, rbls, rlogZ)))
    rfull = rpost if plain_inputs else fb_cuda.fb_forward_plain(
        *bargs[:4], rbm, rbls, rlogZ)
    ferr = (full - rfull).abs().max().item()
    check(ferr <= 2e-4, "FB chained posterior differs by %g" % ferr)
    check(torch.equal(full, rfull), "FB chained posterior differs from the "
          "plain chain by %g" % ferr)
    D1, wp, B = bm.shape
    return (
        {"max_abs_err": lerr,
         "ms": time_ms(lambda: fb_cuda.fb_backward_cuda(*bargs), reps),
         "plain_ms": bplain_ms, "library_ms": None,
         **bound("fb_backward", bm.numel(), nbytes(*bargs, bm, bls, logZ)),
         "resources": fb_cuda.fb_rel_resources(bm.device, wp, B, True)},
        {"max_abs_err": perr, "chained_max_abs_err": ferr,
         "ms": time_ms(lambda: fb_cuda.fb_forward_cuda(*fargs), reps),
         "plain_ms": fplain_ms, "library_ms": None,
         **bound("fb_forward", post.numel(), nbytes(*fargs, post)),
         "resources": fb_cuda.fb_rel_resources(bm.device, wp, B, False)},
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
        "plain_ms": time_ms(lambda: wf.banded_mea_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("banded_mea", ptr.numel(), nbytes(*args, ptr, score)),
        "resources": wf.warp_lane_resources("banded_mea", ptr.device,
                                            ptr.shape[1], ptr.shape[2]),
    }


def compare_expand(args, reps):
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    es, yb, fr = fc.expand_streams_cuda(*args)
    res, ryb, rfr = fc.expand_streams_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(es, res), "E es differs")
    check(torch.equal(fr, rfr), "E fr differs")
    check((yb is None) == (ryb is None), "E yb asked for in one version")
    if yb is not None:
        valid = res >= 0
        check(torch.equal(yb[valid], ryb[valid]),
              "E yb differs on valid cells")
    return {
        "max_abs_err": (es - res).abs().max().item(),
        "ms": time_ms(lambda: fc.expand_streams_cuda(*args), reps),
        "plain_ms": time_ms(lambda: fc.expand_streams_plain(*args), 1,
                            warm=False),
        "library_ms": None,
        **bound("expand_streams", es.numel(), nbytes(*args, es, yb, fr)),
        "resources": fc.expand_streams_resources(es.device, es.shape[1]),
    }


def compare_sv(args, reps):
    """S against its plain version: bm, bls and logZ bit-equal (S keeps
    the plain version's order of operations, built -fmad=false); with the
    block size S takes for this launch and its resources."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    bm, bls, logZ = fc.sv_backward_cuda(*args)
    rbm, rbls, rlogZ = fc.sv_backward_plain(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(logZ).all().item(), "S logZ not finite")
    for name, g, r in (("bm", bm, rbm), ("bls", bls, rbls),
                       ("logZ", logZ, rlogZ)):
        check(torch.equal(g, r), "S %s differs from the plain version by %g"
              % (name, (g - r).abs().max().item()))
    _, wp, B = bm.shape
    return {
        "max_abs_err": (logZ - rlogZ).abs().max().item(),
        "bm_max_abs_err": (bm - rbm).abs().max().item(),
        "ms": time_ms(lambda: fc.sv_backward_cuda(*args), reps),
        "plain_ms": time_ms(lambda: fc.sv_backward_plain(*args), 1,
                            warm=False),
        "library_ms": None,
        **bound("sv_backward", bm.numel(), nbytes(*args, bm, bls, logZ)),
        "resources": fc.sv_backward_resources(bm.device, wp, B),
    }


def compare_cx(args, reps):
    """C against its plain version: fl and tails bit-equal, with the
    block size C takes for this launch and its resources."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    fl, tails = fc.cx_forward_cuda(*args)
    rfl, rtails = fc.cx_forward_plain(*args)
    torch.cuda.synchronize()
    err = max((fl - rfl).abs().max().item(),
              (tails - rtails).abs().max().item())
    for name, g, r in (("fl", fl, rfl), ("tails", tails, rtails)):
        check(torch.equal(g, r), "C %s differs from the plain version by %g"
              % (name, (g - r).abs().max().item()))
    _, wp, B = args[2].shape
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: fc.cx_forward_cuda(*args), reps),
        "plain_ms": time_ms(lambda: fc.cx_forward_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("cx_forward", args[2].numel(), nbytes(*args, fl, tails)),
        "resources": fc.cx_forward_resources(args[2].device, wp, B),
    }


def compare_scatter(args, reps):
    """X against its plain version (sums in another order: rtol 1e-5),
    and the one PyTorch call that computes the same function,
    index_add_ over the (row, lane) targets, timed beside it.  X must read
    every target and the C values of the cells that hold one, and write
    the [rg, C] output."""
    import torch

    from marginalign_trna_tpu_torch.ops import bucket_scatter as bs

    vals, jm, rg = args
    out = bs.scatter_lanesum_cuda(*args)
    ref = bs.scatter_lanesum_plain(*args)
    torch.cuda.synchronize()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-4),
          "X differs from its plain version (rtol 1e-5)")
    C = vals.shape[0]
    hit = (jm >= 0) & (jm < rg)
    n_hit = int(hit.sum().item())
    tgt = torch.where(hit, jm, rg).long().reshape(-1)
    src = vals.reshape(C, -1).t().contiguous()
    lib_out = torch.zeros((rg + 1, C), dtype=torch.float32,
                          device=vals.device)
    lib_out.index_add_(0, tgt, src)
    check(torch.allclose(lib_out[:rg], ref, rtol=1e-5, atol=1e-4),
          "index_add_ disagrees with the plain version")
    return {
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": time_ms(lambda: bs.scatter_lanesum_cuda(*args), reps),
        "plain_ms": time_ms(lambda: bs.scatter_lanesum_plain(*args), 1,
                            warm=False),
        "library_ms": time_ms(lambda: lib_out.index_add_(0, tgt, src), reps),
        "target_cells": n_hit, "cells": jm.numel(),
        **bound("scatter_lanesum", n_hit,
                nbytes(jm, out) + n_hit * C * vals.element_size()),
        "resources": bs.scatter_lanesum_resources(vals.device, C,
                                                  vals.shape[2], rg),
    }


def compare_expand_rel(args, reps):
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    xb, yb = fc.expand_rel_cuda(*args)
    rxb, ryb = fc.expand_rel_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(xb, rxb) and torch.equal(yb, ryb),
          "R code bands differ")
    return {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: fc.expand_rel_cuda(*args), reps),
        "plain_ms": time_ms(lambda: fc.expand_rel_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("expand_rel", xb.numel(), nbytes(*args, xb, yb)),
        "resources": fc.expand_rel_resources(xb.device, xb.shape[1]),
    }


def compare_mw(args, reps):
    """M against its plain version: post, flc, flr, tc and tr bit-equal (M
    keeps the plain version's order of operations, built -fmad=false);
    with the block size M takes for this launch and its resources."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc

    got = fc.mw_forward_cuda(*args)
    ref = fc.mw_forward_plain(*args)
    torch.cuda.synchronize()
    perr = (got[0] - ref[0]).abs().max().item()
    serr = max((g - r).abs().max().item() for g, r in zip(got[1:], ref[1:]))
    for name, g, r in zip(("post", "flc", "flr", "tc", "tr"), got, ref):
        check(torch.equal(g, r), "M %s differs from the plain version by %g"
              % (name, (g - r).abs().max().item()))
    _, wp, B = args[2].shape
    return {
        "max_abs_err": perr, "sums_max_abs_err": serr,
        "ms": time_ms(lambda: fc.mw_forward_cuda(*args), reps),
        "plain_ms": time_ms(lambda: fc.mw_forward_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("mw_forward", got[0].numel(), nbytes(*args, *got)),
        "resources": fc.mw_forward_resources(args[2].device, wp, B),
    }


def compare_scatter_lanes(args, reps):
    """L against its plain version (rtol 1e-5), two launches bit-identical
    (no atomics, a fixed order of additions), and the one PyTorch call
    that computes the same function, scatter_add_ over the targets, timed
    beside it.  L must read every target and the value of each targeted
    cell, and write the [rg, B] output."""
    import torch

    from marginalign_trna_tpu_torch.ops import bucket_scatter as bs

    vals, jm, rg = args
    out = bs.scatter_lanes_cuda(*args)
    again = bs.scatter_lanes_cuda(*args)
    ref = bs.scatter_lanes_plain(*args)
    torch.cuda.synchronize()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-6),
          "L differs from its plain version (rtol 1e-5)")
    check(torch.equal(out, again), "two launches of L differ")
    del again
    hit = (jm >= 0) & (jm < rg)
    n_hit = int(hit.sum().item())
    tgt = torch.where(hit, jm, rg).long()
    lib_out = vals.new_zeros((rg + 1, vals.shape[1]))
    lib_out.scatter_add_(0, tgt, vals)
    check(torch.allclose(lib_out[:rg], ref, rtol=1e-5, atol=1e-6),
          "scatter_add_ disagrees with the plain version")
    return {
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": time_ms(lambda: bs.scatter_lanes_cuda(*args), reps),
        "plain_ms": time_ms(lambda: bs.scatter_lanes_plain(*args), 1,
                            warm=False),
        "library_ms": time_ms(lambda: lib_out.scatter_add_(0, tgt, vals),
                              reps),
        "target_cells": n_hit, "cells": jm.numel(),
        **bound("scatter_lanes", n_hit,
                nbytes(jm, out) + n_hit * vals.element_size()),
    }


def compare_mea_dl(args, reps):
    """D against its plain version: pointers equal on every valid cell,
    scores equal (D keeps the plain version's arithmetic); with the block
    size D takes for this launch and its resources."""
    import torch

    from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf
    from marginalign_trna_tpu_torch.ops.band import band_masks

    post, lo, m, n, width = args[:5]
    ptr, score = wf.mea_dl_cuda(*args)
    rptr, rscore = wf.mea_dl_plain(*args)
    torch.cuda.synchronize()
    ok = band_masks(lo, m, n, width, post.shape[1])[0]
    check(torch.equal(ptr[ok], rptr[ok]), "D pointers differ on valid cells")
    err = (score - rscore).abs().max().item()
    check(torch.equal(score, rscore), "D score differs by %g" % err)
    _, wp, B = ptr.shape
    return {
        "max_abs_err": err,
        "all_cells_equal": bool(torch.equal(ptr, rptr)),
        "ms": time_ms(lambda: wf.mea_dl_cuda(*args), reps),
        "plain_ms": time_ms(lambda: wf.mea_dl_plain(*args), 1, warm=False),
        "library_ms": None,
        **bound("mea_dl", ptr.numel(), nbytes(*args, ptr, score)),
        "resources": wf.warp_lane_resources("mea_dl", ptr.device, wp, B),
    }


def compare_moves(name, args, reps):
    """A traceback kernel (nw_moves, mea_moves) against its plain version:
    the packed move streams byte-equal; the kernel timed as time_ms times
    it, the plain version on its comparison call; the bound from the moves
    this input makes (a pointer byte and an offset a move, the stream, the
    lane arrays); its launch's resources (lanes a block, tile, stages and
    copy route among them)."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import traceback_device as tb

    kernel = getattr(tb, name + "_cuda")
    plain = getattr(tb, name + "_plain")
    got = kernel(*args)
    want, plain_ms = timed_once(lambda: plain(*args))
    check(got.shape == want.shape and torch.equal(got, want),
          "%s: the move stream differs from the plain version's" % name)
    D1, wp, B = args[0].shape
    moves = tb.unpack_moves(got.cpu().numpy(), D1 - 1)
    made = int((moves != tb.NO_MOVE).sum())
    return {"max_abs_err": 0.0, "ms": time_ms(lambda: kernel(*args), reps),
            "plain_ms": plain_ms, "library_ms": None, "moves": made,
            **bound(name, made, 5 * made + nbytes(got, *args[2:])),
            "resources": tb.moves_resources(name, args[0].device, wp, B)}


def host_traceback(name, args, packed):
    """What a traceback kernel replaces, on its path's inputs `args`: the
    pageable copy of the pointer band to the host and the native traceback
    of every lane, timed on the host clock (pull_ms, walk_ms, replaced_ms).
    Every lane's ops from the kernel's move stream `packed` must equal the
    native traceback's."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch import native
    from marginalign_trna_tpu_torch.ops import traceback_device as tb

    ptrs, lo, m, n = args[:4]
    extra = [a.cpu().numpy() for a in args[4:]]
    lo, m, n = (t.cpu().numpy() for t in (lo, m, n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = np.ascontiguousarray(ptrs.cpu().numpy())
    t1 = time.perf_counter()
    if name == "nw_moves":
        ops = [native.nw_traceback(host, lo[:, b], b, int(m[b]), int(n[b]),
                                   int(extra[0][b]))
               for b in range(host.shape[2])]
    else:
        ops = [native.mea_traceback(host, lo[:, b], b, int(m[b]), int(n[b]))
               for b in range(host.shape[2])]
    t2 = time.perf_counter()
    moves = tb.unpack_moves(packed.cpu().numpy(), host.shape[0] - 1)
    for b, want in enumerate(ops):
        check(want is not None, "%s: no native traceback of lane %d"
              % (name, b))
        check(tb.ops_from_moves(moves, b) == want, "%s: lane %d's ops differ "
              "from the native traceback's" % (name, b))
    return {"pull_ms": 1e3 * (t1 - t0), "walk_ms": 1e3 * (t2 - t1),
            "replaced_ms": 1e3 * (t2 - t0), "lanes": len(ops),
            "pointer_bytes": host.nbytes}


def counts_rel_err(pairs):
    """Largest relative difference of lane-summed count partials (kernel
    vs plain), each against max(|plain|, 1e-6)."""
    err = 0.0
    for got, ref in pairs:
        g, r = got.sum(-1), ref.sum(-1)
        err = max(err, ((g - r).abs() / r.abs().clamp(min=1e-6)).max()
                  .item())
    return err


def max_abs_err(pairs):
    """Largest absolute difference over pairs of (kernel, plain) outputs."""
    return max((g - r).abs().max().item() for g, r in pairs)


def compare_counts(base, reps):
    """The four counts kernels against their plain versions on one E-step
    batch, base = (T, Em, Eg, xb, yb, valid, s1, fink, find): each forward
    on base, each backward on its plain forward's outputs.  f_all, lsf, the
    terminal sums, the checkpoints and the posterior band must be
    bit-equal; the lane-summed count partials within rtol 1e-5 (the kernels
    sum each thread's rows and diagonals first, then the row threads)."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_counts
    from marginalign_trna_tpu_torch.ops import fb_counts_cuda as K

    tabs, streams, find = base[:3], base[3:8], base[8]
    cells = tabs[0].shape[0] * streams[0].numel()
    fargs = (*tabs, *streams)
    report = {}

    def timed(name, cuda_fn, plain_fn, args, err, outs):
        # The comparison's plain call was the plain version's warm-up.
        report[name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: cuda_fn(*args), reps),
            "plain_ms": time_ms(lambda: plain_fn(*args), 1, warm=False),
            "library_ms": None,
            **bound(name, cells, nbytes(*args, *outs))}

    ref = K.counts_fwd_all_plain(*fargs)
    for what, g, r in zip(("f_all", "lsf", "term"),
                          K.counts_fwd_all_cuda(*fargs), ref):
        check(torch.equal(g, r), "counts_fwd_all: %s differs from the "
              "plain version" % what)
    f_all, lsf, term = ref
    logZ = fb_counts.logz_from_terminal(lsf, term, find)
    check(torch.isfinite(logZ).all().item(), "counts logZ not finite")
    timed("counts_fwd_all", K.counts_fwd_all_cuda, K.counts_fwd_all_plain,
          fargs, 0.0, ref)
    del ref
    dev, ntr = tabs[0].device, tabs[0].shape[0]
    wp, B = streams[0].shape[1], streams[0].shape[2]
    report["counts_fwd_all"]["resources"] = K.stored_resources(dev, wp, B,
                                                               ntr)

    bargs = (*tabs, f_all, lsf, *streams, find, logZ)
    post, tcp, egp = K.counts_bwd_cuda(*bargs)
    rpost, rtcp, regp = K.counts_bwd_plain(*bargs)
    check(torch.equal(post, rpost), "counts_bwd: posterior band differs "
          "from the plain version")
    err = counts_rel_err(((tcp, rtcp), (egp, regp)))
    check(err <= 1e-5, "counts_bwd: counts differ by %g (rtol 1e-5)" % err)
    timed("counts_bwd", K.counts_bwd_cuda, K.counts_bwd_plain, bargs,
          max_abs_err(((tcp, rtcp), (egp, regp))), (post, tcp, egp))
    report["counts_bwd"]["counts_max_rel_err"] = err
    report["counts_bwd"]["resources"] = K.stored_resources(
        dev, wp, B, ntr, backward=True)
    del bargs, f_all, post, rpost

    ref = K.counts_fwd_ckpt_plain(*fargs)
    for what, g, r in zip(("ckpt", "cs", "lsf", "term"),
                          K.counts_fwd_ckpt_cuda(*fargs), ref):
        check(torch.equal(g, r), "counts_fwd_ckpt: %s differs from the "
              "plain version" % what)
    check(torch.equal(ref[2], lsf) and torch.equal(ref[3], term),
          "the two counts forwards disagree on lsf or term")
    timed("counts_fwd_ckpt", K.counts_fwd_ckpt_cuda, K.counts_fwd_ckpt_plain,
          fargs, 0.0, ref)
    report["counts_fwd_ckpt"]["resources"] = K.ckpt_forward_resources(
        tabs[0].device, streams[0].shape[1], streams[0].shape[2],
        tabs[0].shape[0])

    cargs = (*tabs, ref[0], ref[1], *streams, find, logZ)
    got = K.counts_bwd_ckpt_cuda(*cargs)
    want = K.counts_bwd_ckpt_plain(*cargs)
    err = counts_rel_err(zip(got, want))
    check(err <= 1e-5, "counts_bwd_ckpt: counts differ by %g (rtol 1e-5)"
          % err)
    # Both pairs count the same transitions and gap emissions.
    pair_err = counts_rel_err(((want[0], rtcp), (want[1], regp)))
    check(pair_err <= 1e-4, "the counts pairs disagree by %g" % pair_err)
    timed("counts_bwd_ckpt", K.counts_bwd_ckpt_cuda, K.counts_bwd_ckpt_plain,
          cargs, max_abs_err(zip(got, want)), got)
    report["counts_bwd_ckpt"]["counts_max_rel_err"] = err
    report["counts_bwd_ckpt"]["pairs_rel_err"] = pair_err
    report["counts_bwd_ckpt"]["resources"] = K.ckpt_backward_resources(
        tabs[0].device, streams[0].shape[1])
    return report


def compare_counts_multi(base, reps):
    """The four multi-lane counts kernels against their plain versions on
    one E-step batch, base = (T, Em, Eg, xb, yb, valid, s1, start, fink,
    find, L): each forward on base, each backward on its plain forward's
    outputs and L (the per-diagonal log-likelihood, ops/fb.py
    `multi_logz`, of the kernels' own run: the forwards are bit-equal).
    f_all, lsf, the terminal sums, the checkpoints and the posterior band
    must be bit-equal; the lane-summed count partials within rtol 1e-5;
    the two pairs' transition and gap counts within 1e-4 of each other."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_counts_cuda as K

    tabs, streams, find, L = base[:3], base[3:9], base[9], base[10]
    cells = tabs[0].shape[0] * streams[0].numel()
    fargs = (*tabs, *streams)
    report = {}

    def timed(name, cuda_fn, plain_fn, args, err, outs):
        # The comparison's plain call was the plain version's warm-up.
        report[name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: cuda_fn(*args), reps),
            "plain_ms": time_ms(lambda: plain_fn(*args), 1, warm=False),
            "library_ms": None,
            **bound(name, cells, nbytes(*args, *outs))}

    ref = K.counts_multi_fwd_all_plain(*fargs)
    for what, g, r in zip(("f_all", "lsf", "term"),
                          K.counts_multi_fwd_all_cuda(*fargs), ref):
        check(torch.equal(g, r), "counts_multi_fwd_all: %s differs from the "
              "plain version" % what)
    f_all, lsf, term = ref
    check(torch.isfinite(L).all().item(), "multi counts L not finite")
    timed("counts_multi_fwd_all", K.counts_multi_fwd_all_cuda,
          K.counts_multi_fwd_all_plain, fargs, 0.0, ref)
    del ref
    dev, ntr = tabs[0].device, tabs[0].shape[0]
    wp, B = streams[0].shape[1], streams[0].shape[2]
    report["counts_multi_fwd_all"]["resources"] = K.stored_resources(
        dev, wp, B, ntr, multi=True)

    bargs = (*tabs, f_all, lsf, *streams, find, L)
    post, tcp, egp = K.counts_multi_bwd_cuda(*bargs)
    rpost, rtcp, regp = K.counts_multi_bwd_plain(*bargs)
    check(torch.equal(post, rpost), "counts_multi_bwd: posterior band "
          "differs from the plain version")
    err = counts_rel_err(((tcp, rtcp), (egp, regp)))
    check(err <= 1e-5, "counts_multi_bwd: counts differ by %g (rtol 1e-5)"
          % err)
    timed("counts_multi_bwd", K.counts_multi_bwd_cuda,
          K.counts_multi_bwd_plain, bargs,
          max_abs_err(((tcp, rtcp), (egp, regp))), (post, tcp, egp))
    report["counts_multi_bwd"]["counts_max_rel_err"] = err
    report["counts_multi_bwd"]["resources"] = K.stored_resources(
        dev, wp, B, ntr, multi=True, backward=True)
    del bargs, f_all, post, rpost

    ref = K.counts_multi_fwd_ckpt_plain(*fargs)
    for what, g, r in zip(("ckpt", "cs", "lsf", "term"),
                          K.counts_multi_fwd_ckpt_cuda(*fargs), ref):
        check(torch.equal(g, r), "counts_multi_fwd_ckpt: %s differs from "
              "the plain version" % what)
    check(torch.equal(ref[2], lsf) and torch.equal(ref[3], term),
          "the two multi counts forwards disagree on lsf or term")
    timed("counts_multi_fwd_ckpt", K.counts_multi_fwd_ckpt_cuda,
          K.counts_multi_fwd_ckpt_plain, fargs, 0.0, ref)
    report["counts_multi_fwd_ckpt"]["resources"] = K.ckpt_forward_resources(
        tabs[0].device, streams[0].shape[1], streams[0].shape[2],
        tabs[0].shape[0], multi=True)

    cargs = (*tabs, ref[0], ref[1], *streams, find, L)
    got = K.counts_multi_bwd_ckpt_cuda(*cargs)
    want = K.counts_multi_bwd_ckpt_plain(*cargs)
    err = counts_rel_err(zip(got, want))
    check(err <= 1e-5, "counts_multi_bwd_ckpt: counts differ by %g (rtol "
          "1e-5)" % err)
    pair_err = counts_rel_err(((want[0], rtcp), (want[1], regp)))
    check(pair_err <= 1e-4, "the multi counts pairs disagree by %g"
          % pair_err)
    timed("counts_multi_bwd_ckpt", K.counts_multi_bwd_ckpt_cuda,
          K.counts_multi_bwd_ckpt_plain, cargs, max_abs_err(zip(got, want)),
          got)
    report["counts_multi_bwd_ckpt"]["counts_max_rel_err"] = err
    report["counts_multi_bwd_ckpt"]["pairs_rel_err"] = pair_err
    report["counts_multi_bwd_ckpt"]["resources"] = (
        K.ckpt_backward_resources(tabs[0].device, streams[0].shape[1],
                                  multi=True))
    return report


def compare_generic(base, reps):
    """The generic pair against its plain versions on one batch, base =
    (T, Em, Eg, xb, yb, valid, s1, fink, find): the forward on base, the
    backward on the plain forward's outputs.  F_match, lsf, the terminal
    sums and the posterior band must be bit-equal."""
    import torch

    from marginalign_trna_tpu_torch.ops import fb_counts, fb_counts_cuda
    from marginalign_trna_tpu_torch.ops import fb_generic_cuda as G

    tabs, streams, find = base[:3], base[3:8], base[8]
    cells = streams[0].numel()
    _, wp, lanes = streams[0].shape
    fargs = (*tabs, *streams)
    ref, fplain_ms = timed_once(lambda: G.fb_generic_fwd_plain(*fargs))
    for what, g, r in zip(("F_match", "lsf", "term"),
                          G.fb_generic_fwd_cuda(*fargs), ref):
        check(torch.equal(g, r), "fb_generic_fwd: %s differs from the plain "
              "version" % what)
    fm, lsf, term = ref
    logZ = fb_counts.logz_from_terminal(lsf[None], term[None], find)[0]
    check(torch.isfinite(logZ).all().item(), "generic logZ not finite")
    report = {"fb_generic_fwd": {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: G.fb_generic_fwd_cuda(*fargs), reps),
        "plain_ms": fplain_ms,
        "library_ms": None,
        "resources": fb_counts_cuda.generic_resources(streams[0].device, wp,
                                                      lanes),
        **bound("fb_generic_fwd", cells, nbytes(*fargs, *ref))}}
    del ref
    bargs = (*tabs, fm, lsf, *streams, find, logZ)
    post = G.fb_generic_bwd_cuda(*bargs)
    rpost, bplain_ms = timed_once(lambda: G.fb_generic_bwd_plain(*bargs))
    check(torch.equal(post, rpost), "fb_generic_bwd: posterior band differs "
          "from the plain version")
    report["fb_generic_bwd"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: G.fb_generic_bwd_cuda(*bargs), reps),
        "plain_ms": bplain_ms,
        "library_ms": None,
        "resources": fb_counts_cuda.generic_resources(streams[0].device, wp,
                                                      lanes, backward=True),
        **bound("fb_generic_bwd", cells, nbytes(*bargs, post))}
    return report


def compare_exact(name, args, reps):
    """A serving or multi-lane kernel against its plain version on `args`:
    every output bit-equal; the kernel timed as time_ms times it, the plain
    version on its comparison call (timed_once); the eight serving kernels
    and the multi-lane ones with their resources."""
    import torch

    module = importlib.import_module(
        "marginalign_trna_tpu_torch.ops." + KERNELS[name][2].split(".")[0])
    kernel = getattr(module, name + "_cuda")
    plain = getattr(module, name + "_plain")
    got = kernel(*args)
    want, plain_ms = timed_once(lambda: plain(*args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.equal(g, w), "%s: output %d differs from the plain "
              "version by %g" % (name, i, (g - w).abs().max().item()))
    check(all(torch.isfinite(g).all().item() for g in got),
          "%s: output not finite" % name)
    d1k, Wp, B = launch_shape(name, args)
    out = {"max_abs_err": err, "ms": time_ms(lambda: kernel(*args), reps),
           "plain_ms": plain_ms, "library_ms": None,
           **bound(name, d1k * Wp * B, nbytes(*args, *got))}
    if name in SERVE_WARP:
        out["resources"] = module.serve_resources(got[0].device, name, Wp, B)
    elif name in SERVE_KERNELS["ckpt"]:
        out["resources"] = module.ckpt_resources(got[0].device, name, Wp, B,
                                                 args[-1])
    elif name in FB_MULTI:
        out["resources"] = module.fb_multi_resources(
            got[0].device, Wp, B, name == "fb_multi_backward")
    elif name in ("nw_multi", "mea_multi"):
        out["resources"] = module.warp_lane_resources(name, got[0].device,
                                                      Wp, B)
    return out


COMPARE = {
    "nw_moves": functools.partial(compare_moves, "nw_moves"),
    "mea_moves": functools.partial(compare_moves, "mea_moves"),
    "banded_nw": compare_nw, "banded_mea": compare_mea,
    "expand_streams": compare_expand, "sv_backward": compare_sv,
    "cx_forward": compare_cx, "scatter_lanesum": compare_scatter,
    "expand_rel": compare_expand_rel, "mw_forward": compare_mw,
    "scatter_lanes": compare_scatter_lanes, "mea_dl": compare_mea_dl,
}


def compare_kernels(tag, names, inputs, reps):
    """Each kernel of `names` against its plain version on `inputs`
    (kernel name -> wrapper arguments; fb_forward's may be None: the plain
    backward's outputs then feed it; the counts kernels share
    inputs["counts"], compare_counts' base, the multi-lane counts kernels
    inputs["counts_multi"], compare_counts_multi's, the generic pair
    inputs["generic"], compare_generic's).  Returns {name: report}."""
    report = {}
    if any(name in COUNTS_KERNELS for name in names):
        report.update(compare_counts(inputs["counts"], reps))
    if any(name in EM_MULTI_KERNELS for name in names):
        report.update(compare_counts_multi(inputs["counts_multi"], reps))
    if any(name in GENERIC_KERNELS for name in names):
        report.update(compare_generic(inputs["generic"], reps))
    for name in names:
        if name == "fb_backward":
            report["fb_backward"], report["fb_forward"] = compare_fb(
                inputs["fb_backward"], inputs.get("fb_forward"), reps)
        elif name in SERVE_NEW or name in MULTI_KERNELS:
            report[name] = compare_exact(name, inputs[name], reps)
        elif name not in ("fb_forward", *COUNTS_KERNELS, *GENERIC_KERNELS,
                          *EM_MULTI_KERNELS):
            report[name] = COMPARE[name](inputs[name], reps)
    for name in names:
        log("kernels[%s] %-15s %s" % (tag, name, json.dumps(report[name])))
    return report


def tiny_caller_inputs(device):
    """Caller kernel inputs at a tiny shape: 40 noisy pairs of 20-150
    bases at width 21 (shipped model), each kernel fed by the plain
    versions of the kernels before it."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc
    from marginalign_trna_tpu_torch.ops.band import pack_compact_batch
    from marginalign_trna_tpu_torch.ops.expectations import (
        concat_flush_tails, fused_flush_jmaps,
    )
    from marginalign_trna_tpu_torch.ops.fb import tables_from_file
    from marginalign_trna_tpu_torch.ops.fb_circ import (
        circ_coefficients, compact_device_batch,
    )
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(13)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 150)))
            .astype(np.int8) for _ in range(40)]
    reads = [noisy(rng, r) for r in refs]
    comp = pack_compact_batch(reads, refs, width=21, quantize=True)
    dev = compact_device_batch(comp, device)
    tables = tables_from_file(DEFAULT_MODEL, device)
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    eargs = (ematch, dev.reads, dev.refs, dev.lo, dev.m, dev.n, 21,
             comp.wp, comp.num_steps)
    es, yb, fr = fc.expand_streams_plain(*eargs)
    bm, bls, logZ = fc.sv_backward_plain(coef, chain, es, dev.fink,
                                         dev.final_d)
    fl, tails = fc.cx_forward_plain(coef, chain, es, yb, fr, bm, bls, logZ)
    off = torch.arange(comp.batch, device=device) * 100
    jmap, jtail = fused_flush_jmaps(dev.lo, off, dev.n, 21, comp.wp,
                                    comp.num_steps)
    vals, jm = concat_flush_tails(fl, tails, jmap, jtail)
    return {
        "expand_streams": eargs,
        "sv_backward": (coef, chain, es, dev.fink, dev.final_d),
        "cx_forward": (coef, chain, es, yb, fr, bm, bls, logZ),
        "scatter_lanesum": (vals, jm, 100 * comp.batch + 512),
    }


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


def tiny_moves_inputs(device):
    """Inputs of the traceback kernels at a tiny shape: 37 lanes (a lane
    with m = 0, one with n = 0, one of a single base each, noisy pairs of
    up to 45 bases, padding lanes), D1 - 1 = 123; NW over
    the plain K1's pointers with the final states forced to M, Ix and Iy in
    turn, MEA over the plain K4's pointers from a random posterior band."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import wavefront_cuda as wf
    from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import device_batch
    from marginalign_trna_tpu_torch.ops.mea import NEG, mea_weights

    rng = np.random.default_rng(12)
    refs = [rng.integers(0, 4, size=int(rng.integers(2, 44)))
            .astype(np.int8) for _ in range(30)]
    reads = [noisy(rng, r) for r in refs]
    # The longest lane (m + n = 123) sets D1 - 1 = 123.
    long_ref = rng.integers(0, 4, size=60).astype(np.int8)
    reads += [np.zeros(0, np.int8), np.array([1, 2, 3, 0, 1], np.int8),
              np.array([2], np.int8),
              np.concatenate([long_ref[:30], [0, 1, 2], long_ref[30:]])
              .astype(np.int8)]
    refs += [np.array([3, 3, 1], np.int8), np.zeros(0, np.int8),
             np.array([2], np.int8), long_ref]
    out = {}
    for width, name in ((40, "nw_moves"), (21, "mea_moves")):
        batch = pack_banded_batch(reads, refs, width=width, pad_batch_to=37)
        check((batch.lo.shape[0] - 1) % 4 != 0, "tiny traceback: D1 - 1 is "
              "a multiple of 4")
        dev = device_batch(batch, device)
        lanes = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                      .to(device) for a in (batch.lo, batch.m, batch.n))
        if name == "nw_moves":
            ptr, _, _ = wf.banded_nw_plain(NW_PARAMS, dev.xb, dev.yb,
                                           dev.valid, dev.s1, dev.s2,
                                           dev.final_d, dev.final_k)
            state = torch.arange(37, dtype=torch.int32, device=device) % 3
            out[name] = (ptr,) + lanes + (state,)
            continue
        post = torch.from_numpy(rng.random(batch.valid.shape).astype(
            np.float32)).to(device) * dev.valid
        wup, wleft = mea_weights(post, dev.valid, lanes[0], 0.5,
                                 int(batch.m.max()), int(batch.n.max()))
        ptr, _ = wf.banded_mea_plain(torch.where(post > 0, post, NEG), wup,
                                     wleft, dev.valid, dev.s1, dev.s2,
                                     dev.final_d, dev.final_k)
        out[name] = (ptr,) + lanes
    return out


def tiny_default_inputs(device):
    """Inputs of R, M, L and D at a tiny shape: 40 noisy pairs of 20-150
    bases at width 21 (shipped model), each kernel fed by the plain
    versions of the kernels before it."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc
    from marginalign_trna_tpu_torch.ops.band import (
        circ_mw_streams, pack_compact_batch,
    )
    from marginalign_trna_tpu_torch.ops.expectations import (
        concat_flush_tails, fused_row_jmaps,
    )
    from marginalign_trna_tpu_torch.ops.fb import tables_from_file
    from marginalign_trna_tpu_torch.ops.fb_circ import (
        circ_coefficients, compact_device_batch,
    )
    from marginalign_trna_tpu_torch.ops.mea import rowcol_sums_from_flushed
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(14)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 150)))
            .astype(np.int8) for _ in range(40)]
    reads = [noisy(rng, r) for r in refs]
    comp = pack_compact_batch(reads, refs, width=21, quantize=True)
    dev = compact_device_batch(comp, device)
    Wp, D1 = comp.wp, comp.num_steps
    tables = tables_from_file(DEFAULT_MODEL, device)
    coef, chain = circ_coefficients(tables)
    ematch = tables.Ematch.cpu().numpy().reshape(-1)
    es, _, _ = fc.expand_streams_plain(ematch, dev.reads, dev.refs, dev.lo,
                                       dev.m, dev.n, 21, Wp, D1, False)
    fr, frr, lom = circ_mw_streams(dev.lo, 21, Wp, D1)
    bm, bls, logZ = fc.sv_backward_plain(coef, chain, es, dev.fink,
                                         dev.final_d)
    margs = (coef, chain, es, fr, frr, lom, bm, bls, logZ)
    post, flc, flr, tc, tr = fc.mw_forward_plain(*margs)
    jmap, jtail = fused_row_jmaps(dev.lo, dev.m, Wp, D1)
    vals, jm = concat_flush_tails(flr, tr, jmap, jtail)
    accr, accc = rowcol_sums_from_flushed(comp, dev, flc, flr, tc, tr)
    return {
        "expand_rel": (dev.reads, dev.refs, dev.lo, dev.m, dev.n, Wp, D1),
        "mw_forward": margs,
        "scatter_lanes": (vals, jm, accr.shape[0]),
        "mea_dl": (post, dev.lo, dev.m, dev.n, 21, dev.final_d, dev.final_k,
                   accr, accc, 0.5, 0.0),
    }


def tiny_counts_inputs(device):
    """The counts kernels' base inputs at a tiny shape: 40 noisy pairs of
    20-150 bases at width 21, three random EM starts (non-flat gaps)."""
    import numpy as np

    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import fb_counts
    from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_stacked

    rng = np.random.default_rng(15)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 150)))
            .astype(np.int8) for _ in range(40)]
    reads = [noisy(rng, r) for r in refs]
    dev = device_batch(pack_banded_batch(reads, refs, width=21,
                                         quantize=True), device)
    hmms = [PairHmm.random(seed=30 + t) for t in range(3)]
    for h in hmms:
        h.apply_model_type_constraints()
    tables = tables_stacked(hmms, device)
    return {"counts": (tables.T, tables.Ematch, tables.Egap,
                       *fb_counts.kernel_inputs(dev))}


def tiny_counts_multi_inputs(device, ntr=3):
    """The multi-lane counts kernels' base inputs at a tiny shape: 60 noisy
    pairs of 20-120 bases packed several per lane (pad_steps_to 256; a lane
    holds three or more) at width 21 (Wp 24), `ntr` random EM starts
    (non-flat gaps); L from the plain forward."""
    import numpy as np

    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import fb_counts
    from marginalign_trna_tpu_torch.ops import fb_counts_cuda as K
    from marginalign_trna_tpu_torch.ops.band import pack_multi_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import (
        multi_device_batch, multi_logz, tables_stacked,
    )

    rng = np.random.default_rng(20)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 120)))
            .astype(np.int8) for _ in range(60)]
    reads = [noisy(rng, r) for r in refs]
    mb = pack_multi_banded_batch(reads, refs, width=21, pad_steps_to=256)
    check(max(np.bincount([p.lane for p in mb.problems])) >= 3,
          "tiny counts multi: no lane holds three problems")
    md = multi_device_batch(mb, device)
    hmms = [PairHmm.random(seed=40 + t) for t in range(ntr)]
    for h in hmms:
        h.apply_model_type_constraints()
    tables = tables_stacked(hmms, device)
    *streams, fk, fd = fb_counts.multi_kernel_inputs(md)
    tabs = (tables.T, tables.Ematch, tables.Egap)
    _, lsf, term = K.counts_multi_fwd_all_plain(*tabs, *streams, fk)
    L, _ = multi_logz(lsf, term, md)
    return {"counts_multi": (*tabs, *streams, fk, fd, L)}


def tiny_generic_inputs(device):
    """The generic pair's base inputs at a tiny shape: 40 noisy pairs of
    20-150 bases at width 21, the shipped model with one gap row perturbed
    (not flat)."""
    import numpy as np

    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import fb_counts
    from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import device_batch, tables_from_hmm
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(16)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 150)))
            .astype(np.int8) for _ in range(40)]
    reads = [noisy(rng, r) for r in refs]
    dev = device_batch(pack_banded_batch(reads, refs, width=21,
                                         quantize=True), device)
    hmm = PairHmm.load(DEFAULT_MODEL)
    hmm.emissions[1, :4] *= 1.5
    hmm.emissions[1] /= hmm.emissions[1].sum()
    tables = tables_from_hmm(hmm, device)
    return {"generic": (tables.T, tables.Ematch, tables.Egap,
                        *fb_counts.kernel_inputs(dev))}


def tiny_serve_inputs(device, chain_model=True, width=21):
    """The serving kernels' inputs (and S's) at a tiny shape: 40 noisy
    pairs of 20-150 bases at `width` (21: Wp 24) in the circular layout,
    the shipped model or (chain_model=False) its flat-gap variant whose gap
    states 1 and 2 exchange 0.05 (the kernels' generic 5x5 branch); the
    forwards and the checkpoint posterior pass fed by the plain
    backwards."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import fb_circ_cuda as fc
    from marginalign_trna_tpu_torch.ops.band import pack_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import (
        FbTables, circ_device_batch, device_batch, tables_from_file,
    )
    from marginalign_trna_tpu_torch.ops.fb_circ import (
        circ_coefficients, emission_stream,
    )
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(18)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 150)))
            .astype(np.int8) for _ in range(40)]
    reads = [noisy(rng, r) for r in refs]
    batch = pack_banded_batch(reads, refs, width=width, quantize=True)
    cdev = circ_device_batch(batch, device_batch(batch, device))
    tables = tables_from_file(DEFAULT_MODEL)
    if not chain_model:
        T = tables.T.numpy().copy()
        T[1, 2] = T[2, 1] = 0.05
        T /= T.sum(axis=1, keepdims=True)
        tables = FbTables(T, tables.Ematch.numpy(), tables.Egap.numpy(),
                          tables.pi.numpy())
    coef, chain = circ_coefficients(tables)
    check(chain == chain_model, "tiny serve: unexpected model branch")
    table = tables.Ematch.numpy().reshape(-1)
    xb, yb, fink, find = cdev.xb, cdev.yb, cdev.fink, cdev.final_d
    valid = cdev.valid.view(torch.int8)
    es = emission_stream(table, xb, yb, cdev.valid, True)
    em = emission_stream(table, xb, yb, cdev.valid, False)
    back = fc.sv_backward_plain(coef, chain, es, fink, find)
    codes = (coef, chain, table, xb, yb, valid)
    kb = fc.ckpt_block(xb.shape[1])
    ck = fc.circ_ckpt_backward_plain(*codes, fink, find, kb)
    return {
        "sv_backward": (coef, chain, es, fink, find),
        "circ_backward_emv": (coef, chain, em, valid, fink, find),
        "circ_backward_codes": (*codes, fink, find),
        "circ_backward_codes_es": (*codes, fink, find),
        "circ_post_es": (coef, chain, es, *back),
        "circ_post_emv": (coef, chain, em, valid, *back),
        "circ_post_codes": (*codes, *back),
        "circ_ckpt_backward": (*codes, fink, find, kb),
        "circ_ckpt_post": (*codes, fink, find, *ck, kb),
    }


def tiny_multi_inputs(device, chain_model=True, width=21):
    """The multi-lane kernels' inputs at a tiny shape: 60 noisy pairs of
    20-120 bases packed several per lane (pad_steps_to 256) at `width`
    (21: Wp 24; 40: Wp 48), the shipped model or (chain_model=False) its
    flat-gap variant whose gap states 1 and 2 exchange 0.05; the backward
    fed by the plain forward, the MEA by the plain posteriors."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.ops import fb_multi_cuda as fm
    from marginalign_trna_tpu_torch.ops.band import pack_multi_banded_batch
    from marginalign_trna_tpu_torch.ops.fb import (
        FbTables, multi_device_batch, tables_from_file,
    )
    from marginalign_trna_tpu_torch.ops.fb_circ import circ_coefficients
    from marginalign_trna_tpu_torch.ops.mea import NEG
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    rng = np.random.default_rng(19)
    refs = [rng.integers(0, 4, size=int(rng.integers(20, 120)))
            .astype(np.int8) for _ in range(60)]
    reads = [noisy(rng, r) for r in refs]
    mb = pack_multi_banded_batch(reads, refs, width=width, pad_steps_to=256)
    check(len({p.lane for p in mb.problems}) < len(refs),
          "tiny multi: no lane holds two problems")
    md = multi_device_batch(mb, device)
    tables = tables_from_file(DEFAULT_MODEL)
    if not chain_model:
        T = tables.T.numpy().copy()
        T[1, 2] = T[2, 1] = 0.05
        T /= T.sum(axis=1, keepdims=True)
        tables = FbTables(T, tables.Ematch.numpy(), tables.Egap.numpy(),
                          tables.pi.numpy())
    coef, chain = circ_coefficients(tables)
    check(chain == chain_model, "tiny multi: unexpected model branch")
    em = tables.Ematch.to(device)[md.xb.long(), md.yb.long()] * md.valid
    fargs = (coef, chain, em, md.valid, md.s1, md.start, md.fink)
    fmatch, lsf, term = fm.fb_multi_forward_plain(*fargs)
    L = (torch.log(term.clamp(min=1e-30)) + lsf).gather(
        0, md.step_final.long())
    bargs = (coef, chain, fmatch, lsf, L, em, md.valid, md.s1, md.fink,
             md.find)
    post = fm.fb_multi_backward_plain(*bargs)
    gap = 0.5 * (1.0 - post).clamp(0.0, 1.0)
    return {
        "nw_multi": (NW_PARAMS, md.xb, md.yb, md.valid, md.s1, md.s2,
                     md.start, md.fink, md.find),
        "fb_multi_forward": fargs,
        "fb_multi_backward": bargs,
        "mea_multi": (torch.where(post > 0, post, NEG), gap,
                      gap.flip(1).contiguous(), md.valid, md.s1, md.s2,
                      md.start, md.fink, md.find),
    }


def generic_base(largest):
    """compare_generic's base from the recorded largest launches of the
    generic pair: the forward's arguments and the backward's find."""
    return largest["fb_generic_fwd"] + (largest["fb_generic_bwd"][10],)


def counts_base(largest):
    """compare_counts' base from the recorded largest launches of the
    counts pair a path ran: the forward's arguments and the backward's
    find."""
    for fwd, bwd in COUNTS_PAIRS.values():
        if fwd in largest:
            return largest[fwd] + (largest[bwd][10],)
    raise SmokeFailure("no counts kernel launched")


def counts_multi_base(largest):
    """compare_counts_multi's base from the recorded largest launches of the
    multi counts pair a path ran: the forward's arguments and the
    backward's find and L."""
    for fwd, bwd in COUNTS_MULTI_PAIRS.values():
        if fwd in largest:
            return largest[fwd] + (largest[bwd][11], largest[bwd][12])
    raise SmokeFailure("no multi counts kernel launched")


def launch_shape(name, args):
    """The band a kernel call walks: [D1 or d1k, Wp, B] ([C, D, B] or
    [D, B] for the scatters' values, [Ntr, d1k, Wp, B] for the counts
    kernels)."""
    import torch

    if name == "expand_streams":
        return [args[8], args[7], args[3].shape[1]]
    if name == "expand_rel":
        return [args[6], args[5], args[2].shape[1]]
    if name == "scatter_lanes":
        return list(args[0].shape)
    if name in COUNTS_KERNELS or name in EM_MULTI_KERNELS:  # [Ntr, d1k, Wp, B]
        return [args[0].shape[0]] + list(next(
            a for a in args[3:] if torch.is_tensor(a) and a.dim() == 3
            and a.dtype == torch.int8).shape)
    return list(next(a for a in args
                     if torch.is_tensor(a) and a.dim() == 3).shape)


@contextlib.contextmanager
def replaced_everywhere(replacements):
    """Inside the block every port module's reference to a function in
    `replacements` ({function: replacement}) is the replacement."""
    by_id = {id(fn): new for fn, new in replacements.items()}
    patched = []
    for modname, mod in list(sys.modules.items()):
        if modname.split(".")[0] != "marginalign_trna_tpu_torch":
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in by_id:
                patched.append((mod, attr, val))
                setattr(mod, attr, by_id[id(val)])
    try:
        yield
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


@contextlib.contextmanager
def recording_launches(names):
    """Inside the block every port module's reference to the wrapper of a
    kernel in `names` goes through a recorder: it logs the [D1, Wp, B] of
    each call and keeps a device copy of the inputs of the largest call per
    kernel.  Calls of the host band packer (ops/band.py
    `pack_banded_batch`) are counted and timed.  Yields (shapes {name:
    [[D1, Wp, B], ...]}, largest {name: inputs}, host {"pack_banded_batch":
    calls, "pack_banded_batch_s": seconds})."""
    import importlib

    import numpy as np
    import torch

    from marginalign_trna_tpu_torch import pipeline  # noqa: F401 (the path)
    from marginalign_trna_tpu_torch.call import caller  # noqa: F401
    from marginalign_trna_tpu_torch.ops import band

    shapes = {name: [] for name in names}
    largest, sizes = {}, {}
    host = {"pack_banded_batch": 0, "pack_banded_batch_s": 0.0}

    def recorder(name, fn):
        def call(*args):
            shape = launch_shape(name, args)
            shapes[name].append(shape)
            if int(np.prod(shape)) > sizes.get(name, -1):
                sizes[name] = int(np.prod(shape))
                largest[name] = tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)
            return fn(*args)
        return call

    def counted(fn):
        def call(*args, **kwargs):
            host["pack_banded_batch"] += 1
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host["pack_banded_batch_s"] += time.perf_counter() - t0
            return out
        return call

    replacements = {band.pack_banded_batch: counted(band.pack_banded_batch)}
    for name in names:
        module, fn = KERNELS[name][2].split(".")
        wrapper = getattr(importlib.import_module(
            "marginalign_trna_tpu_torch.ops." + module), fn)
        replacements[wrapper] = recorder(name, wrapper)
    with replaced_everywhere(replacements):
        yield shapes, largest, host


@contextlib.contextmanager
def counting_host_tracebacks():
    """Inside the block the native host tracebacks (native.nw_traceback,
    native.mea_traceback) and every copy of a pointer band (a uint8
    [D1, Wp, B] tensor on the card) to the host are counted.  Yields the
    counts {"nw_traceback", "mea_traceback", "pointer_band_pulls"}."""
    import torch

    from marginalign_trna_tpu_torch import native

    seen = {"nw_traceback": 0, "mea_traceback": 0, "pointer_band_pulls": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return call

    def band(t):
        return t.is_cuda and t.dtype == torch.uint8 and t.dim() == 3

    cpu, to, copy_ = torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.copy_

    def cpu_counted(self, *args, **kwargs):
        seen["pointer_band_pulls"] += band(self)
        return cpu(self, *args, **kwargs)

    def to_counted(self, *args, **kwargs):
        out = to(self, *args, **kwargs)
        seen["pointer_band_pulls"] += band(self) and not out.is_cuda
        return out

    def copy_counted(self, src, *args, **kwargs):
        seen["pointer_band_pulls"] += (not self.is_cuda and torch.is_tensor(src)
                                       and band(src))
        return copy_(self, src, *args, **kwargs)

    torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.copy_ = (
        cpu_counted, to_counted, copy_counted)
    try:
        with replaced_everywhere({
                native.nw_traceback: counted("nw_traceback",
                                             native.nw_traceback),
                native.mea_traceback: counted("mea_traceback",
                                              native.mea_traceback)}):
            yield seen
    finally:
        torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.copy_ = cpu, to, copy_


def check_no_host_tracebacks(path, seen):
    """No native host traceback ran and no pointer band left the card on
    `path` (counting_host_tracebacks)."""
    log("%s: host tracebacks and pointer band pulls %s"
        % (path, json.dumps(seen)))
    for what, count in seen.items():
        check(count == 0, "%s: %d calls of %s" % (path, count, what))


def check_launches(path, names, launches, shapes):
    """Every kernel of `names` launched on `path`, once per wrapper call;
    no other kernel launched."""
    for name in KERNELS:
        if name in names:
            check(launches[name] > 0, "kernel %s never launched on the %s "
                  "path" % (name, path))
            check(len(shapes[name]) == launches[name], "kernel %s: %d "
                  "wrapper calls, %d launches" % (name, len(shapes[name]),
                                                  launches[name]))
        else:
            check(launches[name] == 0, "kernel %s launched on the %s path"
                  % (name, path))


# ------------------------------------------------------------------ phases


def phase_main(tmpdir):
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.ops import _build

    fq, fa, truth = write_corpus(tmpdir, N_READS, READ_LEN)
    out = os.path.join(tmpdir, "out.sam")
    with recording_launches(ALIGN_KERNELS) as (shapes, largest, host), \
            counting_host_tracebacks() as seen:
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
    log("main: host band packer calls %s" % json.dumps(host))
    check_launches("main", ALIGN_KERNELS, launches, shapes)
    check(host["pack_banded_batch"] == 0,
          "the host band packer ran on the main path")
    check_no_host_tracebacks("main", seen)
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
    return fq, fa, truth, out, launches, largest, {
        "reads_out": len(recs), "total_s": total,
        "reads_per_s": len(recs) / total, **stages}


def phase_kernels(tag, names, largest):
    """Kernel vs plain on the inputs of each kernel's largest launch on a
    path."""
    from marginalign_trna_tpu_torch.ops import traceback_device as tb

    shapes = {name: launch_shape(name, largest[name]) for name in names}
    log("kernels[%s] inputs of the largest launch %s"
        % (tag, json.dumps(shapes)))
    report = compare_kernels(tag, names, largest, 5)
    for name in MOVES:
        if name in names:
            args = largest[name]
            report[name]["replaced"] = host_traceback(
                name, args, getattr(tb, name + "_cuda")(*args))
            log("kernels[%s] %s replaces %s" % (
                tag, name, json.dumps(report[name]["replaced"])))
    return report


def mea_objective(ops, post, lo, g_read, g_ref, b):
    """The MEA objective of one segment's ops [(op, len)] under one lane's
    weights: posterior of every matched cell, gap weight of every skipped
    read (g_read) or reference (g_ref) position; float64 on the host."""
    i = j = 0
    total = 0.0
    for op, ln in ops:
        for _ in range(ln):
            if op == 0:
                i, j = i + 1, j + 1
                total += float(post[i + j, i - lo[i + j, b], b])
            elif op == 1:
                i += 1
                total += float(g_read[i - 1, b])
            else:
                j += 1
                total += float(g_ref[j - 1, b])
    return total


def rel_gap_weights(post, batch, gap_gamma):
    """(read gap weights [max m, B], ref gap weights [max n, B]) of a REL
    decode (ops/mea.py `mea_weights`): gap_gamma * (1 - the posterior mass
    of the read's row or the reference's column), clipped to [0, 1] before
    the product; float64 on the host from the posterior band."""
    import numpy as np

    D1, Wp, B = post.shape
    i = batch.lo.astype(np.int64)[:, None, :] + np.arange(Wp)[None, :, None]
    j = np.arange(D1)[:, None, None] - i
    ok = batch.valid & (i >= 1) & (j >= 1)
    lane = np.broadcast_to(np.arange(B), post.shape)
    out = []
    for pos, size in ((i, int(batch.m.max())), (j, int(batch.n.max()))):
        mass = np.bincount(((pos - 1) * B + lane)[ok], post[ok],
                           minlength=size * B).reshape(size, B)
        out.append(gap_gamma * np.clip(1.0 - mass, 0.0, 1.0))
    return tuple(out)


def ops_with_weights(segs, hmm, device, serve=None):
    """realigned_ops_for_jobs on the path the model takes (the fused path,
    or the circular serving route in mode `serve`; the REL path for a model
    whose gap emissions are not flat), with each segment's MEA inputs kept:
    (ops per segment, {segment: ((posterior band, lo, read gap weights, ref
    gap weights) of its bucket, its lane)})."""
    import numpy as np

    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.ops import mea
    from marginalign_trna_tpu_torch.ops.wavefront_cuda import _gap_weights

    weights = []
    fused, rel = mea.mea_decode_fused, mea.mea_decode

    def keep_fused(post, comp, dev, accr, accc, gap_gamma, match_gamma):
        weights.append((post.cpu().numpy(), comp.lo.astype(np.int64),
                        _gap_weights(accr, gap_gamma).cpu().numpy(),
                        _gap_weights(accc, gap_gamma).cpu().numpy()))
        return fused(post, comp, dev, accr, accc, gap_gamma, match_gamma)

    def keep_rel(post, batch, dev, gap_gamma, match_gamma):
        p = post.cpu().numpy()
        weights.append((p, batch.lo.astype(np.int64),
                        *rel_gap_weights(p, batch, gap_gamma)))
        return rel(post, batch, dev, gap_gamma, match_gamma)

    with replaced_everywhere({fused: keep_fused, rel: keep_rel}):
        ops = realign.realigned_ops_for_jobs(segs, hmm, 0.5, 0.0, device,
                                             fused=True, serve=serve)
    lane_of = {}
    for w, bucket in zip(weights, realign._bucket_jobs(
            segs, realign.DEFAULT_BAND_WIDTH, 128_000_000)):
        for b, s_idx in enumerate(bucket):
            lane_of[s_idx] = (w, b)
    return ops, lane_of


def record_cigar(job, origin, ops_of, k):
    """Job k's realigned cigar from its segments' ops (origin: the job of
    each segment)."""
    from marginalign_trna_tpu_torch.align import realign

    ops = [op for s_idx, j in enumerate(origin) if j == k
           for op in ops_of[s_idx]]
    return realign.splice_realigned_cigar(
        job.record, realign._merge_op_runs(ops)).cigar


def tie_gap(k, origin, ops, other_ops, lane_of):
    """Largest relative MEA-objective difference between two decodes of
    record k's segments that differ, scored under the weights kept with
    `ops` (ops_with_weights)."""
    worst = 0.0
    for s_idx, job in enumerate(origin):
        if job != k or ops[s_idx] == other_ops[s_idx]:
            continue
        (post, lo, g_read, g_ref), b = lane_of[s_idx]
        f = mea_objective(ops[s_idx], post, lo, g_read, g_ref, b)
        r = mea_objective(other_ops[s_idx], post, lo, g_read, g_ref, b)
        worst = max(worst, abs(f - r) / max(abs(f), 1.0))
    return worst


def phase_rel(tmpdir, fq, fa, main_sam):
    """The REL realign path (fused=False: host band arrays, K2, K3, weight
    bands, K4) on the chained records of the corpus's first REL_RECORDS
    reads, cut into the main path's anchor segments.  Its cigars against
    the main phase's (fused path): every record placed identically, >= 90%
    of cigars equal, and every segment that differs an MEA near-tie: its
    REL ops score within 1e-5 (relative) of the fused ops under the fused
    path's own weights (posterior band and gap weights, captured from a
    fused run of the same segments)."""
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.utils.seq import encode

    sub = os.path.join(tmpdir, "rel_subset.fq")
    subset_fastq(fq, sub, REL_RECORDS)
    chained = os.path.join(tmpdir, "rel_chained.sam")
    pipeline.align(sub, fa, chained, pipeline.AlignOptions(no_realign=True),
                   device="cuda")
    jobs = realign._jobs_from_sam(SamFile.read(chained),
                                  get_fasta_dictionary(fa), encode)
    segs, origin, _ = realign.split_jobs_at_anchors(
        jobs, realign.DEFAULT_SPLIT_SIZE)
    hmm = PairHmm.load(pipeline.DEFAULT_MODEL)
    args = (segs, hmm, 0.5, 0.0, "cuda")
    names = REL_KERNELS + ["mea_moves"]
    with recording_launches(names) as (shapes, largest, host), \
            counting_host_tracebacks() as seen:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rel_ops = realign.realigned_ops_for_jobs(*args, fused=False)
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    log("rel: %d records (%d segments) realigned with fused=False in %.3f s;"
        " launches %s; launch shapes %s; host band packer calls %d"
        % (len(jobs), len(segs), total, json.dumps(launches),
           json.dumps(shapes), host["pack_banded_batch"]))
    check_launches("REL", names, launches, shapes)
    check_no_host_tracebacks("rel", seen)

    # The fused path on the same segments, its MEA inputs kept per lane.
    fused_ops, lane_of = ops_with_weights(segs, hmm, "cuda")

    def cigar(ops_of, k):
        return record_cigar(jobs[k], origin, ops_of, k)

    main = {r.qname: r for r in sam_records(main_sam)}
    same = ties = 0
    worst = 0.0
    for k, job in enumerate(jobs):
        want = main[job.record.qname]
        check((job.record.flag, job.record.rname, job.record.pos + 1)
              == (want.flag, want.rname, want.pos),
              "REL record %s placed differently" % job.record.qname)
        fused = cigar(fused_ops, k)
        check("".join("%d%s" % (ln, "MIDNSHP=X"[op]) for op, ln in fused)
              == "".join("%d%s" % (ln, op) for op, ln in want.cigar),
              "fused rerun of %s differs from the main phase"
              % job.record.qname)
        if cigar(rel_ops, k) == fused:
            same += 1
            continue
        worst = max(worst, tie_gap(k, origin, fused_ops, rel_ops, lane_of))
        ties += 1
    log("rel: %d of %d cigars equal to the main phase's (fused path); the "
        "other %d are MEA near-ties, worst objective difference %.3g "
        "(relative)" % (same, len(jobs), ties, worst))
    check(same >= 0.90 * len(jobs), "REL and fused cigars agree on fewer "
          "than 90%")
    check(worst <= 1e-5, "a REL cigar scores %.3g (relative) off the fused "
          "one under the fused weights" % worst)
    state = {"chained": chained, "jobs": jobs, "segs": segs,
             "origin": origin, "rel_ops": rel_ops, "lane_of": lane_of}
    return launches, largest, {"records": len(jobs), "segments": len(segs),
                               "total_s": total, "cigars_equal": same,
                               "near_ties": ties,
                               "worst_tie_relative": worst}, state


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


def write_mutated_reference(tmpdir, fa, seed=17):
    """A copy of `fa` with one substitution every SNV_STEP bases from
    SNV_FIRST to SNV_LAST on every reference.  Returns (path, planted
    {(name, 1-based pos, true base)}): reads come from the unmutated
    sequence, so the true base is the expected alt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(fa) as fh:
        text = fh.read().split(">")[1:]
    out = os.path.join(tmpdir, "ref_mutated.fa")
    planted = set()
    with open(out, "w") as fh:
        for entry in text:
            name, seq = entry.split("\n", 1)
            seq = list(seq.replace("\n", ""))
            for p in range(SNV_FIRST, SNV_LAST + 1, SNV_STEP):
                alt = "ACGT"[("ACGT".index(seq[p]) + int(rng.integers(1, 4)))
                             % 4]
                planted.add((name, p + 1, seq[p]))
                seq[p] = alt
            fh.write(">%s\n%s\n" % (name, "".join(seq)))
    return out, planted


def phase_caller(tmpdir, fa, sam):
    import torch

    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.vcf import vcf_read
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    mut_fa, planted = write_mutated_reference(tmpdir, fa)
    vcf = os.path.join(tmpdir, "calls.vcf")
    hmm = PairHmm.load(DEFAULT_MODEL)
    n_records = len(sam_records(sam))
    with recording_launches(CALLER_KERNELS) as (shapes, largest, _):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        calls = caller.margin_caller(sam, mut_fa, vcf, hmm, hmm,
                                     device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    found = vcf_read(vcf)
    hit = len(found & planted)
    recall = hit / len(planted)
    precision = hit / max(len(found), 1)
    log("caller: %d records in, %d calls, %.3f s, %.2f reads/s"
        % (n_records, len(calls), total, n_records / total))
    log("caller: launches %s" % json.dumps(launches))
    log("caller: launch shapes [d1k, Wp, B] ([C, D, B] for the scatter) %s"
        % json.dumps(shapes))
    log("caller: %d planted SNVs, %d called at their position with the "
        "true base; recall %.4f, precision %.4f"
        % (len(planted), hit, recall, precision))
    check_launches("caller", CALLER_KERNELS, launches, shapes)
    check(recall >= 0.95, "caller recall %.4f < 0.95" % recall)
    check(precision >= 0.95, "caller precision %.4f < 0.95" % precision)
    return mut_fa, launches, largest, {
        "records_in": n_records, "calls": len(calls), "total_s": total,
        "reads_per_s": n_records / total, "planted": len(planted),
        "recall": recall, "precision": precision}


def phase_caller_parity(tmpdir, fa, sam):
    """The caller on the SAM's first PARITY_READS records on the CPU
    (plain versions) and on the card (kernels)."""
    import numpy as np

    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    sub = SamFile.read(sam)
    sub.records = sub.records[:PARITY_READS]
    path = os.path.join(tmpdir, "caller_subset.sam")
    sub.write(path)
    refs = get_fasta_dictionary(fa)
    hmm = PairHmm.load(DEFAULT_MODEL)
    exp, calls = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        exp[dev] = caller.accumulate_expectations(
            SamFile.read(path), refs, hmm, caller.CallerOptions(),
            device=dev)
        calls[dev] = {c[:3] for c in caller.call_variants(
            exp[dev], refs, hmm, caller.DEFAULT_THRESHOLD)}
        log("caller parity: device %s %.3f s" % (dev,
                                                 time.perf_counter() - t0))
    err = max(float(np.abs(exp["cpu"][k] - exp["cuda"][k]).max())
              for k in refs)
    log("caller parity: %d records; calls cpu %d, cuda %d; expectations "
        "max abs difference %g" % (len(sub.records), len(calls["cpu"]),
                                   len(calls["cuda"]), err))
    check(calls["cpu"] == calls["cuda"], "call sets differ between cpu "
          "and cuda")
    check(err <= 1e-3, "expectations differ by %g between cpu and cuda"
          % err)
    return {"records": len(sub.records), "calls": len(calls["cuda"]),
            "expectations_max_abs_err": err}


@contextlib.contextmanager
def em_recording():
    """Inside the block every lockstep E-step's per-trial log-likelihoods
    are kept (align/em.py `expectation_step_trials`), the host-side E-step
    batch preparation (`prepare_em_batches`: band packing and upload) is
    timed, and every band update (`_update_band_jobs`) is logged with the
    generic-pair launches it made and the segment paths it returned.
    Yields {"histories": [[Ntr] per E-step], "estep_s": [seconds per
    E-step: launches, wait, pull], "prepare_s": [seconds per call],
    "kinds": [[batch kinds] per call], "band_updates": [{"generic_launches",
    "s", "paths"}]}."""
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.ops import _build

    rec = {"histories": [], "estep_s": [], "prepare_s": [], "kinds": [],
           "band_updates": []}
    step, prepare = em.expectation_step_trials, em.prepare_em_batches
    update = em._update_band_jobs

    def recorded_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        rec["estep_s"].append(time.perf_counter() - t0)
        rec["histories"].append([float(v) for v in out[3]])
        return out

    def timed_prepare(*args, **kwargs):
        t0 = time.perf_counter()
        out = prepare(*args, **kwargs)
        for _, dev, _ in out:
            if dev.xb.is_cuda:
                import torch

                torch.cuda.synchronize(dev.xb.device)
        rec["prepare_s"].append(time.perf_counter() - t0)
        rec["kinds"].append([kind for kind, _, _ in out])
        return out

    def recorded_update(*args, **kwargs):
        before = _build.launch_counts["fb_generic_fwd"]
        t0 = time.perf_counter()
        out = update(*args, **kwargs)
        rec["band_updates"].append({
            "generic_launches": _build.launch_counts["fb_generic_fwd"]
            - before, "s": time.perf_counter() - t0,
            "paths": [j.path for j in out]})
        return out

    with replaced_everywhere({step: recorded_step, prepare: timed_prepare,
                              update: recorded_update}):
        yield rec


def check_em_counts_policy(path, shapes, launches, pairs=COUNTS_PAIRS):
    """The counts pair (of `pairs`: the single-lane or the multi-lane
    kernels) of every E-step batch is the one ops/fb_counts.py use_ckpt
    picks for its shape; returns the kernels that must launch."""
    from marginalign_trna_tpu_torch.ops.fb_counts import use_ckpt

    want = set()
    for pair, (fwd, bwd) in pairs.items():
        check(launches[fwd] == launches[bwd], "%s: %d %s launches, %d %s"
              % (path, launches[fwd], fwd, launches[bwd], bwd))
        for shape in shapes[fwd]:
            check(use_ckpt(shape[1:], shape[0]) == (pair == "ckpt"),
                  "%s: the %s pair ran a batch %s that the policy gives "
                  "the other pair" % (path, pair, shape))
        if launches[fwd]:
            want.update((fwd, bwd))
    check(want, "%s: no counts kernel launched" % path)
    return sorted(want)


def check_histories(path, histories):
    """Every trial's log-likelihood is non-decreasing over the E-steps
    (within 1e-5 relative)."""
    h = [list(col) for col in zip(*histories)]
    for t, hist in enumerate(h):
        for a, b in zip(hist, hist[1:]):
            check(b >= a - 1e-5 * abs(a), "%s: trial %d log-likelihood fell "
                  "from %.6f to %.6f" % (path, t, a, b))
    return h


def phase_em(tmpdir, fq, fa, truth):
    """marginAlign --em on the corpus's first EM_READS reads, on the card."""
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build

    sub = os.path.join(tmpdir, "em_subset.fq")
    subset_fastq(fq, sub, EM_READS)
    out = os.path.join(tmpdir, "em.sam")
    model = os.path.join(tmpdir, "em.hmm")
    opts = pipeline.AlignOptions(
        em=True, output_model_path=model,
        em_options=em.EmOptions(iterations=EM_ITERATIONS,
                                output_trial_hmms_path=model))
    with recording_launches(ALIGN_KERNELS + COUNTS_KERNELS) as (
            shapes, largest, host), em_recording() as rec:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stages = pipeline.align(sub, fa, out, opts, device="cuda")
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    recs = sam_records(out)
    log("em: %d reads in, %d records out, %.3f s, %.2f reads/s"
        % (EM_READS, len(recs), total, len(recs) / total))
    log("em: stages %s; E-step batch preparation (host packing + upload) "
        "%s s" % (json.dumps(stages), json.dumps(rec["prepare_s"])))
    log("em: launches %s" % json.dumps(launches))
    log("em: launch shapes %s" % json.dumps(shapes))
    log("em: host band packer calls %s" % json.dumps(host))
    pair = check_em_counts_policy("em", shapes, launches)
    check_launches("em", ALIGN_KERNELS + pair, launches, shapes)
    histories = check_histories("em", rec["histories"])
    log("em: log-likelihood per E-step and trial %s"
        % json.dumps(rec["histories"]))
    trained = PairHmm.load(model)            # load() checks the rows
    for t in range(len(histories)):
        PairHmm.load("%s.trial%d" % (model, t))
    for name in ("sv_backward", "mw_forward"):
        check(largest[name][1] is False, "%s ran its gap-chain branch with "
              "the trained model" % name)
    check(len(recs) >= 0.95 * EM_READS, "only %d of %d reads aligned"
          % (len(recs), EM_READS))
    placed = sum(
        r.rname == truth[r.qname][0] and bool(r.flag & 16) == truth[r.qname][1]
        and abs(r.pos - 1 - truth[r.qname][2]) <= 64 for r in recs)
    log("em: %d of %d records on their true reference, strand and position; "
        "trained model likelihood %.4f" % (placed, len(recs),
                                           trained.likelihood))
    check(placed >= 0.95 * EM_READS, "too few reads placed correctly")
    return launches, largest, {
        "reads_out": len(recs), "total_s": total,
        "reads_per_s": len(recs) / total, **stages,
        "prepare_em_batches_s": sum(rec["prepare_s"]),
        "counts_pair": pair, "counts_shapes": shapes[pair[0]],
        "likelihood_histories": histories, "placed": placed}


def phase_em_kernels(largest):
    """The four counts kernels on the EM phase's largest E-step batch, then
    again with its first trial's model alone (a serial trial, rows 24 and
    28 of the kernel table: a trials axis of 1), each held against its
    plain version; and S and M on their largest launch with the trained
    model (generic branch)."""
    names = ["sv_backward", "mw_forward"] + COUNTS_KERNELS
    inputs = {"counts": counts_base(largest),
              "sv_backward": largest["sv_backward"],
              "mw_forward": largest["mw_forward"]}
    log("kernels[em] inputs: counts base [Ntr, d1k, Wp, B] %s, S %s, M %s"
        % ([inputs["counts"][0].shape[0]] + list(inputs["counts"][3].shape),
           launch_shape("sv_backward", largest["sv_backward"]),
           launch_shape("mw_forward", largest["mw_forward"])))
    report = compare_kernels("em", names, inputs, 3)
    base = inputs["counts"]
    one = compare_counts(
        (*(t[:1].contiguous() for t in base[:3]), *base[3:]), 3)
    for name, serial in one.items():
        log("kernels[em, one trial] %-15s %s" % (name, json.dumps(serial)))
        report[name]["one_trial"] = serial
    return report


def phase_em_parity(tmpdir, fq, fa):
    """EM + realign of the first PARITY_READS reads on the CPU (plain
    versions) and on the card (kernels); the card's run is the "em_parity"
    path (launch counts reset before it).  Trial 0 starts from the shipped
    model (--useDefaultModelAsStart), so the best trial after
    EM_PARITY_ITERATIONS is a usable aligner.  Trained parameters,
    likelihood histories, guide records and placements are checked.  The
    cigars differ now and then: the two trained models differ by float32
    summation order (~1e-7), and the card's float32 log and exp differ
    from the CPU's in the last bit now and then; either moves gaps between
    placements of equal score in exact arithmetic (shifts inside
    homopolymer runs), which the MEA decode settles by rounding.  So the
    cigars are held as in the REL phase: realigned on both devices with
    the card's model, >= 90% identical, and, with the card's model and
    with each device's own, every cigar that differs an MEA near-tie
    (within 1e-5 relative under the card's weights)."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em, realign
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.utils.seq import encode

    sub = os.path.join(tmpdir, "em_parity.fq")
    subset_fastq(fq, sub, PARITY_READS)
    out, launches = {}, None
    for dev in ("cpu", "cuda"):
        guide = os.path.join(tmpdir, "em_guide_%s.sam" % dev)
        full = os.path.join(tmpdir, "em_full_%s.sam" % dev)
        model = os.path.join(tmpdir, "em_%s.hmm" % dev)
        pipeline.align(sub, fa, guide,
                       pipeline.AlignOptions(no_realign=True, no_chain=True),
                       device=dev)
        opts = pipeline.AlignOptions(
            em=True, output_model_path=model,
            em_options=em.EmOptions(iterations=EM_PARITY_ITERATIONS,
                                    use_default_model_as_start=True,
                                    output_trial_hmms_path=model))
        with recording_launches(COUNTS_KERNELS) as (shapes, _, _), \
                em_recording() as rec:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            stages = pipeline.align(sub, fa, full, opts, device=dev)
            total = time.perf_counter() - t0
            if dev == "cuda":
                launches = dict(_build.launch_counts)
                pair = check_em_counts_policy("em_parity", shapes, launches)
        models = [PairHmm.load(model)] + [
            PairHmm.load("%s.trial%d" % (model, t))
            for t in range(len(rec["histories"][0]))]
        out[dev] = (sam_records(guide), sam_records(full), models,
                    np.array(rec["histories"]))
        log("em parity: device %s %.3f s, stages %s" % (dev, total,
                                                        json.dumps(stages)))
    (gc, fc, mc, hc), (gg, fg, mg, hg) = out["cpu"], out["cuda"]
    check([r.line for r in gc] == [r.line for r in gg],
          "guide records differ between cpu and cuda")
    perr = max(max(np.abs(a.transitions - b.transitions).max(),
                   np.abs(a.emissions - b.emissions).max())
               for a, b in zip(mc, mg))
    herr = float((np.abs(hc - hg) / np.abs(hc)).max())
    check(perr <= 1e-4, "trained parameters differ by %g" % perr)
    check(herr <= 1e-5, "likelihood histories differ by %g (relative)"
          % herr)
    check([(r.qname, r.flag, r.rname, r.pos) for r in fc]
          == [(r.qname, r.flag, r.rname, r.pos) for r in fg],
          "EM-realigned records differ in placement between cpu and cuda")
    # The realignments again, segment by segment: the card with its model
    # (MEA weights kept), the CPU with the card's model ("one") and with its
    # own ("own", what each device's run wrote).
    chained = os.path.join(tmpdir, "em_parity_chained.sam")
    pipeline.align(sub, fa, chained, pipeline.AlignOptions(no_realign=True),
                   device="cuda")
    jobs = realign._jobs_from_sam(SamFile.read(chained),
                                  get_fasta_dictionary(fa), encode)
    segs, origin, _ = realign.split_jobs_at_anchors(
        jobs, realign.DEFAULT_SPLIT_SIZE)
    card_ops, lane_of = ops_with_weights(segs, mg[0], "cuda")
    cpu_ops = {
        model: realign.realigned_ops_for_jobs(segs, hmm, 0.5, 0.0, "cpu")
        for model, hmm in (("one", mg[0]), ("own", mc[0]))}
    wrote = {dev: {r.qname: "".join("%d%s" % (ln, op) for op, ln in r.cigar)
                   for r in recs} for dev, recs in (("cpu", fc),
                                                    ("cuda", fg))}

    def cigar(ops_of, k):
        return "".join("%d%s" % (ln, "MIDNSHP=X"[op])
                       for op, ln in record_cigar(jobs[k], origin, ops_of, k))

    res = {"guide_records": len(gc), "params_max_abs_err": perr,
           "history_max_rel_err": herr, "cigars": len(jobs),
           "counts_pair": pair}
    for model, ops in cpu_ops.items():
        same, worst = 0, 0.0
        for k in range(len(jobs)):
            if cigar(card_ops, k) == cigar(ops, k):
                same += 1
            else:
                worst = max(worst, tie_gap(k, origin, card_ops, ops, lane_of))
        res[model] = {"cigars_identical": same, "near_ties": len(jobs) - same,
                      "worst_tie_relative": worst}
    # The decodes redone here are the ones each device's run wrote.
    res["redone_as_written"] = {
        "cuda": sum(cigar(card_ops, k) == wrote["cuda"].get(j.record.qname)
                    for k, j in enumerate(jobs)),
        "cpu": sum(cigar(cpu_ops["own"], k) == wrote["cpu"].get(
            j.record.qname) for k, j in enumerate(jobs))}
    log("em parity: counts pair on the card %s; trained parameters max abs "
        "difference %g; likelihood histories max relative difference %g; "
        "realigned cigars identical, cpu against cuda, with the card's model "
        "%d of %d, with each device's own %d of %d; the others are MEA "
        "near-ties, worst objective difference under the card's weights "
        "%.3g / %.3g (relative); redone decodes as written %s"
        % (pair, perr, herr, res["one"]["cigars_identical"], len(jobs),
           res["own"]["cigars_identical"], len(jobs),
           res["one"]["worst_tie_relative"],
           res["own"]["worst_tie_relative"],
           json.dumps(res["redone_as_written"])))
    check(res["one"]["cigars_identical"] >= 0.90 * len(jobs),
          "fewer than 90% of cigars identical with one model")
    for model in cpu_ops:
        check(res[model]["worst_tie_relative"] <= 1e-5,
              "a cigar differing between cpu and cuda (%s model) scores %.3g "
              "(relative) off under the card's weights"
              % (model, res[model]["worst_tie_relative"]))
    return launches, res


def phase_generic_kernels(path, base):
    """The generic pair against its plain versions (bit-equal) on a copy of
    the inputs of its largest launch on `path`, with times and bounds."""
    log("kernels[%s] inputs of the largest launch [d1k, Wp, B] %s"
        % (path, list(base[3].shape)))
    return compare_kernels(path, GENERIC_KERNELS, {"generic": base}, 5)


def placement(recs):
    """{qname: (flag, reference, 1-based position)} of SAM records."""
    return {r.qname: (r.flag, r.rname, r.pos) for r in recs}


def phase_generic(tmpdir, fq, fa, main_sam, trial_model):
    """marginAlign --inputModel <trial 0 of the card's EM parity run>
    (un-normalised: its gap emissions are not flat) on the corpus's first
    REL_RECORDS reads: the guide through R and K1, then realignment on the
    REL path (host band arrays, the generic pair, weight bands, K4).  Only
    those kernels may launch, and every record is placed as in the main
    phase.  The EM phase's own trial 0 (5 iterations from a random start)
    is no usable aligner yet: it aligns with gaps everywhere, so its MEA
    decodes are exact ties that each device's rounding breaks its own
    way."""
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.ops.fb import tables_from_hmm
    from marginalign_trna_tpu_torch.ops.fb_cuda import has_flat_gap_emissions

    hmm = PairHmm.load(trial_model)
    check(not has_flat_gap_emissions(tables_from_hmm(hmm)),
          "the trial 0 model has flat gap emissions")
    sub = os.path.join(tmpdir, "generic_subset.fq")
    subset_fastq(fq, sub, REL_RECORDS)
    out = os.path.join(tmpdir, "generic.sam")
    names = (["banded_nw", "expand_rel", "nw_moves"] + MOVES_AFTER_K4
             + GENERIC_KERNELS)
    with recording_launches(names) as (shapes, largest, host), \
            counting_host_tracebacks() as seen:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stages = pipeline.align(sub, fa, out,
                                pipeline.AlignOptions(input_model=hmm),
                                device="cuda")
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    recs = sam_records(out)
    log("generic: %d reads in, %d records out, %.3f s; stages %s; host "
        "band packer %d calls, %.3f s (%.1f%% of the wall)"
        % (REL_RECORDS, len(recs), total, json.dumps(stages),
           host["pack_banded_batch"], host["pack_banded_batch_s"],
           100 * host["pack_banded_batch_s"] / total))
    log("generic: launches %s" % json.dumps(launches))
    log("generic: launch shapes %s" % json.dumps(shapes))
    check_launches("generic", names, launches, shapes)
    check_no_host_tracebacks("generic", seen)
    check(len(recs) == REL_RECORDS, "generic: %d of %d reads aligned"
          % (len(recs), REL_RECORDS))
    main = placement(sam_records(main_sam))
    moved = [q for q, p in placement(recs).items() if main[q] != p]
    check(not moved, "generic: records placed otherwise than in the main "
          "phase: %s" % moved[:5])
    return out, launches, largest, {
        "records": len(recs), "total_s": total, **stages,
        "pack_banded_batch_s": host["pack_banded_batch_s"],
        "pack_banded_batch_share": host["pack_banded_batch_s"] / total}


def phase_generic_caller(tmpdir, fa, sam, trial_model):
    """marginCaller --alignmentModel <trial 0> on the generic phase's SAM
    against the caller phase's mutated reference: band arrays, the generic
    pair and band_expectations; only the generic pair may launch.  Recall
    and precision on the planted SNVs are printed, not checked (the model
    is a trial's, not the trained one).  Returns (mutated reference,
    launches, the generic pair's largest-launch inputs, results)."""
    import torch

    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.vcf import vcf_read
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    mut_fa, planted = write_mutated_reference(tmpdir, fa)
    vcf = os.path.join(tmpdir, "generic_calls.vcf")
    hmm, error = PairHmm.load(trial_model), PairHmm.load(DEFAULT_MODEL)
    with recording_launches(GENERIC_KERNELS) as (shapes, largest, host):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        calls = caller.margin_caller(sam, mut_fa, vcf, hmm, error,
                                     device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    found = vcf_read(vcf)
    hit = len(found & planted)
    res = {"records_in": len(sam_records(sam)), "calls": len(calls),
           "total_s": total, "recall": hit / len(planted),
           "precision": hit / max(len(found), 1),
           "pack_banded_batch_s": host["pack_banded_batch_s"]}
    log("caller generic: %s; launches %s; launch shapes %s"
        % (json.dumps(res), json.dumps(launches), json.dumps(shapes)))
    check_launches("caller_generic", GENERIC_KERNELS, launches, shapes)
    return mut_fa, launches, generic_base(largest), res


def phase_generic_parity(tmpdir, fq, fa, sam, mut_fa, trial_model):
    """The generic realignment and caller on PARITY_READS reads / records,
    on the CPU (plain versions) and on the card (kernels): realigned
    segment by segment, >= 90% of cigars identical and every other one an
    MEA near-tie (within 1e-5 relative under the card's weights); the
    caller's call sets identical, expectations within 1e-3."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL
    from marginalign_trna_tpu_torch.utils.seq import encode

    hmm = PairHmm.load(trial_model)
    sub = os.path.join(tmpdir, "generic_parity.fq")
    subset_fastq(fq, sub, PARITY_READS)
    chained = os.path.join(tmpdir, "generic_parity_chained.sam")
    pipeline.align(sub, fa, chained, pipeline.AlignOptions(no_realign=True),
                   device="cuda")
    jobs = realign._jobs_from_sam(SamFile.read(chained),
                                  get_fasta_dictionary(fa), encode)
    segs, origin, _ = realign.split_jobs_at_anchors(
        jobs, realign.DEFAULT_SPLIT_SIZE)
    t0 = time.perf_counter()
    card_ops, lane_of = ops_with_weights(segs, hmm, "cuda")
    t1 = time.perf_counter()
    cpu_ops = realign.realigned_ops_for_jobs(segs, hmm, 0.5, 0.0, "cpu")
    t2 = time.perf_counter()
    same, worst = 0, 0.0
    for k, job in enumerate(jobs):
        if (record_cigar(job, origin, card_ops, k)
                == record_cigar(job, origin, cpu_ops, k)):
            same += 1
        else:
            worst = max(worst, tie_gap(k, origin, card_ops, cpu_ops,
                                       lane_of))

    sub_sam = SamFile.read(sam)
    sub_sam.records = sub_sam.records[:PARITY_READS]
    path = os.path.join(tmpdir, "generic_caller_subset.sam")
    sub_sam.write(path)
    refs = get_fasta_dictionary(mut_fa)
    error = PairHmm.load(DEFAULT_MODEL)
    exp, calls = {}, {}
    for dev in ("cpu", "cuda"):
        exp[dev] = caller.accumulate_expectations(
            SamFile.read(path), refs, hmm, caller.CallerOptions(),
            device=dev)
        calls[dev] = {c[:3] for c in caller.call_variants(
            exp[dev], refs, error, caller.DEFAULT_THRESHOLD)}
    err = max(float(np.abs(exp["cpu"][k] - exp["cuda"][k]).max())
              for k in refs)
    res = {"records": len(jobs), "segments": len(segs),
           "cigars_identical": same, "near_ties": len(jobs) - same,
           "worst_tie_relative": worst, "realign_cuda_s": t1 - t0,
           "realign_cpu_s": t2 - t1, "caller_records": len(sub_sam.records),
           "calls": len(calls["cuda"]), "expectations_max_abs_err": err}
    log("generic parity: %s" % json.dumps(res))
    check(same >= 0.90 * len(jobs), "generic: fewer than 90% of cigars "
          "identical between cpu and cuda")
    check(worst <= 1e-5, "generic: a cigar differing between cpu and cuda "
          "scores %.3g (relative) off under the card's weights" % worst)
    check(calls["cpu"] == calls["cuda"], "generic: call sets differ between "
          "cpu and cuda")
    check(err <= 1e-3, "generic: expectations differ by %g between cpu and "
          "cuda" % err)
    return res


def phase_band(tmpdir, fq, fa, truth):
    """marginAlign --em --updateTheBand on the corpus's first BAND_READS
    reads (BAND_ITERATIONS iterations, 3 lockstep trials): after every
    iteration the best trial's model realigns the training segments on the
    REL path (the generic pair, K4) and the E-step batches are re-packed.
    Only the policy's counts pair, the generic pair, K4 and the main path's
    kernels may launch; every band update launches the generic pair; the
    reads are placed.  Likelihoods are not held to rise: a band change
    moves them (marginalign_trna_tpu/align/em.py:475-478).  Returns
    (launches, the generic pair's largest-launch inputs, results)."""
    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.ops import _build

    sub = os.path.join(tmpdir, "band_subset.fq")
    subset_fastq(fq, sub, BAND_READS)
    out = os.path.join(tmpdir, "band.sam")
    opts = pipeline.AlignOptions(em=True, em_options=em.EmOptions(
        iterations=BAND_ITERATIONS, update_band_every=1))
    names = ALIGN_KERNELS + COUNTS_KERNELS + GENERIC_KERNELS + ["banded_mea"]
    with recording_launches(names) as (shapes, largest, host), \
            em_recording() as rec, counting_host_tracebacks() as seen:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stages = pipeline.align(sub, fa, out, opts, device="cuda")
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    recs = sam_records(out)
    updates = [u["generic_launches"] for u in rec["band_updates"]]
    res = {"reads_out": len(recs), "total_s": total, **stages,
           "band_updates": len(updates),
           "generic_launches_per_update": updates,
           "band_update_s": [u["s"] for u in rec["band_updates"]],
           "prepare_em_batches_s": rec["prepare_s"],
           "pack_banded_batch_s": host["pack_banded_batch_s"],
           "likelihood_histories": rec["histories"]}
    log("em band: %s" % json.dumps(res))
    log("em band: launches %s; launch shapes %s"
        % (json.dumps(launches), json.dumps(shapes)))
    pair = check_em_counts_policy("em_band", shapes, launches)
    check_launches("em_band", ALIGN_KERNELS + pair + GENERIC_KERNELS
                   + ["banded_mea"], launches, shapes)
    check_no_host_tracebacks("em_band", seen)
    check(updates and all(n >= 1 for n in updates),
          "em band: a band update without the generic pair")
    check(sum(updates) == launches["fb_generic_fwd"],
          "em band: generic launches outside the band updates")
    placed = sum(
        r.rname == truth[r.qname][0] and bool(r.flag & 16) == truth[r.qname][1]
        and abs(r.pos - 1 - truth[r.qname][2]) <= 64 for r in recs)
    res["placed"] = placed
    check(placed == BAND_READS, "em band: %d of %d reads placed"
          % (placed, BAND_READS))
    return launches, generic_base(largest), res


def phase_band_parity(tmpdir, fq, fa):
    """EM with update_band_every=1 (3 iterations, trial 0 from the shipped
    model so that the band follows a usable aligner) on the chained records
    of the first BAND_PARITY_READS reads, on the CPU and on the card: the
    trained parameters within 1e-3; the segment paths of the last band
    update that differ between the devices are counted."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em, realign
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.utils.seq import encode

    sub = os.path.join(tmpdir, "band_parity.fq")
    subset_fastq(fq, sub, BAND_PARITY_READS)
    chained = os.path.join(tmpdir, "band_parity_chained.sam")
    pipeline.align(sub, fa, chained, pipeline.AlignOptions(no_realign=True),
                   device="cuda")
    jobs = realign._jobs_from_sam(SamFile.read(chained),
                                  get_fasta_dictionary(fa), encode)
    opts = em.EmOptions(iterations=BAND_ITERATIONS, update_band_every=1,
                        use_default_model_as_start=True)
    shipped = PairHmm.load(pipeline.DEFAULT_MODEL)
    out = {}
    for dev in ("cpu", "cuda"):
        with em_recording() as rec:
            t0 = time.perf_counter()
            best = em.train_em(jobs, opts, input_hmm=shipped, device=dev)
            wall = time.perf_counter() - t0
        out[dev] = (best, rec["band_updates"][-1]["paths"],
                    np.array(rec["histories"]), wall)
    (bc, pc, hc, wc), (bg, pg, hg, wg) = out["cpu"], out["cuda"]
    perr = max(np.abs(bc.hmm.transitions - bg.hmm.transitions).max(),
               np.abs(bc.hmm.emissions - bg.hmm.emissions).max())
    differ = sum(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                 for a, b in zip(pc, pg))
    res = {"segments": len(pg), "paths_differing": differ,
           "params_max_abs_err": float(perr),
           "history_max_rel_err": float((np.abs(hc - hg) / np.abs(hc)).max()),
           "cpu_s": wc, "cuda_s": wg}
    log("em band parity: %s" % json.dumps(res))
    check(len(pc) == len(pg), "em band parity: segment counts differ")
    check(perr <= 1e-3, "em band parity: trained parameters differ by %g"
          % perr)
    return res


def largest_of(largest, more):
    """Merge the recorded largest launches `more` into `largest`."""
    import numpy as np

    for name, args in more.items():
        if name not in largest or (
                np.prod(launch_shape(name, args))
                > np.prod(launch_shape(name, largest[name]))):
            largest[name] = args


def phase_serve(tmpdir, fa, main_sam, rel):
    """The unfused circular serving route (serve=<mode>) in each mode of
    SERVE_KERNELS, after the REL phase (`rel`: its chained SAM, jobs,
    segments, segment ops and the fused weights).  Per mode:
    realign_sam_file(..., serve=mode) on the REL phase's chained records
    (only the mode's serving kernels and K4 may launch; every record placed
    as in the REL phase; >= 90% of cigars equal to the REL phase's and
    every other one an MEA near-tie of it within 1e-5 under the fused
    weights), then margin_caller(..., serve=mode) on the main SAM's records
    of those reads against the caller phase's mutated reference (only the
    mode's serving kernels; the fused caller's call set, expectations
    within 1e-3).  Returns ({path: launches}, the serving kernels' largest
    launch inputs over the modes' realign runs and over their caller runs
    ({"serve_realign": {name: inputs}, "serve_call": ...}), results)."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    hmm = PairHmm.load(DEFAULT_MODEL)
    jobs, origin = rel["jobs"], rel["origin"]
    sam = SamFile.read(main_sam)
    names = {j.record.qname for j in jobs}
    sam.records = [r for r in sam.records if r.qname in names]
    call_sam = os.path.join(tmpdir, "serve_caller.sam")
    sam.write(call_sam)
    mut_fa, _ = write_mutated_reference(tmpdir, fa)
    refs = get_fasta_dictionary(mut_fa)
    t0 = time.perf_counter()
    fused_exp = caller.accumulate_expectations(
        SamFile.read(call_sam), refs, hmm, caller.CallerOptions(),
        device="cuda")
    fused_calls = {c[:3] for c in caller.call_variants(
        fused_exp, refs, hmm, caller.DEFAULT_THRESHOLD)}
    res = {"records": len(jobs), "caller_records": len(sam.records),
           "fused_caller_s": time.perf_counter() - t0,
           "fused_calls": len(fused_calls)}
    by_path, largest = {}, {"serve_realign": {}, "serve_call": {}}
    ops_fn, exp_fn = (realign.realigned_ops_for_jobs,
                      caller.accumulate_expectations)
    for mode, kernels in SERVE_KERNELS.items():
        seg_ops, exps = [], []

        def keep_ops(jobs_, *args, **kwargs):
            # The call on the anchor segments (the inner one if any job
            # was split) returns the segments' ops.
            out = ops_fn(jobs_, *args, **kwargs)
            if len(jobs_) == len(rel["segs"]):
                seg_ops.append(out)
            return out

        def keep_exp(*args, **kwargs):
            exps.append(exp_fn(*args, **kwargs))
            return exps[-1]

        out = os.path.join(tmpdir, "serve_%s.sam" % mode)
        vcf = os.path.join(tmpdir, "serve_%s.vcf" % mode)
        runs = {}
        for path, run in (
                ("serve_realign_" + mode, lambda: realign.realign_sam_file(
                    rel["chained"], out, None, fa, hmm, "cuda",
                    no_chain=True, serve=mode)),
                ("serve_call_" + mode, lambda: caller.margin_caller(
                    call_sam, mut_fa, vcf, hmm, hmm, device="cuda",
                    serve=mode))):
            with recording_launches(list(KERNELS)) as (shapes, rec, host), \
                    replaced_everywhere({ops_fn: keep_ops,
                                         exp_fn: keep_exp}), \
                    counting_host_tracebacks() as seen:
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                value = run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                by_path[path] = dict(_build.launch_counts)
            allowed = kernels + (MOVES_AFTER_K4 if "realign" in path else [])
            check_no_host_tracebacks(path, seen)
            log("%s: %.3f s; launches %s; launch shapes %s; host band "
                "packer %d calls, %.3f s"
                % (path, wall, json.dumps({k: n for k, n in
                                           by_path[path].items() if n}),
                   json.dumps({k: v for k, v in shapes.items() if v}),
                   host["pack_banded_batch"], host["pack_banded_batch_s"]))
            check_launches(path, allowed, by_path[path], shapes)
            largest_of(largest[path.rsplit("_", 1)[0]],
                       {k: v for k, v in rec.items() if k in SERVE_NEW})
            runs[path] = (value, wall, host["pack_banded_batch_s"])

        check(seg_ops, "serve %s: the segments differ from the REL phase's"
              % mode)
        ops = seg_ops[-1]
        recs = sam_records(out)
        want = placement(sam_records(rel["chained"]))
        check(len(recs) == len(jobs), "serve %s: %d records out of %d"
              % (mode, len(recs), len(jobs)))
        moved = [q for q, p in placement(recs).items() if want[q] != p]
        check(not moved, "serve %s: records placed otherwise than in the REL "
              "phase: %s" % (mode, moved[:5]))
        same, worst = 0, 0.0
        for k, job in enumerate(jobs):
            if (record_cigar(job, origin, ops, k)
                    == record_cigar(job, origin, rel["rel_ops"], k)):
                same += 1
            else:
                worst = max(worst, tie_gap(k, origin, ops, rel["rel_ops"],
                                           rel["lane_of"]))
        calls = {c[:3] for c in runs["serve_call_" + mode][0]}
        err = max(float(np.abs(exps[0][k] - fused_exp[k]).max())
                  for k in refs)
        res[mode] = {
            "realign_s": runs["serve_realign_" + mode][1],
            "realign_pack_banded_batch_s": runs["serve_realign_" + mode][2],
            "cigars_equal_rel": same, "near_ties": len(jobs) - same,
            "worst_tie_relative": worst,
            "caller_s": runs["serve_call_" + mode][1],
            "caller_pack_banded_batch_s": runs["serve_call_" + mode][2],
            "calls": len(calls), "calls_equal_fused": calls == fused_calls,
            "expectations_max_abs_err": err}
        log("serve %s: %s" % (mode, json.dumps(res[mode])))
        check(same >= 0.90 * len(jobs), "serve %s: fewer than 90%% of cigars "
              "equal to the REL phase's" % mode)
        check(worst <= 1e-5, "serve %s: a cigar scores %.3g (relative) off "
              "the REL phase's under the fused weights" % (mode, worst))
        check(calls == fused_calls, "serve %s: call set differs from the "
              "fused caller's" % mode)
        check(err <= 1e-3, "serve %s: expectations differ by %g from the "
              "fused caller's" % (mode, err))
    return by_path, largest, res


def phase_serve_parity(tmpdir, fq, fa, main_sam):
    """The serving route on PARITY_READS reads / records for each mode of
    SERVE_PARITY_MODES, on the CPU (plain versions) and on the card
    (kernels): realigned segment by segment, >= 90% of cigars identical and
    every other one an MEA near-tie (within 1e-5 relative under the card's
    weights); the caller's call sets identical, expectations within 1e-3."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import realign
    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.utils.seq import encode

    hmm = PairHmm.load(pipeline.DEFAULT_MODEL)
    sub = os.path.join(tmpdir, "serve_parity.fq")
    subset_fastq(fq, sub, PARITY_READS)
    chained = os.path.join(tmpdir, "serve_parity_chained.sam")
    pipeline.align(sub, fa, chained, pipeline.AlignOptions(no_realign=True),
                   device="cuda")
    jobs = realign._jobs_from_sam(SamFile.read(chained),
                                  get_fasta_dictionary(fa), encode)
    segs, origin, _ = realign.split_jobs_at_anchors(
        jobs, realign.DEFAULT_SPLIT_SIZE)
    sam = SamFile.read(main_sam)
    sam.records = sam.records[:PARITY_READS]
    path = os.path.join(tmpdir, "serve_caller_subset.sam")
    sam.write(path)
    mut_fa, _ = write_mutated_reference(tmpdir, fa)
    refs = get_fasta_dictionary(mut_fa)
    res = {}
    for mode in SERVE_PARITY_MODES:
        t0 = time.perf_counter()
        card_ops, lane_of = ops_with_weights(segs, hmm, "cuda", serve=mode)
        t1 = time.perf_counter()
        cpu_ops = realign.realigned_ops_for_jobs(segs, hmm, 0.5, 0.0, "cpu",
                                                 serve=mode)
        t2 = time.perf_counter()
        same, worst = 0, 0.0
        for k, job in enumerate(jobs):
            if (record_cigar(job, origin, card_ops, k)
                    == record_cigar(job, origin, cpu_ops, k)):
                same += 1
            else:
                worst = max(worst, tie_gap(k, origin, card_ops, cpu_ops,
                                           lane_of))
        exp, calls = {}, {}
        for dev in ("cpu", "cuda"):
            exp[dev] = caller.accumulate_expectations(
                SamFile.read(path), refs, hmm, caller.CallerOptions(),
                device=dev, serve=mode)
            calls[dev] = {c[:3] for c in caller.call_variants(
                exp[dev], refs, hmm, caller.DEFAULT_THRESHOLD)}
        err = max(float(np.abs(exp["cpu"][k] - exp["cuda"][k]).max())
                  for k in refs)
        res[mode] = {"records": len(jobs), "segments": len(segs),
                     "cigars_identical": same, "near_ties": len(jobs) - same,
                     "worst_tie_relative": worst, "realign_cuda_s": t1 - t0,
                     "realign_cpu_s": t2 - t1,
                     "caller_records": len(sam.records),
                     "calls": len(calls["cuda"]),
                     "expectations_max_abs_err": err}
        log("serve parity %s: %s" % (mode, json.dumps(res[mode])))
        check(same >= 0.90 * len(jobs), "serve parity %s: fewer than 90%% of "
              "cigars identical between cpu and cuda" % mode)
        check(worst <= 1e-5, "serve parity %s: a cigar differing between cpu "
              "and cuda scores %.3g (relative) off under the card's weights"
              % (mode, worst))
        check(calls["cpu"] == calls["cuda"], "serve parity %s: call sets "
              "differ between cpu and cuda" % mode)
        check(err <= 1e-3, "serve parity %s: expectations differ by %g "
              "between cpu and cuda" % (mode, err))
    return res


def write_trna_corpus(tmpdir, n_reads, n_refs, seed=23):
    """A synthetic direct-tRNA corpus in the shape of benchmarks/trna.py:
    n_refs references of 70-90 nt; each read (60-150 nt) a fragment of its
    reference when shorter than it, else the whole reference with the
    surplus inserted at one place, with ~12% substitutions and up to two
    1-2 base indels, every other one reverse-complemented.  Returns
    (fastq, fasta, truth {name: (ref, reverse)})."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    refs = [rng.integers(0, 4, int(rng.integers(70, 91)))
            for _ in range(n_refs)]
    fa = os.path.join(tmpdir, "trna.fa")
    with open(fa, "w") as fh:
        for i, r in enumerate(refs):
            fh.write(">tRNA%d\n%s\n" % (i, "".join(bases[r])))
    fq = os.path.join(tmpdir, "trna.fq")
    truth = {}
    with open(fq, "w") as fh:
        for k in range(n_reads):
            ri = int(rng.integers(0, n_refs))
            ref = refs[ri]
            length = int(rng.integers(60, 151))
            if length <= len(ref):
                start = int(rng.integers(0, len(ref) - length + 1))
                y = ref[start:start + length].copy()
            else:
                pos = int(rng.integers(0, len(ref)))
                y = np.concatenate([ref[:pos],
                                    rng.integers(0, 4, length - len(ref)),
                                    ref[pos:]])
            subs = rng.random(len(y)) < 0.12
            y[subs] = (y[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
            for _ in range(int(rng.integers(0, 3))):
                at = int(rng.integers(5, len(y) - 5))
                n = int(rng.integers(1, 3))
                y = (np.delete(y, range(at, at + n)) if rng.random() < 0.5
                     else np.insert(y, at, rng.integers(0, 4, n)))
            reverse = k % 2 == 1
            if reverse:
                y = (3 - y)[::-1]
            seq = "".join(bases[y])
            fh.write("@t%d\n%s\n+\n%s\n" % (k, seq, "I" * len(seq)))
            truth["t%d" % k] = ("tRNA%d" % ri, reverse)
    return fq, fa, truth


def aligned_ops(cigar):
    """The M / I / D runs of a SamLine cigar as [(op, len)]."""
    code = {"M": 0, "I": 1, "D": 2}
    return [(code[op], ln) for op, ln in cigar if op in code]


def dense_objective(ops, post, gap_gamma=0.5):
    """The MEA objective of aligned ops over one problem's dense posterior
    [m, n] (ops/band.py `unpack_problem`): the posterior of every matched
    pair, gap_gamma * clip(1 - row / column mass) of every skipped read /
    reference position; float64 on the host."""
    import numpy as np

    g_read = gap_gamma * np.clip(1.0 - post.sum(axis=1, dtype=np.float64),
                                 0.0, 1.0)
    g_ref = gap_gamma * np.clip(1.0 - post.sum(axis=0, dtype=np.float64),
                                0.0, 1.0)
    i = j = 0
    total = 0.0
    for op, ln in ops:
        for _ in range(ln):
            if op == 0:
                total += float(post[i, j])
                i, j = i + 1, j + 1
            elif op == 1:
                total += float(g_read[i])
                i += 1
            else:
                total += float(g_ref[j])
                j += 1
    return total


def multi_tie_gaps(recs, other, mb, post):
    """(equal, [relative objective gap of each record whose cigar differs])
    between two realignments of the same records in the same order, scored
    under the posterior band `post` (host) of the multi-lane batch `mb`
    that realigned `recs` (record k is its problem k)."""
    from marginalign_trna_tpu_torch.ops.band import unpack_problem

    check([(r.qname, r.flag, r.rname, r.pos) for r in recs]
          == [(r.qname, r.flag, r.rname, r.pos) for r in other],
          "multi: records placed differently by the two runs")
    check(len(mb.problems) == len(recs), "multi: %d problems for %d records"
          % (len(mb.problems), len(recs)))
    same, gaps = 0, []
    for k, (a, b) in enumerate(zip(recs, other)):
        if a.cigar == b.cigar:
            same += 1
            continue
        dense = unpack_problem(post, mb, k)
        f = dense_objective(aligned_ops(a.cigar), dense)
        r = dense_objective(aligned_ops(b.cigar), dense)
        gaps.append(abs(f - r) / max(abs(f), 1.0))
    return same, gaps


@contextlib.contextmanager
def multi_recording(guide_copy=None):
    """Inside the block the guide's SAM is copied to `guide_copy` (if
    given) when it is written (align/guide.py `map_reads`), and every
    multi-lane batch (ops/band.py `pack_multi_banded_batch`, with the host
    seconds spent packing it) and the posterior band of every
    `posteriors_multi` call are kept.  Yields {"packs": [...], "pack_s":
    seconds, "posts": [...]}."""
    from marginalign_trna_tpu_torch.align import guide
    from marginalign_trna_tpu_torch.ops import band, fb_multi_cuda

    kept = {"packs": [], "pack_s": 0.0, "posts": []}
    map_reads, pack = guide.map_reads, band.pack_multi_banded_batch
    posteriors = fb_multi_cuda.posteriors_multi

    def keep_guide(fq, fa, out, *args, **kwargs):
        map_reads(fq, fa, out, *args, **kwargs)
        if guide_copy:
            shutil.copy(out, guide_copy)

    def keep_pack(*args, **kwargs):
        t0 = time.perf_counter()
        kept["packs"].append(pack(*args, **kwargs))
        kept["pack_s"] += time.perf_counter() - t0
        return kept["packs"][-1]

    def keep_post(tables, mdev):
        logZ, post = posteriors(tables, mdev)
        kept["posts"].append(post)
        return logZ, post

    with replaced_everywhere({map_reads: keep_guide, pack: keep_pack,
                              posteriors: keep_post}):
        yield kept


def padded_cells(shapes, name):
    """Band cells over every recorded launch of kernel `name`."""
    import numpy as np

    return int(sum(np.prod(s) for s in shapes[name]))


def phase_multi(tmpdir):
    """marginAlign on the synthetic tRNA corpus with multi=True (only the
    four multi-lane kernels), then on the default single-lane path; guide
    records identical, placements on the simulated reference and strand,
    cigars equal or MEA near-ties under the multi run's posteriors.
    Returns (launches, largest launch inputs, results)."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.ops import _build

    fq, fa, truth = write_trna_corpus(tmpdir, TRNA_READS, TRNA_REFS)
    runs = {}
    for tag, multi in (("multi", True), ("single", False)):
        out = os.path.join(tmpdir, "trna_%s.sam" % tag)
        guide_sam = os.path.join(tmpdir, "trna_%s_guide.sam" % tag)
        with recording_launches(list(KERNELS)) as (shapes, largest, host), \
                multi_recording(guide_sam) as kept:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            stages = pipeline.align(fq, fa, out, device="cuda", multi=multi)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
        recs = sam_records(out)
        log("multi[%s]: %d reads in, %d records out, %.3f s, %.2f reads/s; "
            "stages %s; launches %s; launch shapes %s"
            % (tag, TRNA_READS, len(recs), total, len(recs) / total,
               json.dumps(stages),
               json.dumps({k: n for k, n in launches.items() if n}),
               json.dumps({k: v for k, v in shapes.items() if v})))
        runs[tag] = {"recs": recs, "guide": sam_records(guide_sam),
                     "stages": stages, "total": total, "launches": launches,
                     "shapes": shapes, "largest": largest, "kept": kept}
    m, single = runs["multi"], runs["single"]
    check_launches("multi", MULTI_KERNELS, m["launches"], m["shapes"])
    check_launches("single-lane tRNA", ALIGN_KERNELS, single["launches"],
                   single["shapes"])
    check(len(m["kept"]["packs"]) == 2 and len(m["kept"]["posts"]) == 1,
          "multi: expected one guide and one realign batch")
    guide_mb, realign_mb = m["kept"]["packs"]

    recs = m["recs"]
    placed = sum((r.rname, bool(r.flag & 16)) == truth[r.qname]
                 for r in recs)
    log("multi: %d of %d reads mapped; %d of those on their simulated "
        "reference and strand" % (len(recs), TRNA_READS, placed))
    check(len(recs) >= 0.80 * TRNA_READS, "multi: only %d of %d reads mapped"
          % (len(recs), TRNA_READS))
    check(placed >= 0.95 * len(recs), "multi: fewer than 95% of records on "
          "their simulated reference and strand")
    check([r.line for r in m["guide"]] == [r.line for r in single["guide"]],
          "multi: guide records differ from the single-lane path's")
    post = m["kept"]["posts"][0].cpu().numpy()
    same, gaps = multi_tie_gaps(recs, single["recs"], realign_mb, post)
    worst = max(gaps, default=0.0)
    log("multi: %d of %d realigned cigars equal to the single-lane path's; "
        "the other %d are MEA near-ties, worst objective difference %.3g "
        "(relative, under the multi run's posteriors)"
        % (same, len(recs), len(gaps), worst))
    check(same >= MULTI_MIN_EQUAL * len(recs), "multi: fewer than %d%% of "
          "cigars equal to the single-lane path's" % (100 * MULTI_MIN_EQUAL))
    check(worst <= 1e-5, "multi: a cigar scores %.3g (relative) off the "
          "single-lane path's" % worst)

    valid = {"guide": int(guide_mb.valid.sum()),
             "realign": int(realign_mb.valid.sum())}
    cells = {
        "multi": {"guide": padded_cells(m["shapes"], "nw_multi"),
                  "realign": padded_cells(m["shapes"], "fb_multi_forward")},
        "single": {"guide": padded_cells(single["shapes"], "banded_nw"),
                   "realign": padded_cells(single["shapes"],
                                           "sv_backward")},
    }
    res = {"reads_in": TRNA_READS, "references": TRNA_REFS,
           "records_out": len(recs), "placed": placed,
           "cigars_equal_single": same, "near_ties": len(gaps),
           "worst_tie_relative": worst, "valid_cells": valid}
    for tag, run in runs.items():
        res[tag] = {"total_s": run["total"],
                    "reads_per_s": len(run["recs"]) / run["total"],
                    **run["stages"],
                    "pack_multi_banded_batch_s": run["kept"]["pack_s"],
                    "padded_cells": cells[tag],
                    "valid_share": {k: valid[k] / max(cells[tag][k], 1)
                                    for k in valid}}
    log("multi: %s" % json.dumps(res))
    return m["launches"], m["largest"], res


def phase_call_multi(tmpdir, sam, mut_fa):
    """marginCaller with multi=True on the main phase's SAM's first
    CALL_MULTI_RECORDS records against the caller phase's mutated
    reference (split 100): only the FB multi pair
    launches; the fused caller's call set on the same records, and every
    position's expectations within 3e-4 of its coverage (the fused
    caller's expected count over the four bases) of the fused caller's.
    The multi-lane posteriors carry the float32 noise of their lane-long
    log-scale sums (the JAX package's arithmetic), which adds up with
    coverage: the JAX package holds its multi-lane posteriors within 3e-4
    of its single-lane ones (tests/test_multi.py), and each read adds at
    most its posterior to a position's expectations.  A CPU run of 256
    600-base reads (coverage up to 131) put them 1.5e-3 apart, 3.9e-5 of
    the coverage.  Returns (launches, largest launch inputs, results)."""
    import numpy as np
    import torch

    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build
    from marginalign_trna_tpu_torch.pipeline import DEFAULT_MODEL

    hmm = PairHmm.load(DEFAULT_MODEL)
    refs = get_fasta_dictionary(mut_fa)
    sub_sam = SamFile.read(sam)
    sub_sam.records = sub_sam.records[:CALL_MULTI_RECORDS]
    sam = os.path.join(tmpdir, "call_multi_records.sam")
    sub_sam.write(sam)
    exps = []
    acc = caller.accumulate_expectations

    def keep_exp(*args, **kwargs):
        exps.append(acc(*args, **kwargs))
        return exps[-1]

    vcf = os.path.join(tmpdir, "calls_multi.vcf")
    with recording_launches(list(KERNELS)) as (shapes, largest, host), \
            replaced_everywhere({acc: keep_exp}), multi_recording() as kept:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        calls = caller.margin_caller(sam, mut_fa, vcf, hmm, hmm,
                                     device="cuda", multi=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    log("call_multi: %.3f s; launches %s; launch shapes %s"
        % (total, json.dumps({k: n for k, n in launches.items() if n}),
           json.dumps({k: v for k, v in shapes.items() if v})))
    check_launches("call_multi", CALL_MULTI_KERNELS, launches, shapes)
    t0 = time.perf_counter()
    fused = caller.accumulate_expectations(
        SamFile.read(sam), refs, hmm, caller.CallerOptions(), device="cuda")
    fused_s = time.perf_counter() - t0
    fused_calls = {c[:3] for c in caller.call_variants(
        fused, refs, hmm, caller.DEFAULT_THRESHOLD)}
    got = {c[:3] for c in calls}
    err = max(float(np.abs(exps[0][k] - fused[k]).max()) for k in refs)
    rel = max(float((np.abs(exps[0][k] - fused[k]) / np.maximum(
        fused[k].sum(axis=1, keepdims=True), 1.0)).max()) for k in refs)
    res = {"records": len(sam_records(sam)), "total_s": total,
           "pack_multi_banded_batch_s": kept["pack_s"],
           "problems": len(kept["packs"][0].problems),
           "fused_expectations_s": fused_s, "calls": len(got),
           "calls_equal_fused": got == fused_calls,
           "expectations_max_abs_err": err,
           "expectations_max_err_per_coverage": rel,
           "max_coverage": max(float(fused[k].sum(axis=1).max())
                               for k in refs)}
    log("call_multi: %s" % json.dumps(res))
    check(got == fused_calls, "call_multi: call set differs from the fused "
          "caller's")
    check(rel <= 3e-4, "call_multi: expectations differ by %g of the "
          "coverage from the fused caller's" % rel)
    return launches, largest, res


def phase_multi_parity(tmpdir, sam, mut_fa):
    """multi=True on PARITY_READS tRNA reads (pipeline.align) and on the
    main SAM's first PARITY_READS records (margin_caller, split 100) on the
    CPU (plain versions) and on the card (kernels): guide records and
    placements identical, >= MULTI_MIN_EQUAL of cigars identical and every
    other one an MEA near-tie (1e-5 relative under the card's posteriors);
    identical call sets, expectations within 1e-3."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.call import caller
    from marginalign_trna_tpu_torch.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu_torch.io.sam import SamFile
    from marginalign_trna_tpu_torch.models.hmm import PairHmm

    sub = os.path.join(tmpdir, "trna_parity.fq")
    subset_fastq(os.path.join(tmpdir, "trna.fq"), sub, PARITY_READS)
    fa = os.path.join(tmpdir, "trna.fa")
    runs = {}
    for dev in ("cpu", "cuda"):
        out = os.path.join(tmpdir, "trna_parity_%s.sam" % dev)
        guide_sam = os.path.join(tmpdir, "trna_parity_%s_guide.sam" % dev)
        t0 = time.perf_counter()
        with multi_recording(guide_sam) as kept:
            pipeline.align(sub, fa, out, device=dev, multi=True)
        runs[dev] = (sam_records(guide_sam), sam_records(out), kept,
                     time.perf_counter() - t0)
    (gc, rc, _, tc), (gg, rg, kept, tg) = runs["cpu"], runs["cuda"]
    check([r.line for r in gc] == [r.line for r in gg],
          "multi parity: guide records differ between cpu and cuda")
    same, gaps = multi_tie_gaps(rg, rc, kept["packs"][1],
                                kept["posts"][0].cpu().numpy())
    worst = max(gaps, default=0.0)
    path = os.path.join(tmpdir, "call_multi_subset.sam")
    sub_sam = SamFile.read(sam)
    sub_sam.records = sub_sam.records[:PARITY_READS]
    sub_sam.write(path)
    refs = get_fasta_dictionary(mut_fa)
    hmm = PairHmm.load(pipeline.DEFAULT_MODEL)
    exp, calls = {}, {}
    for dev in ("cpu", "cuda"):
        exp[dev] = caller.accumulate_expectations(
            SamFile.read(path), refs, hmm, caller.CallerOptions(),
            device=dev, multi=True)
        calls[dev] = {c[:3] for c in caller.call_variants(
            exp[dev], refs, hmm, caller.DEFAULT_THRESHOLD)}
    err = max(float(np.abs(exp["cpu"][k] - exp["cuda"][k]).max())
              for k in refs)
    res = {"reads": PARITY_READS, "guide_records": len(gg),
           "cigars_identical": same, "near_ties": len(gaps),
           "worst_tie_relative": worst, "align_cpu_s": tc,
           "align_cuda_s": tg, "caller_records": len(sub_sam.records),
           "calls": len(calls["cuda"]), "expectations_max_abs_err": err}
    log("multi parity: %s" % json.dumps(res))
    check(same >= MULTI_MIN_EQUAL * len(rg), "multi parity: fewer than %d%% "
          "of cigars identical between cpu and cuda"
          % (100 * MULTI_MIN_EQUAL))
    check(worst <= 1e-5, "multi parity: a cigar differing between cpu and "
          "cuda scores %.3g (relative) off under the card's posteriors"
          % worst)
    check(calls["cpu"] == calls["cuda"], "multi parity: call sets differ "
          "between cpu and cuda")
    check(err <= 1e-3, "multi parity: expectations differ by %g between cpu "
          "and cuda" % err)
    return res


def phase_em_multi(tmpdir):
    """marginAlign --em with multi=True on the multi phase's tRNA corpus at
    full width (band 21, 3 lockstep trials, split 300, 88 M cells per
    batch), depth cut to TRNA_READS reads and EM_ITERATIONS iterations:
    only nw_multi, the multi counts pair use_ckpt picks for each E-step
    batch, the FB multi pair and mea_multi may launch, and the host band
    packer never runs; every trial's log-likelihood non-decreasing, the
    trained models load, records on their simulated reference and strand.
    Then EM on the same chained jobs in single-problem lanes (multi=False,
    no second guide run): final per-trial log-likelihoods within 1e-5
    relative, trained parameters within 1e-3.  Returns (launches, largest
    launch inputs, results)."""
    import dataclasses

    import numpy as np
    import torch

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build

    fq, fa, truth = write_trna_corpus(tmpdir, TRNA_READS, TRNA_REFS)
    out = os.path.join(tmpdir, "trna_em_multi.sam")
    model = os.path.join(tmpdir, "trna_em_multi.hmm")
    opts = pipeline.AlignOptions(
        em=True, output_model_path=model,
        em_options=em.EmOptions(iterations=EM_ITERATIONS,
                                output_trial_hmms_path=model))
    train, kept = em.train_em, {}

    def keep_training(jobs, options, *args, **kwargs):
        kept.update(jobs=jobs, options=options,
                    input_hmm=kwargs.get("input_hmm"))
        t0 = time.perf_counter()
        best = train(jobs, options, *args, **kwargs)
        kept["train_s"] = time.perf_counter() - t0
        return best

    with recording_launches(list(KERNELS)) as (shapes, largest, host), \
            em_recording() as rec, \
            replaced_everywhere({train: keep_training}):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        stages = pipeline.align(fq, fa, out, opts, device="cuda", multi=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    recs = sam_records(out)
    log("em_multi: %d reads in, %d records out, %.3f s, %.2f reads/s; "
        "stages %s; launches %s; launch shapes %s; host band packer %s; "
        "E-step batch kinds %s"
        % (TRNA_READS, len(recs), total, len(recs) / total,
           json.dumps(stages),
           json.dumps({k: n for k, n in launches.items() if n}),
           json.dumps({k: v for k, v in shapes.items() if v}),
           json.dumps(host), json.dumps(rec["kinds"])))
    pair = check_em_counts_policy("em_multi", shapes, launches,
                                  COUNTS_MULTI_PAIRS)
    check_launches("em_multi", ["nw_multi", *pair, "fb_multi_forward",
                                "fb_multi_backward", "mea_multi"],
                   launches, shapes)
    check(host["pack_banded_batch"] == 0,
          "em_multi: the host band packer ran")
    check(all(k == ["multi"] * len(k) for k in rec["kinds"]),
          "em_multi: an E-step batch is not of multi-problem lanes")
    histories = check_histories("em_multi", rec["histories"])
    PairHmm.load(model)                       # load() checks the rows
    for t in range(len(histories)):
        PairHmm.load("%s.trial%d" % (model, t))
    placed = sum((r.rname, bool(r.flag & 16)) == truth[r.qname]
                 for r in recs)
    log("em_multi: %d of %d records on their simulated reference and strand"
        % (placed, len(recs)))
    check(placed >= 0.95 * len(recs), "em_multi: fewer than 95% of records "
          "on their simulated reference and strand")

    # The same training in single-problem lanes.
    single = os.path.join(tmpdir, "trna_em_single.hmm")
    sopts = dataclasses.replace(kept["options"],
                                output_trial_hmms_path=single)
    with em_recording() as srec:
        t0 = time.perf_counter()
        em.train_em(kept["jobs"], sopts, input_hmm=kept["input_hmm"],
                    device="cuda", multi=False)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
    shist = check_histories("em_single", srec["histories"])
    ll_err = max(abs(m[-1] - s[-1]) / abs(s[-1])
                 for m, s in zip(histories, shist))
    perr = 0.0
    for t in range(len(histories)):
        a = PairHmm.load("%s.trial%d" % (model, t))
        b = PairHmm.load("%s.trial%d" % (single, t))
        perr = max(perr, np.abs(a.transitions - b.transitions).max(),
                   np.abs(a.emissions - b.emissions).max())
    res = {"reads_in": TRNA_READS, "records_out": len(recs),
           "placed": placed, "total_s": total,
           "reads_per_s": len(recs) / total, **stages,
           "counts_pair": pair, "counts_shapes": shapes[pair[0]],
           "jobs": len(kept["jobs"]),
           "likelihood_histories": histories,
           "multi": {"train_em_s": kept["train_s"],
                     "prepare_em_batches_s": sum(rec["prepare_s"]),
                     "estep_s": rec["estep_s"]},
           "single": {"train_em_s": single_s,
                      "prepare_em_batches_s": sum(srec["prepare_s"]),
                      "estep_s": srec["estep_s"],
                      "likelihood_histories": shist},
           "final_ll_max_rel_err": ll_err, "params_max_abs_err": perr}
    log("em_multi: %s" % json.dumps(res))
    check(ll_err <= 1e-5, "em_multi: final log-likelihoods differ from the "
          "single-lane EM's by %g (relative)" % ll_err)
    check(perr <= 1e-3, "em_multi: trained parameters differ from the "
          "single-lane EM's by %g" % perr)
    return launches, largest, res


def phase_em_multi_kernels(largest):
    """The four multi-lane counts kernels on the em_multi phase's largest
    E-step batch (the other pair forced), then again with its first
    trial's model alone (a serial trial, rows 25 and 30: a trials axis of
    1), each held against its plain version."""
    base = counts_multi_base(largest)
    log("kernels[em_multi] inputs: counts base [Ntr, d1k, Wp, B] %s"
        % ([base[0].shape[0]] + list(base[3].shape)))
    report = compare_kernels("em_multi", EM_MULTI_KERNELS,
                             {"counts_multi": base}, 3)
    one = compare_counts_multi(
        (*(t[:1].contiguous() for t in base[:3]), *base[3:10],
         base[10][:1].contiguous()), 3)
    for name, serial in one.items():
        log("kernels[em_multi, one trial] %-15s %s"
            % (name, json.dumps(serial)))
        report[name]["one_trial"] = serial
    return report


def phase_em_multi_parity(tmpdir):
    """pipeline.align(em=True, multi=True) on the multi parity phase's
    PARITY_READS tRNA reads, EM_PARITY_ITERATIONS iterations, trial 0 from
    the shipped model, on the CPU (plain versions) and on the card
    (kernels; the "em_multi_parity" path, where the policy gives the small
    batch the stored pair): trained parameters within 1e-4, histories
    within rtol 1e-5, guide records identical, >= MULTI_MIN_EQUAL of
    cigars identical and every other one an MEA near-tie (1e-5 relative
    under the card's posteriors).  Returns (launches, results)."""
    import numpy as np

    from marginalign_trna_tpu_torch import pipeline
    from marginalign_trna_tpu_torch.align import em
    from marginalign_trna_tpu_torch.models.hmm import PairHmm
    from marginalign_trna_tpu_torch.ops import _build

    sub = os.path.join(tmpdir, "trna_parity.fq")
    fa = os.path.join(tmpdir, "trna.fa")
    runs, launches, pair = {}, None, None
    for dev in ("cpu", "cuda"):
        out = os.path.join(tmpdir, "trna_em_parity_%s.sam" % dev)
        guide_sam = os.path.join(tmpdir, "trna_em_parity_%s_guide.sam" % dev)
        model = os.path.join(tmpdir, "trna_em_%s.hmm" % dev)
        opts = pipeline.AlignOptions(
            em=True, output_model_path=model,
            em_options=em.EmOptions(iterations=EM_PARITY_ITERATIONS,
                                    use_default_model_as_start=True,
                                    output_trial_hmms_path=model))
        with recording_launches(EM_MULTI_KERNELS) as (shapes, _, _), \
                em_recording() as rec, multi_recording(guide_sam) as kept:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            pipeline.align(sub, fa, out, opts, device=dev, multi=True)
            total = time.perf_counter() - t0
            if dev == "cuda":
                launches = dict(_build.launch_counts)
                pair = check_em_counts_policy("em_multi_parity", shapes,
                                              launches, COUNTS_MULTI_PAIRS)
        models = [PairHmm.load(model)] + [
            PairHmm.load("%s.trial%d" % (model, t))
            for t in range(len(rec["histories"][0]))]
        runs[dev] = (sam_records(guide_sam), sam_records(out), models,
                     np.array(rec["histories"]), kept, total)
    (gc, rc, mc, hc, _, tc), (gg, rg, mg, hg, kept, tg) = (runs["cpu"],
                                                           runs["cuda"])
    check([r.line for r in gc] == [r.line for r in gg],
          "em_multi parity: guide records differ between cpu and cuda")
    perr = max(max(np.abs(a.transitions - b.transitions).max(),
                   np.abs(a.emissions - b.emissions).max())
               for a, b in zip(mc, mg))
    herr = float((np.abs(hc - hg) / np.abs(hc)).max())
    check(len(kept["posts"]) == 1, "em_multi parity: expected one multi-lane "
          "realignment on the card")
    same, gaps = multi_tie_gaps(rg, rc, kept["packs"][-1],
                                kept["posts"][0].cpu().numpy())
    worst = max(gaps, default=0.0)
    res = {"reads": PARITY_READS, "counts_pair": pair,
           "params_max_abs_err": perr, "history_max_rel_err": herr,
           "guide_records": len(gg), "cigars_identical": same,
           "near_ties": len(gaps), "worst_tie_relative": worst,
           "cpu_s": tc, "cuda_s": tg}
    log("em_multi parity: %s" % json.dumps(res))
    check(pair == sorted(COUNTS_MULTI_PAIRS["stored"]), "em_multi parity: "
          "the card's run took %s, not the stored pair" % pair)
    check(perr <= 1e-4, "em_multi parity: trained parameters differ by %g"
          % perr)
    check(herr <= 1e-5, "em_multi parity: likelihood histories differ by "
          "%g (relative)" % herr)
    check(same >= MULTI_MIN_EQUAL * len(rg), "em_multi parity: fewer than "
          "%d%% of cigars identical" % (100 * MULTI_MIN_EQUAL))
    check(worst <= 1e-5, "em_multi parity: a cigar differing between cpu "
          "and cuda scores %.3g (relative) off under the card's posteriors"
          % worst)
    return launches, res


def phase_clock():
    """A function that logs, after a named phase, the seconds since its
    creation and, on a line of its own, the seconds since the phase before;
    its `seconds` attribute keeps the latter by phase."""
    t0 = time.perf_counter()
    last = [t0]

    def elapsed(phase):
        now = time.perf_counter()
        elapsed.seconds[phase] = round(now - last[0], 1)
        last[0] = now
        log("time: %s done at %.1f s" % (phase, now - t0))
        log("phase-seconds: %s %.1f" % (phase, elapsed.seconds[phase]))
    elapsed.seconds = {}
    return elapsed


def ptxas_spills(build_log):
    """{function: (spill store bytes, spill load bytes)} from ptxas -v."""
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


# The kernels redesigned last, by the start of their mangled names: K1's
# and K4's nw_kernel and mea_warp_kernel (nw_multi's and mea_multi's
# instances too; nw_multi's at three rows of a half or a quarter of a
# warp, Wp 48 and 24, by `Lb1ELi16E` / `Lb1ELi8E`: MULTI, 16 or 8 threads
# a lane), K2 / K3's rel_backward_kernel /
# rel_forward_kernel, the multi-lane FB pair's multi_forward_kernel /
# multi_backward_kernel and the serving kernels' serve_backward_kernel /
# serve_post_kernel at one and two rows a thread (Wp <= 64), X's window
# and reduce kernels and the tracebacks' moves_kernel (every route and
# tile) must compile with no stack frame and no spill; those
# kernels at three and four rows a thread (Wp > 64, on no path but the tiny
# checks) with no spill (mk::WarpRows keeps its edge row on a stack there
# but in the multi instances, which select it by PTX).
FRAMELESS = ("mea_warp_kernelILi1", "mea_warp_kernelILi2",
             "nw_kernelILi1", "nw_kernelILi2",
             "nw_kernelILi3ELi16ELb1ELi16E", "nw_kernelILi3ELi32ELb1ELi16E",
             "nw_kernelILi3ELi32ELb1ELi8E", "nw_kernelILi3ELi64ELb1ELi8E",
             "rel_backward_kernelILi1", "rel_backward_kernelILi2",
             "rel_forward_kernelILi1", "rel_forward_kernelILi2",
             "multi_forward_kernelILi1", "multi_forward_kernelILi2",
             "multi_backward_kernelILi1", "multi_backward_kernelILi2",
             "serve_backward_kernelILi1", "serve_backward_kernelILi2",
             "serve_post_kernelILi1", "serve_post_kernelILi2",
             "lanesum_window_kernel", "lanesum_reduce_kernel",
             "moves_kernel")
SPILL_FREE = ("mea_warp_kernel", "nw_kernel", "rel_backward_kernel",
              "rel_forward_kernel",
              "multi_forward_kernel", "multi_backward_kernel",
              "serve_backward_kernel", "serve_post_kernel")


def ptxas_frames(build_log):
    """{function: (stack frame bytes, spill store bytes, spill load
    bytes)} from ptxas -v."""
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = tuple(int(g) for g in m.groups())
            fn = None
    return out


def check_frameless(build_log):
    """Every variant of the FRAMELESS kernels compiles with no stack frame
    and no spill, every variant of the SPILL_FREE ones with no spill."""
    frames = ptxas_frames(build_log)
    for names, what, bad_of in ((FRAMELESS, "stack frame or spills", any),
                                (SPILL_FREE, "spills", lambda f: any(f[1:]))):
        for name in names:
            mine = {fn: f for fn, f in frames.items() if name in fn}
            check(mine, "build: no ptxas report for %s" % name)
            bad = {fn: f for fn, f in mine.items() if bad_of(f)}
            check(not bad, "build: %s has %s (stack, stores, loads in "
                  "bytes): %s" % (name, what, json.dumps(bad)))
            log("build: %d %s variants, no %s" % (len(mine), name, what))


def check_no_counts_spills(build_log):
    """The kernels of csrc/fb_counts.cu (the counts pairs, which keep their
    count partials in registers: the checkpoint forward in its checkpoint
    and all-planes modes, the checkpoint backward and
    counts_stored_bwd_kernel; and the generic pair: the checkpoint
    forward's match mode and generic_bwd_kernel) must not spill: ptxas
    must report none of their variants spilling."""
    spills = {fn: s for fn, s in ptxas_spills(build_log).items()
              if "counts_" in fn or "generic_bwd" in fn}
    check(spills, "build: no ptxas report for the counts kernels")
    for name in ("generic_bwd", "counts_stored_bwd"):
        check(any(name in fn for fn in spills),
              "build: no ptxas report for %s_kernel" % name)
    bad = {fn: s for fn, s in spills.items() if any(s)}
    check(not bad, "build: counts or generic kernels spill (stores, loads "
          "in bytes): %s" % json.dumps(bad))
    log("build: %d counts and generic kernel variants, no spills"
        % len(spills))


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
        elapsed = phase_clock()
        _build.load()
        log("build: %.2f s" % (time.perf_counter() - t0))
        build_log = _build.build_log()
        for line in build_log.splitlines():
            if ("Used" in line or "Function properties" in line
                    or "spill" in line):
                log("build: " + line.strip())
        check_no_counts_spills(build_log)
        check_frameless(build_log)
        elapsed("build")

        cuda = torch.device("cuda")
        compare_kernels("tiny", list(KERNELS), {
            **tiny_serve_inputs(cuda), **tiny_inputs(cuda),
            **tiny_caller_inputs(cuda), **tiny_default_inputs(cuda),
            **tiny_counts_inputs(cuda), **tiny_generic_inputs(cuda),
            **tiny_multi_inputs(cuda), **tiny_counts_multi_inputs(cuda),
            **tiny_moves_inputs(cuda)}, 3)
        compare_kernels("tiny_em_multi_one_trial", EM_MULTI_KERNELS,
                        tiny_counts_multi_inputs(cuda, ntr=1), 3)
        compare_kernels("tiny_non_chain", ["sv_backward"] + SERVE_NEW,
                        tiny_serve_inputs(cuda, chain_model=False), 3)
        for width in WIDE_BANDS:
            compare_kernels("tiny_width_%d" % width, SERVE_NEW,
                            tiny_serve_inputs(cuda, width=width), 3)
        compare_kernels("tiny_multi_non_chain", FB_MULTI,
                        tiny_multi_inputs(cuda, chain_model=False), 3)
        compare_kernels("tiny_multi_width_40", ["nw_multi"],
                        tiny_multi_inputs(cuda, width=40), 3)
        for width in WIDE_BANDS:
            compare_kernels("tiny_multi_width_%d" % width, FB_MULTI,
                            tiny_multi_inputs(cuda, width=width), 3)
        elapsed("tiny")
        with tempfile.TemporaryDirectory() as tmpdir:
            fq, fa, truth, sam, launches, largest, main_res = phase_main(
                tmpdir)
            kernels = phase_kernels("main", ALIGN_KERNELS, largest)
            elapsed("main")
            del largest
            rel_launches, largest, rel_res, rel_state = phase_rel(
                tmpdir, fq, fa, sam)
            kernels.update(phase_kernels("rel", REL_KERNELS, largest))
            elapsed("rel")
            del largest
            serve_launches, largest, serve_res = phase_serve(tmpdir, fa, sam,
                                                             rel_state)
            del rel_state
            on_serve = {path: phase_kernels(path, SERVE_NEW, largest[path])
                        for path in ("serve_realign", "serve_call")}
            elapsed("serve")
            del largest
            serve_parity = phase_serve_parity(tmpdir, fq, fa, sam)
            elapsed("serve parity")
            parity = phase_parity(tmpdir, fq, fa)
            elapsed("parity")
            mut_fa, call_launches, largest, caller_res = phase_caller(
                tmpdir, fa, sam)
            on_caller = phase_kernels("caller", CALLER_KERNELS, largest)
            del largest
            caller_parity = phase_caller_parity(tmpdir, mut_fa, sam)
            elapsed("caller")
            em_launches, largest, em_res = phase_em(tmpdir, fq, fa, truth)
            on_em = phase_em_kernels(largest)
            elapsed("em")
            del largest
            em_parity_launches, em_parity = phase_em_parity(tmpdir, fq, fa)
            elapsed("em parity")
            # The card's EM parity run wrote it (--outputModel): trial 0,
            # started from the shipped model, un-normalised.
            trial_model = os.path.join(tmpdir, "em_cuda.hmm.trial0")
            generic_sam, generic_launches, largest, generic_res = (
                phase_generic(tmpdir, fq, fa, sam, trial_model))
            on_generic = phase_generic_kernels("generic",
                                               generic_base(largest))
            del largest
            gmut_fa, call_generic_launches, base, call_generic_res = (
                phase_generic_caller(tmpdir, fa, generic_sam, trial_model))
            on_call_generic = phase_generic_kernels("call_generic", base)
            elapsed("generic")
            del base
            generic_parity = phase_generic_parity(
                tmpdir, fq, fa, generic_sam, gmut_fa, trial_model)
            elapsed("generic parity")
            band_launches, base, band_res = phase_band(tmpdir, fq, fa, truth)
            on_em_band = phase_generic_kernels("em_band", base)
            elapsed("band")
            del base
            band_parity = phase_band_parity(tmpdir, fq, fa)
            elapsed("band parity")
            multi_launches, largest, multi_res = phase_multi(tmpdir)
            elapsed("multi")
            call_multi_launches, more, call_multi_res = phase_call_multi(
                tmpdir, sam, mut_fa)
            largest_of(largest, more)
            del more
            on_multi = phase_kernels("multi", MULTI_KERNELS, largest)
            del largest
            elapsed("call multi")
            multi_parity = phase_multi_parity(tmpdir, sam, mut_fa)
            elapsed("multi parity")
            em_multi_launches, largest, em_multi_res = phase_em_multi(tmpdir)
            on_em_multi = phase_em_multi_kernels(largest)
            del largest
            elapsed("em multi")
            em_multi_parity_launches, em_multi_parity = (
                phase_em_multi_parity(tmpdir))
            elapsed("em multi parity")
        # The policy gives the 256-read E-step batch to the checkpoint
        # pair and the 32-read one to the stored pair: both pairs ran.
        for name in COUNTS_PAIRS["ckpt"]:
            check(em_launches[name] > 0, "%s never launched on the EM path"
                  % name)
        for name in COUNTS_PAIRS["stored"]:
            check(em_parity_launches[name] > 0, "%s never launched on the "
                  "EM parity run" % name)
        # The multi-lane pairs: each launches on one of the two em_multi
        # runs (the policy's pick for their batches).
        for name in EM_MULTI_KERNELS:
            check(em_multi_launches[name] + em_multi_parity_launches[name]
                  > 0, "%s never launched on an em_multi path" % name)
        card = card_identity()
    except SmokeFailure as exc:
        print("chip_smoke: FAIL: %s" % exc, file=sys.stderr)
        return 1

    log("main-path: %s" % json.dumps(main_res))
    log("rel-path: %s" % json.dumps(rel_res))
    log("serve-paths: %s" % json.dumps(serve_res))
    log("serve-parity: %s" % json.dumps(serve_parity))
    log("parity: %s" % json.dumps(parity))
    log("caller-path: %s" % json.dumps(caller_res))
    log("caller-parity: %s" % json.dumps(caller_parity))
    log("em-path: %s" % json.dumps(em_res))
    log("em-parity: %s" % json.dumps(em_parity))
    log("generic-path: %s" % json.dumps(generic_res))
    log("caller-generic: %s" % json.dumps(call_generic_res))
    log("generic-parity: %s" % json.dumps(generic_parity))
    log("em-band: %s" % json.dumps(band_res))
    log("em-band-parity: %s" % json.dumps(band_parity))
    log("multi-path: %s" % json.dumps(multi_res))
    log("caller-multi: %s" % json.dumps(call_multi_res))
    log("multi-parity: %s" % json.dumps(multi_parity))
    log("em-multi-path: %s" % json.dumps(em_multi_res))
    log("em-multi-parity: %s" % json.dumps(em_multi_parity))
    log("phase-seconds: %s" % json.dumps(elapsed.seconds))
    log(card)
    # A kernel's launches and measurements come from the first path it runs
    # on (E and S: marginAlign's main path; the checkpoint counts pair: the
    # EM phase; the stored pair: the card's EM parity run, where the policy
    # picks it; the generic pair: marginAlign with the trial model; the
    # serving kernels: the realign run of the first mode that uses them,
    # measured on their largest launch over the modes' realign runs; the
    # multi-lane kernels: marginAlign with multi=True, measured on their
    # largest launch over it and marginCaller with multi=True; the
    # multi-lane counts pairs: the em_multi run where the policy picks
    # them, else the card's em_multi parity run);
    # measurements on later paths ride along under their path ("caller",
    # "em", "call_generic", "em_band", "serve_call": the serving kernels'
    # largest launch over the modes' caller runs), and launches_by_path
    # lists every path that ran it.
    by_path = {"align": launches, "rel": rel_launches, "call": call_launches,
               "em": em_launches, "em_parity": em_parity_launches,
               "generic": generic_launches,
               "call_generic": call_generic_launches,
               "em_band": band_launches, **serve_launches,
               "multi": multi_launches, "call_multi": call_multi_launches,
               "em_multi": em_multi_launches,
               "em_multi_parity": em_multi_parity_launches}
    first = {name: "em_parity" if name in COUNTS_PAIRS["stored"] else
             KERNELS[name][3][0] for name in KERNELS}
    for name in EM_MULTI_KERNELS:
        if not em_multi_launches[name]:
            first[name] = "em_multi_parity"
    for name in SERVE_NEW:
        first[name] = "serve_realign_" + next(
            mode for mode, names in SERVE_KERNELS.items() if name in names)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    lines = []
    for name, (src, rep, _, _) in KERNELS.items():
        reports = [("align", kernels), ("caller", on_caller), ("em", on_em),
                   ("generic", on_generic), ("call_generic", on_call_generic),
                   ("em_band", on_em_band), *on_serve.items(),
                   ("multi", on_multi), ("em_multi", on_em_multi)]
        res = next(r[name] for _, r in reports if name in r)
        line = {"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": by_path[first[name]][name],
                **{k: res[k] for k in keys},
                "launches_by_path": {p: n[name] for p, n in by_path.items()
                                     if n[name]}}
        for tag, r in reports:
            if name in r and r[name] is not res:
                line[tag] = {k: r[name][k] for k in keys + ("resources",)
                             if k in r[name]}
        for extra in ("one_trial", "resources", "moves", "replaced"):
            if extra in res:
                line[extra] = res[extra]
        lines.append(line)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
