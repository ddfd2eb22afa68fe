"""One-call API for marginAlign on one torch device.

Port of marginalign_trna_tpu/pipeline.py `align` (no EM yet):

    from marginalign_trna_tpu_torch import pipeline
    pipeline.align("reads.fq", "ref.fa", "out.sam", device="cuda")

The device is explicit.  "cuda" runs the CUDA kernels and fails if no CUDA
device is present; the plain PyTorch versions run only when "cpu" is asked
for.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .align.chain import chain_sam_file
from .align.guide import GuideConfig, map_reads
from .align.realign import realign_sam_file
from .models.hmm import PairHmm

DEFAULT_MODEL = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "models", "last_hmm_20.txt"
)


@dataclass
class AlignOptions:
    no_chain: bool = False
    no_realign: bool = False
    em: bool = False
    gap_gamma: float = 0.5
    match_gamma: float = 0.0
    mapper_preset: str = "last"
    input_model: Optional[PairHmm] = None
    # Reference realign-path --splitMatrixBiggerThanThis
    # (src/margin/marginAlignLib.py:316); 0 = exact full-length DP.
    split_size: int = 3000


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass --device cpu (device='cpu') to run the plain PyTorch "
            "versions on the CPU" % str(device)
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(device))
    return dev


def align(
    read_fastq_path: str,
    reference_fasta_path: str,
    output_sam_path: str,
    options: Optional[AlignOptions] = None,
    device="cuda",
) -> Dict[str, float]:
    """marginAlign: guide mapping, chaining, realignment -> SAM.  Returns
    the wall seconds of each stage (guide_s, chain_s, realign_s)."""
    options = options or AlignOptions()
    if options.em:
        raise NotImplementedError(
            "EM training (--em) is not ported to the PyTorch package yet "
            "(slice 3 of the port); run it with the JAX package"
        )
    dev = resolve_device(device)
    cfg = GuideConfig.preset(options.mapper_preset)
    stages: Dict[str, float] = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmpdir:
        guide_sam = os.path.join(tmpdir, "guide.sam")
        chained_sam = os.path.join(tmpdir, "chained.sam")
        last_stage_out = output_sam_path if (
            options.no_realign and options.no_chain) else guide_sam
        timed("guide_s", map_reads, read_fastq_path, reference_fasta_path,
              last_stage_out, cfg, dev)
        if not options.no_chain:
            timed("chain_s", chain_sam_file, guide_sam,
                  output_sam_path if options.no_realign else chained_sam,
                  read_fastq_path, reference_fasta_path)
        if options.no_realign:
            return stages
        hmm = options.input_model or PairHmm.load(DEFAULT_MODEL)
        timed("realign_s", realign_sam_file,
              guide_sam if options.no_chain else chained_sam,
              output_sam_path, read_fastq_path, reference_fasta_path, hmm,
              dev, gap_gamma=options.gap_gamma,
              match_gamma=options.match_gamma, no_chain=True,
              split_size=options.split_size)
    return stages
