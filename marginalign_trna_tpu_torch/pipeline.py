"""One-call API for marginAlign and marginCaller on one torch device.

Port of marginalign_trna_tpu/pipeline.py:

    from marginalign_trna_tpu_torch import pipeline
    pipeline.align("reads.fq", "ref.fa", "out.sam", device="cuda")
    pipeline.align("reads.fq", "ref.fa", "out.sam",
                   pipeline.AlignOptions(em=True, output_model_path="m.hmm"),
                   device="cuda")
    pipeline.call("out.sam", "ref.fa", "out.vcf", device="cuda")
    pipeline.align_and_call("reads.fq", "ref.fa", "out.sam", "out.vcf",
                            device="cuda")

With em=True the model is first trained by Baum-Welch EM on the chained
guide alignments (align/em.py), normalised, and the realignment runs with
it (the reference's marginAlign --em, src/margin/marginAlignLib.py:279-297).

With multi=True the guide, the EM E-step and the realignment run in
multi-problem lanes, several short problems per lane (the JAX package's
MARGINALIGN_MULTI=on; align/guide.py, align/em.py and align/realign.py).

The device is explicit.  "cuda" runs the CUDA kernels and fails if no CUDA
device is present; the plain PyTorch versions run only when "cpu" is asked
for.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from .align.chain import chain_sam_file
from .align.em import EmOptions, normalise_trained_hmm, train_em
from .align.guide import GuideConfig, map_reads
from .align.realign import _jobs_from_sam, realign_sam_file
from .io.fasta import get_fasta_dictionary
from .io.sam import SamFile
from .models.hmm import PairHmm
from .utils.seq import encode

if TYPE_CHECKING:
    from .call.caller import CallerOptions

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
    # EM (em=True): where to write the trained, normalised model (text
    # and XML), the training options, a checkpoint file to resume training
    # from, and a sink for the per-iteration log lines.
    output_model_path: Optional[str] = None
    output_xml_model_path: Optional[str] = None
    em_options: EmOptions = field(default_factory=EmOptions)
    em_checkpoint_path: Optional[str] = None
    em_log_fn: Optional[Callable[[str], None]] = None
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
    multi: bool = False,
) -> Dict[str, float]:
    """marginAlign: guide mapping, chaining, [EM training,] realignment ->
    SAM.  Returns the wall seconds of each stage (guide_s, chain_s, em_s,
    realign_s).  multi=True: the guide, the EM E-step and the
    realignment in multi-problem lanes (module docstring)."""
    return _align(read_fastq_path, reference_fasta_path, output_sam_path,
                  options, device, multi)[0]


def call(
    sam_path: str,
    reference_fasta_path: str,
    output_vcf_path: str,
    alignment_model: Optional[PairHmm] = None,
    error_model: Optional[PairHmm] = None,
    options: Optional[CallerOptions] = None,
    device="cuda",
) -> List[Tuple[str, int, str, float]]:
    """marginCaller on `device`; returns the variant calls.  A model not
    given is the shipped default (marginalign_trna_tpu/pipeline.py
    `call`)."""
    # call/caller.py imports this module (resolve_device).
    from .call.caller import margin_caller

    default = PairHmm.load(DEFAULT_MODEL)
    return margin_caller(
        sam_path, reference_fasta_path, output_vcf_path,
        alignment_model=alignment_model or default,
        error_model=error_model or default,
        options=options, device=device,
    )


def align_and_call(
    read_fastq_path: str,
    reference_fasta_path: str,
    output_sam_path: str,
    output_vcf_path: str,
    align_options: Optional[AlignOptions] = None,
    caller_options: Optional[CallerOptions] = None,
    device="cuda",
) -> List[Tuple[str, int, str, float]]:
    """FASTQ -> SAM -> VCF on `device`.  With align_options.em the trained
    model is both of the caller's models, else the shipped default is (the
    reference's integrative flow, tests/tests.py:189-209;
    marginalign_trna_tpu/pipeline.py `align_and_call`)."""
    _, trained = _align(read_fastq_path, reference_fasta_path,
                        output_sam_path, align_options, device, False)
    return call(output_sam_path, reference_fasta_path, output_vcf_path,
                alignment_model=trained, error_model=trained,
                options=caller_options, device=device)


def _align(read_fastq_path: str, reference_fasta_path: str,
           output_sam_path: str, options: Optional[AlignOptions], device,
           multi: bool) -> Tuple[Dict[str, float], Optional[PairHmm]]:
    """`align`'s stage seconds and the trained, normalised model (None
    without EM)."""
    options = options or AlignOptions()
    dev = resolve_device(device)
    cfg = GuideConfig.preset(options.mapper_preset)
    stages: Dict[str, float] = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmpdir:
        guide_sam = os.path.join(tmpdir, "guide.sam")
        chained_sam = os.path.join(tmpdir, "chained.sam")
        last_stage_out = output_sam_path if (
            options.no_realign and options.no_chain) else guide_sam
        timed("guide_s", map_reads, read_fastq_path, reference_fasta_path,
              last_stage_out, cfg, dev, multi)
        if not options.no_chain:
            timed("chain_s", chain_sam_file, guide_sam,
                  output_sam_path if options.no_realign else chained_sam,
                  read_fastq_path, reference_fasta_path)
        if options.no_realign:
            return stages, None
        work_sam = guide_sam if options.no_chain else chained_sam
        hmm = options.input_model or PairHmm.load(DEFAULT_MODEL)
        trained = None
        if options.em:
            hmm = trained = timed("em_s", _train, work_sam,
                                  reference_fasta_path, hmm, options, dev,
                                  multi)
        timed("realign_s", realign_sam_file, work_sam,
              output_sam_path, read_fastq_path, reference_fasta_path, hmm,
              dev, gap_gamma=options.gap_gamma,
              match_gamma=options.match_gamma, no_chain=True,
              split_size=options.split_size, multi=multi)
    return stages, trained


def _train(sam_path: str, reference_fasta_path: str, hmm: PairHmm,
           options: AlignOptions, dev: torch.device,
           multi: bool) -> PairHmm:
    """EM on the records of `sam_path` (E-step in multi-problem lanes with
    multi=True), starting from `hmm` where the options say so; returns the
    best trial's model, normalised for realignment (flat indel emissions,
    GC 0.5), written where the options say."""
    jobs = _jobs_from_sam(SamFile.read(sam_path),
                          get_fasta_dictionary(reference_fasta_path), encode)
    best = train_em(jobs, options.em_options, input_hmm=hmm,
                    log_fn=options.em_log_fn,
                    checkpoint_path=options.em_checkpoint_path, device=dev,
                    multi=multi)
    trained = normalise_trained_hmm(best.hmm)
    trained.likelihood = best.likelihood
    if options.output_model_path:
        trained.write(options.output_model_path)
    if options.output_xml_model_path:
        trained.write_xml(options.output_xml_model_path)
    return trained
