"""Command-line entry point of the PyTorch port.

    python -m marginalign_trna_tpu_torch marginAlign reads.fq ref.fa out.sam \
        [--em [--outputModel m.hmm] [EM options]] [--device cuda|cpu]
    python -m marginalign_trna_tpu_torch marginCaller in.sam ref.fa out.vcf \
        [--device cuda|cpu]
    python -m marginalign_trna_tpu_torch marginStats in.sam reads.fq ref.fa \
        [--readIdentity ...]
    python -m marginalign_trna_tpu_torch modifyHmm in.hmm out.hmm [...]
    python -m marginalign_trna_tpu_torch uniquifyFastq | mutateReference |
        substitutions | kmerAnalysis | createAssemblyHub ...

Every command keeps the JAX package's flag surface (marginalign_trna_tpu/
cli.py and tools/cli.py, mirroring the reference's
src/margin/marginAlign.py:16-54, marginCaller.py, marginStats.py:13-55 and
scripts/).  marginAlign and marginCaller add --device: the default device
is cuda; without a CUDA device the command fails, and the CPU (the plain
PyTorch versions of the kernels) runs only with --device cpu.  The other
commands run on the host.  jobTree options are accepted and ignored.
"""
from __future__ import annotations

import argparse
import sys

from .pipeline import DEFAULT_MODEL
from .tools import cli as tools_cli


def _add_ignored_jobtree_options(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("compatibility (accepted, ignored)")
    for flag in ("--jobTree", "--maxThreads", "--logLevel", "--batchSystem",
                 "--defaultMemory"):
        g.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--logInfo", "--logDebug"):
        g.add_argument(flag, action="store_true", help=argparse.SUPPRESS)


def margin_align_main(argv=None) -> int:
    from .align.em import EmOptions
    from .models.hmm import PairHmm
    from .pipeline import AlignOptions, align

    p = argparse.ArgumentParser(
        prog="marginAlign",
        description="Align a FASTQ of nanopore reads to a reference FASTA, "
        "emitting SAM (PyTorch + CUDA port).",
    )
    p.add_argument("inputFastqFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputSamFile")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; the CUDA kernels) or "
                        "cpu (their plain PyTorch versions)")
    p.add_argument("--em", action="store_true",
                   help="Run expectation maximisation (EM)")
    p.add_argument("--bwa", action="store_true",
                   help="Use the BWA-style seed preset instead of LAST-style")
    p.add_argument("--minimap2", action="store_true",
                   help="Use the minimap2-style seed preset (primary only)")
    p.add_argument("--noRealign", action="store_true",
                   help="Don't run any realignment step")
    p.add_argument("--noChain", action="store_true",
                   help="Don't run any chaining step")
    p.add_argument("--gapGamma", type=float, default=0.5,
                   help="Gap gamma for the AMAP function (default 0.5)")
    p.add_argument("--matchGamma", type=float, default=0.0,
                   help="Match gamma for the AMAP function (default 0.0)")
    p.add_argument("--inputModel", default=DEFAULT_MODEL,
                   help="Input HMM model file")
    p.add_argument("--outputModel", default=None,
                   help="Where to write the EM-trained model")
    # EM options (cPecanEm.Options surface, marginAlign.py:38-53).
    p.add_argument("--modelType", default="fiveStateAsymmetric",
                   choices=["fiveState", "fiveStateAsymmetric", "threeState",
                            "threeStateAsymmetric"],
                   help="HMM model family for EM training")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--noRandomStart", action="store_true")
    p.add_argument("--maxAlignmentLengthToSample", type=int,
                   default=50_000_000)
    p.add_argument("--emCheckpoint", default=None,
                   help="Checkpoint file for EM training (resume-capable)")
    # The reference defaults outputTrialHmms ON (marginAlign.py:43).
    p.add_argument("--outputTrialHmms", action="store_true", default=True,
                   help="Write each EM trial's model to <outputModel>.trialN "
                        "(default on, like the reference)")
    p.add_argument("--noOutputTrialHmms", dest="outputTrialHmms",
                   action="store_false",
                   help="Don't write per-trial EM models")
    p.add_argument("--useDefaultModelAsStart", action="store_true",
                   help="Start EM trial 0 from the input model instead of "
                        "a random start")
    p.add_argument("--updateTheBand", action="store_true",
                   help="Re-derive the EM band after each iteration by "
                        "realigning the training pairs with the current "
                        "model")
    p.add_argument("--tieEmissions", action="store_true",
                   help="Tie short/long gap-state emissions during EM")
    p.add_argument("--setJukesCantorStartingEmissions", type=float,
                   default=None, metavar="RATE",
                   help="Start EM emissions from a Jukes-Cantor matrix")
    p.add_argument("--outputXMLModelFile", default=None,
                   help="Also write the trained model as XML")
    p.add_argument("--maxAlignmentLengthPerJob", type=int, default=700_000,
                   help="Accepted for compatibility; batching is automatic")
    p.add_argument("--splitMatrixBiggerThanThis", type=int, default=3000,
                   help="Split DP problems at guide anchors so no side "
                        "exceeds this (reference realign default 3000; "
                        "0 = exact full-length DP)")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    preset = "bwa" if args.bwa else ("minimap2" if args.minimap2 else "last")
    em_options = EmOptions(
        model_type=args.modelType,
        trials=args.trials,
        iterations=args.iterations,
        random_start=not args.noRandomStart,
        max_alignment_length_to_sample=args.maxAlignmentLengthToSample,
        tie_emissions=args.tieEmissions,
        output_trial_hmms_path=(
            args.outputModel if args.outputTrialHmms else None
        ),
        jukes_cantor_start=args.setJukesCantorStartingEmissions,
        use_default_model_as_start=args.useDefaultModelAsStart,
        update_band_every=1 if args.updateTheBand else 0,
    )
    options = AlignOptions(
        no_chain=args.noChain,
        no_realign=args.noRealign,
        em=args.em,
        gap_gamma=args.gapGamma,
        match_gamma=args.matchGamma,
        mapper_preset=preset,
        input_model=None if args.noRealign else PairHmm.load(args.inputModel),
        split_size=args.splitMatrixBiggerThanThis,
        output_model_path=args.outputModel,
        output_xml_model_path=args.outputXMLModelFile,
        em_options=em_options,
        em_checkpoint_path=args.emCheckpoint,
        em_log_fn=lambda line: print(line, file=sys.stderr),
    )
    align(args.inputFastqFile, args.referenceFastaFile, args.outputSamFile,
          options, device=args.device)
    return 0


def margin_caller_main(argv=None) -> int:
    from .call.caller import CallerOptions, margin_caller
    from .models.hmm import PairHmm

    p = argparse.ArgumentParser(
        prog="marginCaller",
        description="Call SNVs from a SAM + reference, emitting VCF "
        "(PyTorch + CUDA port).",
    )
    p.add_argument("inputSamFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("outputVcfFile")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; the CUDA kernels) or "
                        "cpu (their plain PyTorch versions)")
    p.add_argument("--noMargin", action="store_true",
                   help="Use the input alignment directly instead of "
                   "marginalising over alignments")
    p.add_argument("--alignmentModel", default=DEFAULT_MODEL)
    p.add_argument("--errorModel", default=DEFAULT_MODEL)
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--maxAlignmentLengthPerJob", type=int, default=7_000_000,
                   help="Accepted for compatibility; batching is automatic")
    p.add_argument("--splitMatrixBiggerThanThis", type=int, default=100,
                   help="Split DP problems at guide anchors so no side "
                        "exceeds this (reference caller default 100; "
                        "0 = exact full-length DP)")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    margin_caller(
        args.inputSamFile, args.referenceFastaFile, args.outputVcfFile,
        alignment_model=PairHmm.load(args.alignmentModel),
        error_model=PairHmm.load(args.errorModel),
        options=CallerOptions(threshold=args.threshold,
                              no_margin=args.noMargin,
                              split_size=args.splitMatrixBiggerThanThis),
        device=args.device,
    )
    return 0


def margin_stats_main(argv=None) -> int:
    import numpy as np

    from .stats.stats import ReadAlignmentStats

    p = argparse.ArgumentParser(
        prog="marginStats",
        description="Alignment statistics from a SAM file.",
    )
    p.add_argument("samFile")
    p.add_argument("readFastqFile")
    p.add_argument("referenceFastaFile")
    p.add_argument("--readIdentity", action="store_true")
    p.add_argument("--alignmentIdentity", action="store_true")
    p.add_argument("--readCoverage", action="store_true")
    p.add_argument("--mismatchesPerAlignedBase", action="store_true")
    p.add_argument("--deletionsPerReadBase", action="store_true")
    p.add_argument("--insertionsPerReadBase", action="store_true")
    p.add_argument("--readLength", action="store_true")
    p.add_argument("--localAlignment", action="store_true",
                   help="Ignore unaligned read prefix/suffix")
    p.add_argument("--printValuePerReadAlignment", action="store_true")
    p.add_argument("--noStats", action="store_true")
    _add_ignored_jobtree_options(p)
    args = p.parse_args(argv)

    stats = ReadAlignmentStats.get_read_alignment_stats(
        args.samFile, args.readFastqFile, args.referenceFastaFile,
        global_alignment=not args.localAlignment,
    )

    def report(values, name):
        if not args.noStats:
            print("Average" + name, np.average(values))
            print("Median" + name, np.median(values))
            print("Min" + name, min(values))
            print("Max" + name, max(values))
        if args.printValuePerReadAlignment:
            print("Values" + name, "\t".join(map(str, values)))

    if args.readIdentity:
        report([s.read_identity() for s in stats], "ReadIdentity")
    if args.alignmentIdentity:
        report([s.alignment_identity() for s in stats], "AlignmentIdentity")
    if args.readCoverage:
        report([s.read_coverage() for s in stats], "ReadCoverage")
    if args.mismatchesPerAlignedBase:
        report([s.mismatches_per_aligned_base() for s in stats],
               "MismatchesPerAlignedBase")
    if args.deletionsPerReadBase:
        report([s.deletions_per_read_base() for s in stats],
               "DeletionsPerReadBase")
    if args.insertionsPerReadBase:
        report([s.insertions_per_read_base() for s in stats],
               "InsertionsPerReadBase")
    if args.readLength:
        report([s.read_length() for s in stats], "ReadLength")
    return 0


def modify_hmm_main(argv=None) -> int:
    from .models.hmm import PairHmm

    p = argparse.ArgumentParser(
        prog="modifyHmm",
        description="HMM surgery: substitution-rate relaxation, GC "
        "renormalisation, flat indel emissions (reference: scripts/modifyHmm "
        "-> cPecanModifyHmm; math at marginAlignLib.py:238-263).",
    )
    p.add_argument("inputHmm")
    p.add_argument("outputHmm")
    p.add_argument("--substitutionRate", type=float, default=None)
    p.add_argument("--gcContent", type=float, default=None)
    p.add_argument("--setFlatIndelEmissions", action="store_true")
    args = p.parse_args(argv)

    hmm = PairHmm.load(args.inputHmm)
    if args.setFlatIndelEmissions:
        hmm.set_flat_indel_emissions()
    if args.gcContent is not None:
        hmm.normalise_by_gc_content(args.gcContent)
    if args.substitutionRate is not None:
        hmm.modify_by_substitution_rate(args.substitutionRate)
    hmm.write(args.outputHmm)
    return 0


COMMANDS = {"marginAlign": margin_align_main,
            "marginCaller": margin_caller_main,
            "marginStats": margin_stats_main,
            "modifyHmm": modify_hmm_main,
            "uniquifyFastq": tools_cli.uniquify_fastq_main,
            "mutateReference": tools_cli.mutate_reference_main,
            "substitutions": tools_cli.substitutions_main,
            "kmerAnalysis": tools_cli.kmer_analysis_main,
            "createAssemblyHub": tools_cli.create_assembly_hub_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m marginalign_trna_tpu_torch {%s} ..."
              % ",".join(COMMANDS), file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])
