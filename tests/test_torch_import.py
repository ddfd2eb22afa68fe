"""The PyTorch port imports nothing of JAX or of the JAX package, even after
running both of its commands (marginAlign with and without --em, and --em
over multi-problem lanes), and its CLI never drops to the CPU on its
own."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "marginalign_trna_tpu_torch",
    "marginalign_trna_tpu_torch.__main__",
    "marginalign_trna_tpu_torch.align",
    "marginalign_trna_tpu_torch.align.chain",
    "marginalign_trna_tpu_torch.align.checkpoint",
    "marginalign_trna_tpu_torch.align.em",
    "marginalign_trna_tpu_torch.align.guide",
    "marginalign_trna_tpu_torch.align.realign",
    "marginalign_trna_tpu_torch.call",
    "marginalign_trna_tpu_torch.call.caller",
    "marginalign_trna_tpu_torch.cli",
    "marginalign_trna_tpu_torch.io",
    "marginalign_trna_tpu_torch.io.fasta",
    "marginalign_trna_tpu_torch.io.bam",
    "marginalign_trna_tpu_torch.io.cigar",
    "marginalign_trna_tpu_torch.io.fastq",
    "marginalign_trna_tpu_torch.io.sam",
    "marginalign_trna_tpu_torch.io.twobit",
    "marginalign_trna_tpu_torch.io.vcf",
    "marginalign_trna_tpu_torch.models",
    "marginalign_trna_tpu_torch.models.hmm",
    "marginalign_trna_tpu_torch.native",
    "marginalign_trna_tpu_torch.ops",
    "marginalign_trna_tpu_torch.ops._build",
    "marginalign_trna_tpu_torch.ops.band",
    "marginalign_trna_tpu_torch.ops.bucket_scatter",
    "marginalign_trna_tpu_torch.ops.dispatch",
    "marginalign_trna_tpu_torch.ops.expectations",
    "marginalign_trna_tpu_torch.ops.fb",
    "marginalign_trna_tpu_torch.ops.fb_circ",
    "marginalign_trna_tpu_torch.ops.fb_circ_cuda",
    "marginalign_trna_tpu_torch.ops.fb_counts",
    "marginalign_trna_tpu_torch.ops.fb_counts_cuda",
    "marginalign_trna_tpu_torch.ops.fb_cuda",
    "marginalign_trna_tpu_torch.ops.fb_generic_cuda",
    "marginalign_trna_tpu_torch.ops.fb_multi_cuda",
    "marginalign_trna_tpu_torch.ops.mea",
    "marginalign_trna_tpu_torch.ops.nw",
    "marginalign_trna_tpu_torch.ops.traceback_device",
    "marginalign_trna_tpu_torch.ops.wavefront_cuda",
    "marginalign_trna_tpu_torch.pipeline",
    "marginalign_trna_tpu_torch.stats",
    "marginalign_trna_tpu_torch.stats.stats",
    "marginalign_trna_tpu_torch.tools",
    "marginalign_trna_tpu_torch.tools.assembly_hub",
    "marginalign_trna_tpu_torch.tools.cli",
    "marginalign_trna_tpu_torch.tools.kmer",
    "marginalign_trna_tpu_torch.tools.plots",
    "marginalign_trna_tpu_torch.tools.substitutions",
    "marginalign_trna_tpu_torch.utils",
    "marginalign_trna_tpu_torch.utils.coords",
    "marginalign_trna_tpu_torch.utils.mutate",
    "marginalign_trna_tpu_torch.utils.seq",
]


def test_port_package_lists_every_module():
    pkg = os.path.join(ROOT, "marginalign_trna_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[: -len(".__init__")]
                          if mod.endswith(".__init__") else mod)
    assert found == set(PORT_MODULES)


_RUN_BOTH_COMMANDS = """
import importlib, os, sys
import numpy as np
for m in %r:
    importlib.import_module(m)
from marginalign_trna_tpu_torch import cli, pipeline
tmp = sys.argv[1]
rng = np.random.default_rng(2)
bases = np.array(list("ACGT"))
refs = [rng.integers(0, 4, 300), rng.integers(0, 4, 260)]
with open(os.path.join(tmp, "ref.fa"), "w") as fh:
    for i, r in enumerate(refs):
        fh.write(">ref%%d\\n%%s\\n" %% (i, "".join(bases[r])))
with open(os.path.join(tmp, "reads.fq"), "w") as fh:
    for k in range(6):
        read = refs[k %% 2][10:230].copy()
        read[rng.random(len(read)) < 0.05] = 1
        s = "".join(bases[read])
        fh.write("@r%%d\\n%%s\\n+\\n%%s\\n" %% (k, s, "I" * len(s)))
fq, fa = os.path.join(tmp, "reads.fq"), os.path.join(tmp, "ref.fa")
sam, vcf = os.path.join(tmp, "out.sam"), os.path.join(tmp, "out.vcf")
assert cli.main(["marginAlign", fq, fa, sam, "--device", "cpu"]) == 0
assert cli.main(["marginCaller", sam, fa, vcf, "--device", "cpu"]) == 0
assert os.path.getsize(vcf) > 0
assert cli.main(["marginStats", sam, fq, fa, "--readIdentity"]) == 0
assert cli.main(["modifyHmm", pipeline.DEFAULT_MODEL, os.path.join(tmp,
                 "mod.hmm"), "--setFlatIndelEmissions"]) == 0
pipeline.align_and_call(fq, fa, os.path.join(tmp, "ac.sam"),
                        os.path.join(tmp, "ac.vcf"), device="cpu")
model = os.path.join(tmp, "em.hmm")
assert cli.main(["marginAlign", fq, fa, os.path.join(tmp, "em.sam"), "--em",
                 "--iterations", "2", "--trials", "2", "--outputModel",
                 model, "--device", "cpu"]) == 0
assert all(os.path.exists(model + s) for s in ("", ".trial0", ".trial1"))
from marginalign_trna_tpu_torch.align.em import EmOptions
pipeline.align(fq, fa, os.path.join(tmp, "em_multi.sam"),
               pipeline.AlignOptions(em=True, em_options=EmOptions(
                   iterations=1, trials=2)), device="cpu", multi=True)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "marginalign_trna_tpu"))
print(bad)
assert not bad, bad
"""


def test_importing_the_port_loads_no_jax(tmp_path):
    """Import every port module, run marginAlign, marginCaller,
    marginStats, modifyHmm, pipeline.align_and_call, marginAlign --em and
    --em over multi-problem lanes (pipeline.align with multi=True) on the
    CPU on a tiny corpus, in a fresh interpreter: no jax*, no
    marginalign_trna_tpu module may be loaded."""
    code = _RUN_BOTH_COMMANDS % (PORT_MODULES,)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_cli_default_device_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from marginalign_trna_tpu_torch import cli

    fq = tmp_path / "r.fq"
    fa = tmp_path / "ref.fa"
    fq.write_text("@r0\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n")
    fa.write_text(">ref\nACGTACGTACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.margin_align_main([str(fq), str(fa), str(tmp_path / "o.sam")])
    assert not (tmp_path / "o.sam").exists()


def _tiny_corpus(tmp_path):
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 240)
    fa = tmp_path / "ref.fa"
    fa.write_text(">ref\n%s\n" % "".join("ACGT"[c] for c in ref))
    lines = []
    for k in range(4):
        read = ref[5 + k:200 + k].copy()
        read[rng.random(len(read)) < 0.05] = 2
        s = "".join("ACGT"[c] for c in read)
        lines.append("@r%d\n%s\n+\n%s\n" % (k, s, "I" * len(s)))
    fq = tmp_path / "r.fq"
    fq.write_text("".join(lines))
    return str(fq), str(fa)


def test_cli_em_runs_on_cpu(tmp_path):
    """marginAlign --em trains (two lockstep trials, two iterations), writes
    the model, its trial models and the XML dump, and realigns with it."""
    from marginalign_trna_tpu_torch import cli
    from marginalign_trna_tpu_torch.models.hmm import PairHmm

    fq, fa = _tiny_corpus(tmp_path)
    model = str(tmp_path / "m.hmm")
    out = tmp_path / "o.sam"
    assert cli.margin_align_main([
        fq, fa, str(out), "--em", "--iterations", "2", "--trials", "2",
        "--outputModel", model, "--outputXMLModelFile",
        str(tmp_path / "m.xml"), "--device", "cpu"]) == 0
    trained = PairHmm.load(model)          # checks the rows are stochastic
    assert np.allclose(trained.emissions[1:], 1.0 / 16)   # normalised
    assert trained.likelihood < 0
    for t in (0, 1):
        PairHmm.load(model + ".trial%d" % t)
    assert (tmp_path / "m.xml").stat().st_size > 0
    records = [ln for ln in out.read_text().splitlines()
               if not ln.startswith("@")]
    assert len(records) == 4


_RUN_UPDATE_THE_BAND = """
import sys
from marginalign_trna_tpu_torch import cli
fq, fa, out = sys.argv[1:4]
assert cli.main(["marginAlign", fq, fa, out, "--em", "--updateTheBand",
                 "--iterations", "2", "--trials", "2", "--device", "cpu"]) == 0
print(sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "marginalign_trna_tpu")))
"""


def test_cli_refuses_em_and_unknown_commands(tmp_path):
    """marginAlign --em --updateTheBand trains on the tiny corpus (the band
    re-derived through the generic forward-backward pair, ROADMAP B15) and
    realigns every read, in a fresh interpreter that loads no jax* module;
    unknown commands exit with 2."""
    from marginalign_trna_tpu_torch import cli

    fq, fa = _tiny_corpus(tmp_path)
    out = tmp_path / "o.sam"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_UPDATE_THE_BAND, fq, fa, str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    records = [ln for ln in out.read_text().splitlines()
               if not ln.startswith("@")]
    assert len(records) == 4
    # marginCaller and marginStats are commands now: without their
    # arguments argparse exits 2.
    for command in ("marginCaller", "marginStats"):
        with pytest.raises(SystemExit) as exc:
            cli.main([command])
        assert exc.value.code == 2
    assert cli.main(["marginNoSuchCommand"]) == 2
