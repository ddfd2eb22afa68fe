"""The PyTorch port imports no JAX, and its CLI never drops to the CPU on
its own."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "marginalign_trna_tpu_torch",
    "marginalign_trna_tpu_torch.__main__",
    "marginalign_trna_tpu_torch.cli",
    "marginalign_trna_tpu_torch.pipeline",
    "marginalign_trna_tpu_torch.align",
    "marginalign_trna_tpu_torch.align.guide",
    "marginalign_trna_tpu_torch.align.realign",
    "marginalign_trna_tpu_torch.ops",
    "marginalign_trna_tpu_torch.ops._build",
    "marginalign_trna_tpu_torch.ops.band",
    "marginalign_trna_tpu_torch.ops.dispatch",
    "marginalign_trna_tpu_torch.ops.fb",
    "marginalign_trna_tpu_torch.ops.fb_cuda",
    "marginalign_trna_tpu_torch.ops.mea",
    "marginalign_trna_tpu_torch.ops.nw",
    "marginalign_trna_tpu_torch.ops.wavefront_cuda",
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


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k.startswith('jaxlib'))\n"
        "print(bad)\n"
        "assert not bad, bad\n" % (PORT_MODULES,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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


def test_cli_refuses_em_and_unknown_commands(tmp_path):
    from marginalign_trna_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="EM"):
        cli.margin_align_main(["r.fq", "ref.fa", "o.sam", "--em",
                               "--device", "cpu"])
    assert cli.main(["marginCaller"]) == 2
