"""The port's aux tools (tools/, io/bam.py, io/twobit.py, io/cigar.py,
utils/mutate.py: host copies of the JAX package's), served as commands of
`python -m marginalign_trna_tpu_torch`, against the JAX package's tools on
synthetic inputs made from a numpy seed: the same files and the same
report."""
import os
import subprocess
import sys

import pytest

from marginalign_trna_tpu.io import cigar as jcigar
from marginalign_trna_tpu.io.sam import SamFile as JSamFile
from marginalign_trna_tpu.tools import cli as jtools
from marginalign_trna_tpu_torch import cli
from marginalign_trna_tpu_torch.io import cigar as tcigar
from marginalign_trna_tpu_torch.io.sam import SamFile
from marginalign_trna_tpu_torch.io.twobit import read_2bit_names_and_sizes

from test_torch_stats import _write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("tools"), seed=8)


def _files(top):
    """{relative path: bytes} of every file under top."""
    out = {}
    for d, _, names in os.walk(top):
        for f in names:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = fh.read()
    return out


def _both(tmp_path, command, jax_main, make_argv):
    """Run the port's `command` and the JAX package's `jax_main` with the
    arguments make_argv(output directory) gives; (port, JAX) output
    directories."""
    outs = []
    for tag in ("port", "jax"):
        out = tmp_path / tag
        out.mkdir()
        argv = make_argv(str(out))
        rc = (cli.main([command] + argv) if tag == "port"
              else jax_main(argv))
        assert rc == 0
        outs.append(str(out))
    return outs


def test_uniquify_fastq_matches_jax(tmp_path, corpus):
    _, fq, _ = corpus
    dup = tmp_path / "dup.fq"
    with open(fq) as fh:
        text = fh.read()
    dup.write_text(text + text + text)    # every name three times
    port, jax = _both(tmp_path, "uniquifyFastq", jtools.uniquify_fastq_main,
                      lambda out: [str(dup), os.path.join(out, "u.fq")])
    got, want = _files(port), _files(jax)
    assert got == want
    names = got["u.fq"].decode().splitlines()[::4]
    assert len(names) == len(set(names)) == 3 * text.count("@")


@pytest.mark.parametrize("rate,seed", [(0.2, 0), (0.05, 3)])
def test_mutate_reference_matches_jax(tmp_path, corpus, rate, seed):
    _, _, fa = corpus
    port, jax = _both(
        tmp_path, "mutateReference", jtools.mutate_reference_main,
        lambda out: [fa, os.path.join(out, "mut.fa"),
                     os.path.join(out, "muts.txt"), "--snpRate", str(rate),
                     "--seed", str(seed)])
    got = _files(port)
    assert got == _files(jax)
    assert len(got["muts.txt"].splitlines()) > 3


def test_substitutions_matches_jax(tmp_path, corpus, capsys):
    sam, fq, fa = corpus
    port, jax = _both(tmp_path, "substitutions", jtools.substitutions_main,
                      lambda out: [sam, fq, fa, out])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert out[0].startswith("identity: ")
    got, want = _files(port), _files(jax)
    for name in ("substitutions.xml", "substitutions.tsv"):
        assert got[name] == want[name]


@pytest.mark.parametrize("k", [3, 5])
def test_kmer_analysis_matches_jax(tmp_path, corpus, k):
    _, fq, fa = corpus
    port, jax = _both(
        tmp_path, "kmerAnalysis", jtools.kmer_analysis_main,
        lambda out: [fa, fq, os.path.join(out, "k"), "--kmerSize", str(k)])
    got = _files(port)
    assert got == _files(jax)
    assert len(got["k_all_bases_kmer_counts.txt"].splitlines()) == 4 ** k + 1


def test_create_assembly_hub_matches_jax(tmp_path, corpus, capsys):
    sam, _, fa = corpus
    port, jax = _both(
        tmp_path, "createAssemblyHub", jtools.create_assembly_hub_main,
        lambda out: [sam, fa, out, "--hubTag", "h", "--email", "a@b.c"])
    capsys.readouterr()
    got = _files(port)
    assert got == _files(jax)
    assert read_2bit_names_and_sizes(os.path.join(port, "h", "ref",
                                                  "ref.2bit")) == {
        "chrA": 300, "chrB": 240}
    assert any(p.endswith(".sorted.bam.bai") for p in got)


def test_exonerate_cigars_match_jax(corpus):
    """io/cigar.py: every record's exonerate cigar line, and its parse back,
    as the JAX package's."""
    sam, _, _ = corpus
    got = [tcigar.from_sam_record(r).to_string()
           for r in SamFile.read(sam).records]
    want = [jcigar.from_sam_record(r).to_string()
            for r in JSamFile.read(sam).records]
    assert got == want and len(got) == 8
    for line in got:
        assert tcigar.ExonerateCigar.from_string(line).to_string() == line
        assert (tcigar.ExonerateCigar.from_string(line).to_string()
                == jcigar.ExonerateCigar.from_string(line).to_string())


def test_tools_run_as_module_commands(tmp_path, corpus):
    """`python -m marginalign_trna_tpu_torch <tool>` in a fresh interpreter
    serves the tools and loads no jax* or JAX package module."""
    _, fq, fa = corpus
    code = (
        "import sys, runpy\n"
        "sys.argv = ['marginalign_trna_tpu_torch'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('marginalign_trna_tpu_torch',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'marginalign_trna_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for argv in (["uniquifyFastq", fq, str(tmp_path / "u.fq")],
                 ["kmerAnalysis", fa, fq, str(tmp_path / "k")]):
        proc = subprocess.run([sys.executable, "-c", code] + argv, cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "u.fq").exists()
