"""The port stands on its own: no module of ``hsa_tpu_torch`` and not
``chip_smoke.py`` imports ``hsa_tpu`` or ``jax``, and its command line runs
from index to SAM with neither loaded, on its own native library."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("hsa_tpu", "jax", "jaxlib")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "hsa_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    """Every module a source names in an import statement, wherever the
    statement stands (top level, function body, ``try`` block), plus the
    literal first arguments of ``__import__`` / ``import_module`` calls."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) in \
                ("__import__", "import_module"):
            yield node.args[0].value, node.lineno


def test_sources_are_found():
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"chip_smoke.py", "hsa_tpu_torch/cli.py", "hsa_tpu_torch/refpack.py",
            "hsa_tpu_torch/resolve/sampe.py",
            "hsa_tpu_torch/kernels/select.py"} <= rel


@pytest.mark.parametrize("path", [os.path.relpath(p, REPO)
                                  for p in _port_sources()])
def test_source_imports_nothing_of_the_jax_package(path):
    bad = [(mod, line) for mod, line in _imports(os.path.join(REPO, path))
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_native_sources_are_the_ports_own():
    """The native library builds from the sources under
    ``hsa_tpu_torch/csrc`` and into ``hsa_tpu_torch/_build``."""
    from hsa_tpu_torch import refpack
    pkg = os.path.join(REPO, "hsa_tpu_torch")
    assert refpack._SO == os.path.join(pkg, "_build", "librefpack.so")
    for name in refpack._SOURCES:
        assert os.path.isfile(os.path.join(pkg, "csrc", name))
    assert refpack.ensure_refpack()._name == refpack._SO


SCRIPT = r"""
import os, sys
from hsa_tpu_torch import cli

def snapshot(d):
    return {f: (os.stat(os.path.join(d, f)).st_mtime_ns,
                os.stat(os.path.join(d, f)).st_size)
            for f in sorted(os.listdir(d))} if os.path.isdir(d) else None

ref_dir = os.path.join(os.getcwd(), "hsa_tpu", "refpack")
before = snapshot(ref_dir)
tmp = sys.argv[1]
fa = os.path.join(tmp, "ref.fa")
assert cli.main(["index", fa]) == 0
assert cli.main(["align", fa, os.path.join(tmp, "reads.fq"), "--engine",
                 "beam", "--device", "cpu", "--batch", "16", "-f",
                 os.path.join(tmp, "se.sam")]) == 0
# paired ends at the default engine (auto), then on the adaptive beam
assert cli.main(["align-pe", fa, os.path.join(tmp, "r1.fq"),
                 os.path.join(tmp, "r2.fq"), "--device", "cpu", "--batch",
                 "16", "-f", os.path.join(tmp, "pe.sam"), "--metrics",
                 os.path.join(tmp, "pe.json")]) == 0
assert cli.main(["align-pe", fa, os.path.join(tmp, "r1.fq"),
                 os.path.join(tmp, "r2.fq"), "--engine", "beam", "--ladder",
                 "8,64", "--device", "cpu", "--batch", "16", "-f",
                 os.path.join(tmp, "pe_ladder.sam")]) == 0
# the two-phase flow: aln on each mate file, then samse and sampe
for m in ("1", "2"):
    assert cli.main(["aln", fa, os.path.join(tmp, f"r{m}.fq"), "--device",
                     "cpu", "--batch", "16", "-f",
                     os.path.join(tmp, f"r{m}.sai.npz")]) == 0
assert cli.main(["samse", fa, os.path.join(tmp, "r1.sai.npz"),
                 os.path.join(tmp, "r1.fq"), "--device", "cpu", "-f",
                 os.path.join(tmp, "samse.sam")]) == 0
assert cli.main(["sampe", fa, os.path.join(tmp, "r1.sai.npz"),
                 os.path.join(tmp, "r2.sai.npz"), os.path.join(tmp, "r1.fq"),
                 os.path.join(tmp, "r2.fq"), "--device", "cpu", "-f",
                 os.path.join(tmp, "sampe.sam")]) == 0
# the default engine, auto: the pigeonhole engine, here seeded with 6-mers
# (12 is for genomes of 2^24 bp and more) so that its table cache is written
from hsa_tpu_torch.pipeline import Aligner
Aligner._kmer_k = 6
assert cli.main(["align", fa, os.path.join(tmp, "reads.fq"), "--device", "cpu",
                 "--batch", "16", "-f", os.path.join(tmp, "auto.sam"),
                 "--metrics", os.path.join(tmp, "auto.json")]) == 0
assert sorted(os.listdir(fa + ".hsa")) == ["index.npz", "kmer6.npz",
                                           "meta.json", "text.pac"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("hsa_tpu", "jax", "jaxlib"))
assert not bad, bad
assert snapshot(ref_dir) == before, "hsa_tpu/refpack was written to"
assert not os.path.isdir("hsa_tpu") or not any(
    f.startswith("kmer") for _, _, fs in os.walk("hsa_tpu") for f in fs)
from hsa_tpu_torch import refpack
build = os.path.join(os.getcwd(), "hsa_tpu_torch", "_build")
assert refpack._lib._name == os.path.join(build, "librefpack.so")
print("ok")
"""


def _fastq(path, prefix, reads):
    with open(path, "w") as fh:
        for j, r in enumerate(reads):
            seq = "".join("ACGT"[c] for c in r)
            fh.write(f"@{prefix}{j}\n{seq}\n+\n{'I' * len(r)}\n")


@pytest.mark.parametrize("tree", ["repo", "port_alone"])
def test_cli_runs_without_the_jax_package(tmp_path, tree):
    """``index``, ``align`` (beam, then the default ``--engine auto``),
    ``align-pe`` (the default ``auto``, then ``--engine beam --ladder
    8,64``) and the two-phase flow (``aln`` on each mate file, ``samse``,
    ``sampe``) in a fresh process: neither
    ``hsa_tpu`` nor ``jax`` is in ``sys.modules`` afterwards, the library
    loaded is the port's build, and ``hsa_tpu/refpack/`` is untouched.
    With ``port_alone`` the process runs in a directory that holds only a
    copy of ``hsa_tpu_torch``: there is no ``hsa_tpu`` to import at all,
    and the port builds its library there."""
    rs = np.random.RandomState(31)
    chrom = rs.randint(0, 4, 12_000)
    L = 50
    (tmp_path / "ref.fa").write_text(
        ">c1\n" + "".join("ACGT"[c] for c in chrom) + "\n")
    reads, r1s, r2s = [], [], []
    for j in range(20):
        p = rs.randint(0, len(chrom) - 400)
        r = chrom[p:p + L].copy()
        r[rs.randint(0, L)] ^= 1
        reads.append(3 - r[::-1] if j % 2 else r)
        r1s.append(chrom[p:p + L])
        r2 = 3 - chrom[p + 250 - L:p + 250][::-1]
        if j == 19:                      # over the search budget: a rescue
            r2 = r2.copy()
            r2[[5, 13, 21, 29, 37, 45]] ^= 2
        r2s.append(r2)
    _fastq(tmp_path / "reads.fq", "r", reads)
    _fastq(tmp_path / "r1.fq", "p", r1s)
    _fastq(tmp_path / "r2.fq", "p", r2s)
    cwd = REPO
    if tree == "port_alone":
        cwd = tmp_path / "tree"
        shutil.copytree(os.path.join(REPO, "hsa_tpu_torch"),
                        cwd / "hsa_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                       capture_output=True, text=True, cwd=cwd, env=env,
                       timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-3000:]
    se = [ln for ln in (tmp_path / "se.sam").read_text().splitlines()
          if not ln.startswith("@")]
    pe = [ln for ln in (tmp_path / "pe.sam").read_text().splitlines()
          if not ln.startswith("@")]
    assert len(se) == 20 and len(pe) == 40
    # the two-phase flow: sampe gives align-pe's records, samse maps end 1
    two = [ln for ln in (tmp_path / "sampe.sam").read_text().splitlines()
           if not ln.startswith("@")]
    assert two == pe
    samse = [ln for ln in (tmp_path / "samse.sam").read_text().splitlines()
             if not ln.startswith("@")]
    assert [ln.split("\t")[:4] for ln in samse] == \
        [[f"p{j}", "0", "c1", ln.split("\t")[3]] for j, ln in enumerate(samse)]
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in se) == 20
    # the pigeon route places every read where the beam does
    auto = [ln for ln in (tmp_path / "auto.sam").read_text().splitlines()
            if not ln.startswith("@")]
    assert [ln.split("\t")[:6] for ln in auto] == \
        [ln.split("\t")[:6] for ln in se]
    import json
    met = json.load(open(tmp_path / "auto.json"))
    assert met["config"]["engine"] == "auto" and met["reads_mapped"] == 20
    assert any("XT:Z:M" in ln for ln in pe)
    # paired ends ran on the default engine, auto, and the adaptive beam
    # places every end where it does
    assert json.load(open(tmp_path / "pe.json"))["config"]["engine"] == "auto"
    lad = [ln for ln in (tmp_path / "pe_ladder.sam").read_text().splitlines()
           if not ln.startswith("@")]
    assert [ln.split("\t")[:4] for ln in lad] == \
        [ln.split("\t")[:4] for ln in pe]


PROBE_SCRIPT = r"""
import runpy, sys
sys.argv = sys.argv[1:]
if sys.argv[0].endswith(".occ_probe5"):
    # its 2^20 ranks a call take minutes on the CPU: a smaller batch
    from hsa_tpu_torch.tools import occ_probe5
    occ_probe5.Q = 4096
    occ_probe5.main(sys.argv[1:])
else:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("hsa_tpu", "jax", "jaxlib"))
assert not bad, bad
print("ok")
"""
# one probe of each of the port's probe modules, with what it must print
PROBES = [("gather_probe", ["dma"], "pallas DMA gather: "),
          ("gather_probe2", ["rowloop"], "rowloop [1MB] Q=16K: "),
          ("gather_probe3", ["grid"], "grid chunk=32: "),
          ("sync_probe", ["vmemtake"], "pallas VMEM take [4MB] Q=2^17: "),
          ("occ_probe5", [], "chained occ [full len=128]")]


@pytest.mark.parametrize("name,args,line", PROBES,
                         ids=[p[0] for p in PROBES])
def test_probe_runs_without_the_jax_package(tmp_path, name, args, line):
    """``python -m hsa_tpu_torch.tools.<name> --device cpu ...`` in a
    directory that holds only a copy of ``hsa_tpu_torch``: it runs, its own
    check passes, and neither ``hsa_tpu`` nor ``jax`` is loaded."""
    cwd = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "hsa_tpu_torch"), cwd / "hsa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    if name == "occ_probe5":
        from hsa_tpu_torch.pipeline import build_index
        chrom = np.random.RandomState(5).randint(0, 4, 20_000)
        (tmp_path / "ref.fa").write_text(
            ">c1\n" + "".join("ACGT"[c] for c in chrom) + "\n")
        build_index(str(tmp_path / "ref.fa"), str(tmp_path / "ref"))
        args = args + ["--index", str(tmp_path / "ref")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE_SCRIPT,
                        f"hsa_tpu_torch.tools.{name}", "--device", "cpu",
                        *args], capture_output=True, text=True, cwd=cwd,
                       env=env, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-3000:]
    assert line in r.stdout and "FAILED" not in r.stdout, r.stdout
    if name != "occ_probe5":
        assert "correct=True" in r.stdout and "correct=False" not in r.stdout
