"""Port paired-end alignment (beam route, CPU) vs hsa_tpu's: byte-equal SAM,
with a mate rescue exercised; the command line's ``--engine``; and the
port's native-library loader."""

import os
import subprocess
import sys

import numpy as np
import pytest

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt
from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu.pipeline import build_index
from hsa_tpu.resolve import sampe
from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch import refpack as trefpack
from hsa_tpu_torch.pipeline import Aligner as TAligner
from hsa_tpu_torch.resolve.sampe import _rescue_batch as rescue_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 60


def _pairs(chrom, rs, n):
    """FR pairs with normal-ish inserts (tests/test_sampe.py:make_pairs),
    then a pair whose end 2 carries 6 mismatches (over the search budget of
    3, within the rescue's 9), a discordant pair (end 2 forward, far away)
    and a pair whose end 2 is random."""
    r1s, r2s = [], []
    for _ in range(n):
        ins = int(np.clip(rs.normal(300, 20), 2 * L + 10, 480))
        p = rs.randint(0, len(chrom) - ins - 1)
        r1s.append(chrom[p:p + L].copy())
        r2s.append(alphabet.revcomp(chrom[p + ins - L:p + ins]))
    r1s.append(chrom[5000:5000 + L].copy())
    r2 = alphabet.revcomp(chrom[5300 - L:5300])
    for q in (5, 15, 25, 35, 45, 55):
        r2[q] = (r2[q] + 1) % 4
    r2s.append(r2)
    r1s.append(chrom[9000:9000 + L].copy())
    r2s.append(chrom[15000:15000 + L].copy())
    r1s.append(chrom[12000:12000 + L].copy())
    r2s.append(rs.randint(0, 4, L).astype(np.int8))
    return r1s, r2s


def _write_fastq(path, names, reads):
    with open(path, "w") as fh:
        for nm, r in zip(names, reads):
            fh.write(f"@{nm}\n{alphabet.decode(r)}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def pe_corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pe")
    rs = np.random.RandomState(13)
    chrom = rs.randint(0, 4, 20_000).astype(np.int8)
    (tmp / "ref.fa").write_text(">c1\n" + alphabet.decode(chrom) + "\n")
    prefix = build_index(str(tmp / "ref.fa"), str(tmp / "ref"))
    r1s, r2s = _pairs(chrom, rs, 24)
    names = [f"p{j}" for j in range(len(r1s))]
    _write_fastq(tmp / "r1.fq", names, r1s)
    _write_fastq(tmp / "r2.fq", names, r2s)
    quals = ["I" * L] * len(r1s)
    return tmp, prefix, r1s, r2s, names, quals


@pytest.mark.parametrize("emit", ["records", "sam"])
def test_align_pe_byte_equal(pe_corpus, emit):
    _, prefix, r1s, r2s, names, quals = pe_corpus
    args = (r1s, r2s, names, quals, quals)
    want = JAligner(prefix, engine="beam").align_pe(*args, emit=emit)
    ta = TAligner(prefix, engine="beam", device="cpu")
    got = ta.align_pe(*args, emit=emit)
    if emit == "records":
        got, want = [r.to_sam() for r in got], [r.to_sam() for r in want]
    else:
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got == want
    assert ta.last_rescue_jobs >= 2
    rescued = [ln for ln in got if "XT:Z:M" in ln]
    assert rescued and rescued[0].startswith(f"p{len(r1s) - 3}\t")


def test_align_pe_stream_byte_equal(pe_corpus):
    _, prefix, r1s, r2s, names, quals = pe_corpus

    def batches():
        for s in range(0, len(r1s), 9):
            yield (s, names[s:s + 9], r1s[s:s + 9], quals[s:s + 9],
                   r2s[s:s + 9], quals[s:s + 9])

    want = list(JAligner(prefix, engine="beam").align_pe_stream(
        batches(), emit="sam"))
    got = list(TAligner(prefix, engine="beam", device="cpu").align_pe_stream(
        batches(), emit="sam"))
    assert [s for s, _ in got] == [0, 9, 18]
    assert got == want


def test_cli_align_pe_matches_jax_cli(pe_corpus):
    tmp, prefix, *_ = pe_corpus
    r1, r2 = str(tmp / "r1.fq"), str(tmp / "r2.fq")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "hsa_tpu.cli", "align-pe", prefix,
                        r1, r2, "--engine", "beam", "--batch", "10", "-f",
                        str(tmp / "jax.sam"), "--platform", "cpu"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    out, met = tmp / "port.sam", str(tmp / "m.json")
    args = ["align-pe", prefix, r1, r2, "--engine", "beam", "--batch", "10",
            "--device", "cpu", "-f", str(out), "--metrics", met]
    assert tcli.main(args) == 0
    port = out.read_text()
    assert port == (tmp / "jax.sam").read_text()
    assert "XT:Z:M" in port
    import json
    m = json.load(open(met))
    assert m["reads_in"] == 54 and m["config"]["device"] == "cpu"
    assert len(m["batches"]) == 3
    assert all("wait_s" in b and "rescue_jobs" in b for b in m["batches"])
    assert sum(b["rescue_jobs"] > 0 for b in m["batches"]) >= 1
    # --resume after a finished run appends nothing
    assert tcli.main(args + ["--resume"]) == 0
    assert out.read_text() == port


@pytest.mark.parametrize("what", ["sampe", "auto", "pigeon"])
def test_unported_paired_routes_raise(pe_corpus, what):
    """Every paired route runs and gives the reference's lines: ``align-pe
    --engine auto`` and ``pigeon``, and ``sampe`` over the ``.sai`` files of
    ``aln`` on each mate file (at the default engine, auto)."""
    tmp, prefix, r1s, r2s, names, quals = pe_corpus
    r1, r2 = str(tmp / "r1.fq"), str(tmp / "r2.fq")
    out = tmp / f"{what}.sam"
    if what == "sampe":
        sai = [str(tmp / f"m{m}.sai.npz") for m in (1, 2)]
        for fq, s in zip((r1, r2), sai):
            assert tcli.main(["aln", prefix, fq, "--device", "cpu", "-f",
                              s]) == 0
        assert tcli.main(["sampe", prefix, *sai, r1, r2, "--device", "cpu",
                          "-f", str(out)]) == 0
    else:
        assert tcli.main(["align-pe", prefix, r1, r2, "--engine", what,
                          "--device", "cpu", "-f", str(out)]) == 0
    got = [ln for ln in out.read_text().splitlines() if ln[0] != "@"]
    engine = "auto" if what == "sampe" else what
    want = JAligner(prefix, engine=engine).align_pe(r1s, r2s, names, quals,
                                                    quals, emit="sam")[0]
    assert got == want
    assert len(got) == 54 and any("XT:Z:M" in ln for ln in got)


def test_pe_path_never_imports_jax(pe_corpus):
    tmp, prefix, *_ = pe_corpus
    code = (
        "import sys\n"
        "from hsa_tpu_torch import cli\n"
        f"assert cli.main(['align-pe', {prefix!r}, {str(tmp / 'r1.fq')!r}, "
        f"{str(tmp / 'r2.fq')!r}, '--device', 'cpu', '-f', "
        f"{str(tmp / 'nojax.sam')!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hsa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
    assert "XT:Z:M" in (tmp / "nojax.sam").read_text()


@pytest.fixture
def racing_worker_state(monkeypatch, tmp_path):
    """The port's loader as a process finds it when another writer left the
    library cut short: nothing loaded yet, and a file in the build
    directory that ``ctypes`` refuses ("file too short") although its
    digest is the right one.  The build directory is a scratch one, so the
    real build is not disturbed."""
    build = tmp_path / "_build"
    build.mkdir()
    so = build / "librefpack.so"
    so.write_bytes(b"\x7fELF")
    (build / "librefpack.so.sha256").write_text(trefpack._digest() + "\n")
    monkeypatch.setattr(trefpack, "_lib", None)
    monkeypatch.setattr(trefpack, "BUILD_DIR", str(build))
    monkeypatch.setattr(trefpack, "_SO", str(so))
    return so


def _loaded_from(so):
    """The port's library is loaded, from ``so``, which is now whole."""
    return (trefpack._lib is not None and trefpack._lib._name == str(so)
            and so.stat().st_size > 10_000)


def test_cli_index_recovers_a_failed_native_load(racing_worker_state,
                                                 tmp_path):
    rs = np.random.RandomState(1)
    (tmp_path / "g.fa").write_text(
        ">g\n" + alphabet.decode(rs.randint(0, 4, 3000).astype(np.int8)) + "\n")
    assert tcli.main(["index", str(tmp_path / "g.fa")]) == 0
    assert _loaded_from(racing_worker_state)
    assert (tmp_path / "g.fa.hsa" / "index.npz").exists()


def test_rescue_recovers_a_failed_native_load(racing_worker_state):
    from hsa_tpu.io.fastx import RefMeta
    from hsa_tpu.resolve.samse import Occurrence
    rs = np.random.RandomState(2)
    text = rs.randint(0, 4, 2000).astype(np.int8)
    meta = RefMeta(names=["s"], starts=np.zeros(1, np.int64),
                   lengths=np.asarray([2000], np.int64), total=2000)
    mate = alphabet.revcomp(text[600:660])
    jobs = [(0, 2, Occurrence(400, 0, 0, 0, 0, 0), mate, 60)]
    got = list(rescue_batch(text, meta, jobs, 400, AlnOpt(), "cpu"))
    assert got[0][2] is not None and got[0][2].pos == 600
    assert _loaded_from(racing_worker_state)
    want = list(sampe._rescue_batch(text, meta, jobs, 400, AlnOpt()))
    assert [(j, e, vars(o)) for j, e, o in got] == \
        [(j, e, vars(o)) for j, e, o in want]


def test_stale_native_library_is_rebuilt(racing_worker_state):
    """A library that loads but was built from other sources or flags (its
    digest differs) is rebuilt, not loaded."""
    so = racing_worker_state
    digest = so.with_name("librefpack.so.sha256")
    trefpack.ensure_refpack()                  # now whole and loadable
    trefpack._lib, before = None, so.stat().st_ino
    digest.write_text("0" * 64 + "\n")
    x = np.arange(9, dtype=np.uint8) & 3
    assert (trefpack.unpack_2bit(trefpack.pack_2bit(x), 9) == x).all()
    assert _loaded_from(so) and so.stat().st_ino != before
    assert digest.read_text().strip() == trefpack._digest()
    # a second process-like start finds it current and builds nothing
    trefpack._lib, now = None, so.stat().st_ino
    trefpack.ensure_refpack()
    assert so.stat().st_ino == now


def test_processes_started_together_all_load_the_library(tmp_path):
    """Four processes on a tree without the library build it once, under
    the lock, and every one loads it."""
    import shutil
    skip = shutil.ignore_patterns("*.so", "__pycache__", "_build")
    shutil.copytree(os.path.join(REPO, "hsa_tpu_torch"),
                    tmp_path / "hsa_tpu_torch", ignore=skip)
    code = ("from hsa_tpu_torch import refpack\n"
            "import numpy as np\n"
            "x = np.arange(9, dtype=np.uint8) & 3\n"
            "assert (refpack.unpack_2bit(refpack.pack_2bit(x), 9) == x).all()\n"
            "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip() == "ok" for o, _ in outs)
    assert (tmp_path / "hsa_tpu_torch" / "_build" / "librefpack.so").exists()
    # no scratch build directory is left behind
    assert not [p for p in (tmp_path / "hsa_tpu_torch" / "_build").iterdir()
                if p.is_dir()]
