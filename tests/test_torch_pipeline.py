"""Port Aligner and CLI (CPU) vs hsa_tpu's: byte-equal SAM on the beam route,
and the routes that are and are not ported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hsa_tpu import alphabet
from hsa_tpu.config import SamseOpt
from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu.pipeline import build_index
from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch.pipeline import Aligner as TAligner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(chrom, rs, n=30, L=70):
    reads = []
    for j in range(n):
        p = rs.randint(0, len(chrom) - L - 2)
        r = chrom[p:p + L + (1 if j % 4 == 0 else 0)].copy()
        if j % 4 == 0:                         # 1-bp deletion
            cut = rs.randint(10, L - 10)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        q = rs.choice(L, size=j % 3, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, q.size)) % 4
        if j % 7 == 3:
            r[rs.randint(0, L)] = 4               # an N
        if j % 2:
            r = alphabet.revcomp(r)
        reads.append(r.astype(np.int8))
    reads.append(rs.randint(0, 4, 60).astype(np.int8))   # unalignable
    return reads


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipe")
    rs = np.random.RandomState(5)
    chrom = rs.randint(0, 4, 5000).astype(np.int8)
    (tmp / "ref.fa").write_text(">chrT\n" + alphabet.decode(chrom) + "\n")
    prefix = build_index(str(tmp / "ref.fa"), str(tmp / "ref"))
    reads = _reads(chrom, rs)
    names = [f"q{j}" for j in range(len(reads))]
    quals = ["I" * len(r) for r in reads]
    return prefix, reads, names, quals


def test_align_sam_byte_equal(corpus):
    prefix, reads, names, quals = corpus
    want = JAligner(prefix, engine="beam").align(reads, names, quals)
    got = TAligner(prefix, engine="beam", device="cpu").align(reads, names,
                                                               quals)
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    assert sum(not r.flag & 4 for r in got) >= len(reads) - 3


def test_align_stream_sam_byte_equal(corpus):
    prefix, reads, names, quals = corpus

    def batches():
        for s in range(0, len(reads), 8):
            yield s, names[s:s + 8], reads[s:s + 8], quals[s:s + 8]

    sopt = SamseOpt(n_multi=2)
    ja = JAligner(prefix, engine="beam")
    ta = TAligner(prefix, engine="beam", device="cpu")
    want = list(ja.align_stream(batches(), sopt=sopt, emit="sam"))
    got = list(ta.align_stream(batches(), sopt=sopt, emit="sam"))
    assert [s for s, _ in got] == [0, 8, 16, 24]
    assert got == want
    np.testing.assert_array_equal(ta.last_overflow[0], ja.last_overflow[0])


def test_resolve_handle_matches_jax(corpus):
    """The library's two-phase API, search_batch_device then
    resolve_handle, gives hsa_tpu's records byte for byte: the default
    names from read_offset, and given names and qualities."""
    prefix, reads, names, quals = corpus
    ja = JAligner(prefix, engine="beam")
    ta = TAligner(prefix, engine="beam", device="cpu")
    sopt = SamseOpt(n_multi=2)
    for kw in (dict(read_offset=7), dict(names=names, quals=quals, sopt=sopt)):
        want = ja.resolve_handle(ja.search_batch_device(reads), reads, **kw)
        got = ta.resolve_handle(ta.search_batch_device(reads), reads, **kw)
        assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    assert got[0].qname == names[0] and want[0].qname == names[0]
    np.testing.assert_array_equal(ta.last_overflow[0], ja.last_overflow[0])


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """The tests/test_cli.py corpus: 20 reads of 60 bp on a 5 kbp genome."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rs = np.random.RandomState(3)
    chrom = "".join("ACGT"[i] for i in rs.randint(0, 4, 5000))
    (tmp / "ref.fa").write_text(f">seq1\n{chrom}\n")
    with open(tmp / "reads.fq", "w") as fh:
        for i in range(20):
            p = rs.randint(0, 5000 - 60)
            s = list(chrom[p:p + 60])
            if i % 3 == 1:
                j = rs.randint(5, 55)
                s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
            fh.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * 60}\n")
    assert tcli.main(["index", str(tmp / "ref.fa")]) == 0
    return tmp


def test_cli_matches_jax_cli(cli_corpus):
    ref, fq = str(cli_corpus / "ref.fa"), str(cli_corpus / "reads.fq")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "hsa_tpu.cli", "align", ref, fq,
                        "--engine", "beam", "--batch", "8", "-f",
                        str(cli_corpus / "jax.sam"), "--platform", "cpu"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    out = str(cli_corpus / "port.sam")
    met = str(cli_corpus / "m.json")
    args = ["align", ref, fq, "--engine", "beam", "--batch", "8", "--device",
            "cpu", "-f", out, "--metrics", met]
    assert tcli.main(args) == 0
    port = (cli_corpus / "port.sam").read_text()
    assert port == (cli_corpus / "jax.sam").read_text()
    assert len([l for l in port.splitlines() if not l.startswith("@")]) == 20
    import json
    m = json.load(open(met))
    assert m["reads_in"] == 20 and m["config"]["device"] == "cpu"
    assert len(m["batches"]) == 3 and all("wait_s" in b for b in m["batches"])
    # --resume after a finished run appends nothing
    assert tcli.main(args + ["--resume"]) == 0
    assert (cli_corpus / "port.sam").read_text() == port


def test_cli_profile_writes_a_trace(cli_corpus):
    """--profile aligns batch by batch (records path) and writes a
    torch.profiler trace of the first; the SAM equals the streamed one."""
    ref, fq = str(cli_corpus / "ref.fa"), str(cli_corpus / "reads.fq")
    prof = cli_corpus / "prof"
    out = cli_corpus / "prof.sam"
    assert tcli.main(["align", ref, fq, "--batch", "8", "--device", "cpu",
                      "-f", str(out), "--profile", str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    streamed = cli_corpus / "streamed.sam"
    assert tcli.main(["align", ref, fq, "--batch", "8", "--device", "cpu",
                      "-f", str(streamed)]) == 0
    assert out.read_text() == streamed.read_text()


def test_port_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from hsa_tpu.index.layout import build_device_index\n"
        "from hsa_tpu_torch.pipeline import Aligner\n"
        "t = np.random.RandomState(0).randint(0, 4, 3000).astype(np.int8)\n"
        "al = Aligner.from_arrays(build_device_index(t), t, device='cpu')\n"
        "recs = al.align([t[100:160].copy()])\n"
        "assert recs[0].pos == 101, recs[0]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


@pytest.mark.parametrize("engine", ["auto", "pigeon"])
def test_unported_engines_raise(corpus, engine):
    """Single and paired ends run on both engines (the 70 bp reads are all
    eligible); what raises is an engine that does not exist."""
    prefix, reads, names, quals = corpus
    al = TAligner(prefix, engine=engine, device="cpu")
    got = al.align(reads, names, quals)
    want = JAligner(prefix, engine=engine).align(reads, names, quals)
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    assert al.last_ineligible_frac == 0.0
    ja = JAligner(prefix, engine=engine)
    pe = al.align_pe(reads[:4], reads[4:8], names[:4])
    assert [r.to_sam() for r in pe] == \
        [r.to_sam() for r in ja.align_pe(reads[:4], reads[4:8], names[:4])]
    assert len(pe) == 8 and sum(not r.flag & 4 for r in pe) >= 6
    with pytest.raises(ValueError, match="unknown engine"):
        TAligner(prefix, engine="seed", device="cpu")


def test_ladder_raises(corpus, cli_corpus):
    """The ladder runs: ``Aligner(ladder=...)`` on the beam and on ``auto``
    and ``align --ladder 8,64`` give the reference's records.  What raises
    is an engine the command line does not know."""
    prefix, reads, names, quals = corpus
    for engine in ("beam", "auto"):
        ta = TAligner(prefix, ladder=(8, 64), engine=engine, device="cpu")
        ja = JAligner(prefix, ladder=(8, 64), engine=engine)
        assert [r.to_sam() for r in ta.align(reads, names, quals)] == \
            [r.to_sam() for r in ja.align(reads, names, quals)]
    out = cli_corpus / "l.sam"
    assert tcli.main(["align", str(cli_corpus / "ref.fa"),
                      str(cli_corpus / "reads.fq"), "--engine", "beam",
                      "--device", "cpu", "--ladder", "8,64", "--batch", "8",
                      "-f", str(out)]) == 0
    got = [ln for ln in out.read_text().splitlines() if ln[0] != "@"]
    from hsa_tpu.cli import _stream_batches
    ja = JAligner(str(cli_corpus / "ref.fa"), ladder=(8, 64), engine="beam")
    want = [ln for _, (lines, _f) in ja.align_stream(
        _stream_batches(str(cli_corpus / "reads.fq"), 8), emit="sam")
        for ln in lines]
    assert got == want and len(got) == 20
    with pytest.raises(SystemExit):
        tcli.main(["align", str(cli_corpus / "ref.fa"),
                   str(cli_corpus / "reads.fq"), "--engine", "seed"])


def test_cuda_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAligner(corpus[0], engine="beam", device="cuda")
