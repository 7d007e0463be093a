"""The port's two-phase flow (``aln`` -> ``.sai.npz`` -> ``samse`` /
``sampe``) against ``hsa_tpu``'s, on the CPU.  Integer work and text:
tolerance 0.  Every ``.sai`` array equal in dtype and value (never the
file's bytes: zip timestamps differ), every SAM byte-equal, header
included.

The inputs are ``test_torch_pe_pigeon.py``'s: the diverged repeat family,
three batches of 8 pairs of 70 bp (family pairs, a mate to rescue and two
200 bp ends, which the router hands to the beam, in the first).  The port
runs in process; the reference runs once per module, every command of it
in one process, so that JAX compiles few shapes.  Its last run sets the
small capacity caps with the repeat profile free to move, so that
``aln``'s inline retry and beam fallback run batch by batch.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hsa_tpu import alphabet
from hsa_tpu import cli as jcli
from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch.pipeline import Aligner as TAligner
from test_torch_pe_pigeon import (_write_fastq, mk_batch, with_long_ends,
                                  with_rescue)
from test_torch_pigeon import repeat_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = "8"
# small caps: capacity misses, seg_phase retries and, at the small retry
# caps, dual failures for the beam; the repeat profile's threshold is the
# default, so the profile moves between batches
CAPS = dict(_PIGEON_SEG_CAP=4, _PIGEON_CAND_CAP=8, _PIGEON_RETRY_CAPS=(6, 8, 4))
TRIM_LEN, TRIM_KEEP = 60, 48

# every reference command, in one process; argv[1] is the work directory
REF_SCRIPT = r"""
import json
import sys
from hsa_tpu import cli
from hsa_tpu.pipeline import Aligner
d = sys.argv[1]
caps = json.loads(sys.argv[2])
ref = f"{d}/ref.fa"


def run(*args):
    assert cli.main(list(args) + ["--platform", "cpu"]) == 0, args


run("aln", ref, f"{d}/r1.fq", "--batch", "8", "-f", f"{d}/j1.sai.npz",
    "--metrics", f"{d}/j_aln.json")
run("aln", ref, f"{d}/r2.fq", "--batch", "8", "-f", f"{d}/j2.sai.npz")
run("aln", ref, f"{d}/r1.fq", "--batch", "8", "--engine", "beam", "-f",
    f"{d}/j1_beam.sai.npz")
run("aln", ref, f"{d}/trim.fq", "-n", "2", "-q", "15", "-f",
    f"{d}/j_trim.sai.npz")
for tag, a, b in (("j", "j1", "j2"), ("jt", "t1", "t2")):
    run("samse", ref, f"{d}/{a}.sai.npz", f"{d}/r1.fq", "-f",
        f"{d}/{tag}_se.sam", "--metrics", f"{d}/{tag}_samse.json")
    run("sampe", ref, f"{d}/{a}.sai.npz", f"{d}/{b}.sai.npz", f"{d}/r1.fq",
        f"{d}/r2.fq", "-f", f"{d}/{tag}_pe.sam", "--metrics",
        f"{d}/{tag}_sampe.json")
for k, v in caps.items():
    setattr(Aligner, k, tuple(v) if isinstance(v, list) else v)
run("aln", ref, f"{d}/fam.fq", "--batch", "8", "-n", "2", "-f",
    f"{d}/j_caps.sai.npz", "--metrics", f"{d}/j_aln_caps.json")
print("ok")
"""


def port(*args):
    assert tcli.main(list(args)) == 0, args


def body(path):
    return [ln for ln in open(path).read().splitlines() if ln[0] != "@"]


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The work directory: genome, index, reads; the port's ``.sai`` files
    (which the reference resolves too) and every reference output."""
    d = tmp_path_factory.mktemp("aln")
    text, starts = repeat_text(seed=9, div=0.04)
    g = type("G", (), dict(text=text, starts=starts))
    (d / "ref.fa").write_text(">c1\n" + alphabet.decode(text) + "\n")
    r1s, r2s = with_long_ends(g, *with_rescue(g, *mk_batch(g, 3)))
    for seed, n_fam in ((4, 0), (5, 3)):
        a, b = mk_batch(g, seed, n_fam=n_fam)
        r1s, r2s = r1s + a, r2s + b
    names = [f"p{j}" for j in range(len(r1s))]
    _write_fastq(d / "r1.fq", names, r1s)
    _write_fastq(d / "r2.fq", names, r2s)
    # both ends of 8 pairs, 3 of them from the family, as 16 single reads:
    # at the small caps and -n 2 the first batch has a retry that fails
    # again, for the beam, and moves the profile
    fam = sum(mk_batch(g, 1), [])
    _write_fastq(d / "fam.fq", [f"f{j}" for j in range(16)], fam)
    # reads with a low-quality tail: trimmed to TRIM_KEEP at -q 15
    rs = np.random.RandomState(5)
    with open(d / "trim.fq", "w") as fh:
        for i in range(10):
            p = rs.randint(40_000, len(text) - TRIM_LEN)
            fh.write(f"@t{i}\n{alphabet.decode(text[p:p + TRIM_LEN])}\n+\n"
                     f"{'I' * TRIM_KEEP}{'#' * (TRIM_LEN - TRIM_KEEP)}\n")
    ref = str(d / "ref.fa")
    port("index", ref)
    for m in ("1", "2"):
        port("aln", ref, str(d / f"r{m}.fq"), "--batch", BATCH, "--device",
             "cpu", "-f", str(d / f"t{m}.sai.npz"), "--metrics",
             str(d / f"t_aln{m}.json"))
    port("aln", ref, str(d / "r1.fq"), "--batch", BATCH, "--engine", "beam",
         "--device", "cpu", "-f", str(d / "t1_beam.sai.npz"))
    port("aln", ref, str(d / "trim.fq"), "-n", "2", "-q", "15", "--device",
         "cpu", "-f", str(d / "t_trim.sai.npz"))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in CAPS.items():
            mp.setattr(TAligner, k, v)
        port("aln", ref, str(d / "fam.fq"), "--batch", BATCH, "-n", "2",
             "--device", "cpu", "-f", str(d / "t_caps.sai.npz"), "--metrics",
             str(d / "t_aln_caps.json"))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d),
                        json.dumps(CAPS)],
                       capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=900)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    return d


def load_sai(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("tag", ["1", "2", "1_beam", "_trim", "_caps"])
def test_sai_equals_reference(flow, tag):
    """Field by field and dtype by dtype: the occurrence arrays, ``trunc``,
    ``c2x``, ``version``, ``batch``, ``nreads`` and the options."""
    want = load_sai(flow / f"j{tag}.sai.npz")
    got = load_sai(flow / f"t{tag}.sai.npz")
    assert sorted(got) == sorted(want) == sorted(
        tcli._OCC_FIELDS + ("trunc", "c2x", "version", "batch", "nreads",
                            "opt"))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["trunc"].dtype == bool and got["c2x"].dtype == np.int64
    rid = got["rid"]
    assert (rid[1:] >= rid[:-1]).all()
    assert np.unique(rid).size >= int(got["nreads"]) - 2


@pytest.mark.parametrize("tag", ["j1", "t2", "j_caps"])
def test_sai_helpers_match_reference(flow, tag):
    """``_OCC_FIELDS``, ``_sai_meta`` and ``_sai_stream`` against the
    reference's on the same file: the options, batch and read count, and per
    batch its start, its occurrence arrays with ``rid`` made batch-local,
    ``trunc`` and ``c2x``, each equal in dtype and value."""
    path = str(flow / f"{tag}.sai.npz")
    assert tcli._OCC_FIELDS == jcli._OCC_FIELDS
    (opt, bsz, n), (jopt, jbsz, jn) = tcli._sai_meta(path), \
        jcli._sai_meta(path)
    assert (opt.to_dict(), bsz, n) == (jopt.to_dict(), jbsz, jn)
    got, want = list(tcli._sai_stream(path)), list(jcli._sai_stream(path))
    assert [g[0] for g in got] == [w[0] for w in want] == list(range(0, n, 8))
    for (_, occ, tr, cx), (_, jocc, jtr, jcx) in zip(got, want):
        assert list(occ) == list(jocc)
        for k in jocc:
            assert occ[k].dtype == jocc[k].dtype, k
            np.testing.assert_array_equal(occ[k], jocc[k], err_msg=k)
        for a, b in ((tr, jtr), (cx, jcx)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_sai_stream_rejects_bad_order_and_lengths(flow, tmp_path):
    """The reference's two stream checks, as errors that ``python -O``
    keeps: occurrences out of ``rid`` order, and ``trunc`` not one entry a
    read."""
    z = load_sai(flow / "t1.sai.npz")
    for name, change, what in (
            ("order", dict(rid=z["rid"][::-1].copy()), "rid order"),
            ("lengths", dict(trunc=z["trunc"][:-1]), "corrupt .sai")):
        bad = tmp_path / f"{name}.sai.npz"
        np.savez(bad, **dict(z, **change))
        with pytest.raises(AssertionError, match="corrupt"):
            list(jcli._sai_stream(str(bad)))
        with pytest.raises(ValueError, match=what):
            list(tcli._sai_stream(str(bad)))


def test_sai_resolves_in_either_package(flow):
    """The reference's ``samse``/``sampe`` on the port's ``.sai`` files,
    the port's on the reference's and on its own: one SAM each."""
    ref = str(flow / "ref.fa")
    r1, r2 = str(flow / "r1.fq"), str(flow / "r2.fq")
    for tag, a, b in (("tj", "j1", "j2"), ("tt", "t1", "t2")):
        port("samse", ref, str(flow / f"{a}.sai.npz"), r1, "--device", "cpu",
             "-f", str(flow / f"{tag}_se.sam"))
        port("sampe", ref, str(flow / f"{a}.sai.npz"),
             str(flow / f"{b}.sai.npz"), r1, r2, "--device", "cpu", "-f",
             str(flow / f"{tag}_pe.sam"))
    for kind in ("se", "pe"):
        want = (flow / f"j_{kind}.sam").read_text()
        for tag in ("jt", "tj", "tt"):
            assert (flow / f"{tag}_{kind}.sam").read_text() == want, \
                (tag, kind)
    assert "XT:Z:M" in (flow / "j_pe.sam").read_text()


def test_aln_samse_equals_align(flow):
    """``aln`` + ``samse`` == ``align`` (tests/test_cli.py:41), with the
    reference's ``samse`` as the third."""
    ref, r1 = str(flow / "ref.fa"), str(flow / "r1.fq")
    port("align", ref, r1, "--batch", BATCH, "--device", "cpu", "-f",
         str(flow / "t_align.sam"))
    want = body(flow / "t_align.sam")
    assert body(flow / "j_se.sam") == want and len(want) == 24
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in want) >= 23


def test_two_phase_trim_roundtrip(flow):
    """``aln -q 15`` + ``samse`` == ``align -q 15``: the ``.sai`` carries
    the search options and ``samse`` trims again (tests/test_cli.py:84)."""
    ref, fq = str(flow / "ref.fa"), str(flow / "trim.fq")
    port("samse", ref, str(flow / "t_trim.sai.npz"), fq, "--device", "cpu",
         "-f", str(flow / "t_trim.sam"))
    port("align", ref, fq, "-n", "2", "-q", "15", "--device", "cpu", "-f",
         str(flow / "t_trim_align.sam"))
    got = body(flow / "t_trim.sam")
    assert got == body(flow / "t_trim_align.sam") and len(got) == 10
    assert all(ln.split("\t")[5] == f"{TRIM_KEEP}M" for ln in got)


def test_aln_sampe_equals_align_pe(flow):
    """``aln`` x2 + ``sampe`` == ``align-pe`` (tests/test_cli.py:115): the
    fused command pools its fallbacks across batches, ``aln`` runs them per
    batch, and a read's records do not depend on its batch."""
    ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
    port("align-pe", ref, r1, r2, "--batch", BATCH, "--device", "cpu", "-f",
         str(flow / "t_align_pe.sam"))
    want = body(flow / "t_align_pe.sam")
    assert body(flow / "j_pe.sam") == want and len(want) == 48
    assert [ln.split("\t")[0] for ln in want if "XT:Z:M" in ln] == ["p6"]
    # the long ends, which aln's inline beam searched, are mapped
    assert sum(len(f[9]) == 200 and not int(f[1]) & 4
               for f in (ln.split("\t") for ln in want)) == 2


def test_samse_wrong_read_file_fails(flow):
    """A read file that does not match the ``.sai`` stops ``samse``
    (tests/test_cli.py:151): 10 reads against a ``.sai`` of 24."""
    with pytest.raises((AssertionError, ValueError),
                       match="does not match|unevenly"):
        tcli.main(["samse", str(flow / "ref.fa"), str(flow / "t1.sai.npz"),
                   str(flow / "trim.fq"), "--device", "cpu", "-f",
                   str(flow / "bad.sam")])


@pytest.mark.parametrize("cmd", ["samse", "sampe"])
def test_corrupt_or_legacy_sai_fails(flow, tmp_path, cmd):
    """tests/test_cli.py:163, for both resolving commands."""
    bad = tmp_path / "corrupt.sai.npz"
    bad.write_bytes(b"\x00" * 64)
    legacy = tmp_path / "legacy.sai.npz"
    np.savez(legacy, counts_f=np.zeros(4), batch=np.int64(4))
    ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
    good = str(flow / "t1.sai.npz")
    for sai, err in ((bad, ValueError), (legacy, SystemExit)):
        argv = ([cmd, ref, str(sai), r1] if cmd == "samse"
                else [cmd, ref, good, str(sai), r1, r2])
        with pytest.raises(err) as e:
            tcli.main(argv + ["--device", "cpu"])
        if err is SystemExit:
            assert "not a v2 .sai" in str(e.value)


def test_sampe_mismatched_opts_fail(flow):
    """``.sai`` files searched with other options, or in other batch sizes,
    do not pair (tests/test_cli.py:192)."""
    ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
    port("aln", ref, r2, "--batch", BATCH, "-n", "1", "--device", "cpu", "-f",
         str(flow / "t2_n1.sai.npz"))
    port("aln", ref, r2, "--batch", "12", "--device", "cpu", "-f",
         str(flow / "t2_b12.sai.npz"))
    for other, what in (("t2_n1", "options differ"),
                        ("t2_b12", "batch sizes differ")):
        with pytest.raises(ValueError, match=what):
            tcli.main(["sampe", ref, str(flow / "t1.sai.npz"),
                       str(flow / f"{other}.sai.npz"), r1, r2, "--device",
                       "cpu"])


class Crash(Exception):
    pass


def _count_searches(monkeypatch, fail_at=None):
    """Count ``Aligner._align_device`` calls; with ``fail_at`` the call of
    that number raises, once (a crash after the batches before it)."""
    calls = []
    real = TAligner._align_device

    def spy(self, *a, **kw):
        nonlocal fail_at
        calls.append(1)
        if len(calls) == fail_at:
            fail_at = None
            raise Crash
        return real(self, *a, **kw)

    monkeypatch.setattr(TAligner, "_align_device", spy)
    return calls


def test_aln_resume_parts(flow, tmp_path, monkeypatch, capsys):
    """``aln --resume`` (tests/test_cli_resume.py:79): after a crash in the
    third batch it searches that batch alone, from the shards of the first
    two, and writes the ``.sai`` of an uninterrupted run; rolled back to 8
    reads with the shards gone it searches again from there; over a
    finished run it searches nothing and leaves the ``.sai`` as it was."""
    ref, r1 = str(flow / "ref.fa"), str(flow / "r1.fq")
    out = str(tmp_path / "r.sai.npz")
    argv = ["aln", ref, r1, "--batch", BATCH, "--device", "cpu", "-f", out]
    want = load_sai(flow / "t1.sai.npz")
    # the repeat profile moved after the first batch: the resumed run must
    # search the third at the caps the uninterrupted run did
    m = json.load(open(flow / "t_aln1.json"))
    assert [b["profile"] for b in m["batches"]] == ["base", "repeat", "repeat"]
    calls = _count_searches(monkeypatch, fail_at=3)
    with pytest.raises(Crash):
        tcli.main(argv)
    assert sorted(os.listdir(out + ".parts")) == [
        "part_000000000000.npz", "part_000000000008.npz"]
    calls.clear()
    port(*argv, "--resume")
    assert len(calls) == 1 and "resuming at read 16" in capsys.readouterr().err
    assert not os.path.exists(out + ".parts")

    def same():
        got = load_sai(out)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    same()
    # the reference's own case: manifest rolled back, shards gone
    man = out + ".manifest.json"
    m = json.load(open(man))
    assert m["completed_reads"] == 24
    json.dump(dict(m, completed_reads=8), open(man, "w"))
    calls.clear()
    port(*argv, "--resume")
    assert len(calls) == 3 and "resuming at read 8" in capsys.readouterr().err
    same()
    # a finished run
    calls.clear()
    met = str(tmp_path / "m.json")
    port(*argv, "--resume", "--metrics", met)
    assert calls == [] and "already holds all 24" in capsys.readouterr().err
    m = json.load(open(met))
    assert m["reads_in"] == 24 and "t_index_load_s" not in m
    same()


@pytest.mark.parametrize("cmd", ["samse", "sampe"])
def test_resolve_resume_after_finish_appends_nothing(flow, cmd):
    ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
    out = flow / f"resume_{cmd}.sam"
    sai = [str(flow / "t1.sai.npz")] + ([str(flow / "t2.sai.npz")]
                                        if cmd == "sampe" else [])
    reads = [r1] + ([r2] if cmd == "sampe" else [])
    argv = [cmd, ref, *sai, *reads, "--device", "cpu", "-f", str(out)]
    port(*argv)
    full = out.read_text()
    assert full == (flow / f"j_{cmd[-2:]}.sam").read_text()
    # crash after the first batch: the rest is appended
    man = str(out) + ".manifest.json"
    m = json.load(open(man))
    json.dump(dict(m, completed_reads=8), open(man, "w"))
    lines = full.splitlines(keepends=True)
    hdr = [ln for ln in lines if ln.startswith("@")]
    recs = [ln for ln in lines if not ln.startswith("@")]
    out.write_text("".join(hdr + recs[:8 * (1 + (cmd == "sampe"))]))
    port(*argv, "--resume")
    assert out.read_text() == full
    port(*argv, "--resume")
    assert out.read_text() == full


@pytest.mark.parametrize("cmd,port_json,ref_json", [
    ("aln", "t_aln1", "j_aln"), ("aln --caps", "t_aln_caps", "j_aln_caps"),
    ("samse", None, "jt_samse"), ("sampe", None, "jt_sampe")])
def test_metrics_counters_equal(flow, cmd, port_json, ref_json):
    """Every counter of the reference's ``--metrics`` has the port's value;
    the port's config is the reference's plus ``device``, and per batch it
    adds the engine's fractions (``aln``) or the rescue jobs (``sampe``)."""
    if port_json is None:
        ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
        port_json = f"t_{cmd}"
        sai = [str(flow / "t1.sai.npz")] + ([str(flow / "t2.sai.npz")]
                                            if cmd == "sampe" else [])
        port(cmd, ref, *sai, r1, *([r2] if cmd == "sampe" else []),
             "--device", "cpu", "-f", str(flow / f"{port_json}.sam"),
             "--metrics", str(flow / f"{port_json}.json"))
    got = json.load(open(flow / f"{port_json}.json"))
    want = json.load(open(flow / f"{ref_json}.json"))
    counters = [k for k in want if not k.startswith("t_")
                and k not in ("wall_s", "config", "batches")]
    assert "reads_in" in counters
    for k in counters:
        assert got[k] == want[k], k
    assert set(got["config"]) == set(want["config"]) | {"device"}
    assert {k: v for k, v in got["config"].items() if k != "device"} == \
        want["config"]
    assert "batches" not in want
    assert len(got.get("batches", [])) == {"samse": 0, "aln --caps": 2}.get(
        cmd, 3)
    if cmd == "sampe":
        assert [b["rescue_jobs"] for b in got["batches"]][0] >= 1
        assert [b["n"] for b in got["batches"]] == [16, 16, 16]


def test_aln_at_small_caps_retries_falls_back_and_moves_profile(flow):
    """At the small caps ``aln``'s own retry and beam fallback run inside
    the first batch, which moves the repeat profile for the second: the
    ``.sai`` is the reference's all the same
    (``test_sai_equals_reference[_caps]``)."""
    b = json.load(open(flow / "t_aln_caps.json"))["batches"]
    assert [x["profile"] for x in b] == ["base", "repeat"]
    assert b[0]["retry"] > 0 and b[0]["fallback"] > 0


def test_commands_and_their_default_device(flow):
    """The reference's six commands, in its order; the resolving and
    searching commands run on ``cuda`` unless told otherwise, and with no
    card they raise rather than run on the CPU."""
    assert list(tcli.COMMANDS) == list(jcli.COMMANDS)
    assert not hasattr(tcli, "SAMPE_TODO")
    ref, r1, r2 = (str(flow / f) for f in ("ref.fa", "r1.fq", "r2.fq"))
    sai1, sai2 = str(flow / "t1.sai.npz"), str(flow / "t2.sai.npz")
    for argv in (["aln", ref, r1, "-f", str(flow / "nodev.sai.npz")],
                 ["samse", ref, sai1, r1], ["sampe", ref, sai1, sai2, r1, r2]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
