"""The port's native library (``hsa_tpu_torch/csrc/refpack.cpp``) under
AddressSanitizer and UBSan.

The twin of ``tests/test_refpack_asan.py``, which covers ``hsa_tpu/refpack``
only.  The sources are built with ``-fsanitize=address,undefined`` (every
finding fatal) into the test's scratch directory, never into
``hsa_tpu_torch/_build/``.  A sanitized shared object cannot be loaded into
a running CPython, so the battery runs in a subprocess with the ASan runtime
preloaded; any heap error or undefined behaviour aborts it non-zero.  The
battery covers SA-IS and ``suffix_array_force64`` against
``fmcore.suffix_array``, the fused ``build``, 2-bit packing, ``pigeon_pack``
below and above its threading threshold, ``banded_global`` against its numpy
reference, ``banded_batch`` and ``glocal_batch`` single- and multi-threaded,
and the FASTQ batcher on plain, CRLF and gzipped input.  It writes what it
computed; the same battery without the sanitizers, on the library the port
builds, must write the same, and the test holds the pigeon buffers against
the numpy pack and the glocal costs against ``fit_in_window``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "hsa_tpu_torch", "csrc")
SAN_FLAGS = ("-O1", "-g", "-std=c++17", "-fPIC", "-shared",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-fno-omit-frame-pointer")
# pigeon_pack threads above 4,096 lanes, banded_batch above 512 jobs,
# glocal_batch above 64 (csrc/refpack.cpp)
PIGEON_READS = (5, 2049, 3000)
BANDED_JOBS = (7, 600)
GLOCAL_JOBS = (10, 100)

_BATTERY = r"""
import ctypes
import gzip
import os
import sys

import numpy as np

sys.path.insert(0, %(root)r)
from hsa_tpu_torch import fmcore, refpack
from hsa_tpu_torch.io.fastq_fast import FastqBatcher
from hsa_tpu_torch.resolve.cigar import banded_global_ref

so, out_path, work = sys.argv[1:4]
if so != "-":                          # the sanitized build
    refpack._lib = ctypes.CDLL(so)
    refpack._declare(refpack._lib)
rs = np.random.RandomState(0)
out = {}

for n in (0, 1, 2, 37, 500, 5000):
    t = rs.randint(0, 4, n).astype(np.uint8)
    ref = fmcore.suffix_array(t.astype(np.int8))
    assert np.array_equal(refpack.suffix_array(t), ref), n
    assert np.array_equal(refpack.suffix_array_force64(t), ref), n
    sa, bwt, primary, marks, samples = refpack.build(t, sa_intv=8,
                                                     want_sa=True)
    assert np.array_equal(sa, ref), n
    assert np.array_equal(marks.astype(bool), ref %% 8 == 0), n
    assert np.array_equal(samples, ref[ref %% 8 == 0]), n
    if n:
        rbwt, rprim = fmcore.bwt_from_sa(t.astype(np.int8), ref)
        assert np.array_equal(bwt, rbwt.astype(np.uint8)), n
        assert primary == rprim, n
    assert np.array_equal(refpack.unpack_2bit(refpack.pack_2bit(t), n), t)
t = np.tile(rs.randint(0, 4, 13).astype(np.uint8), 400)
assert np.array_equal(refpack.suffix_array(t),
                      fmcore.suffix_array(t.astype(np.int8)))
assert np.array_equal(refpack.suffix_array_force64(t),
                      fmcore.suffix_array(t.astype(np.int8)))

text = rs.randint(0, 4, 20_000).astype(np.int8)
out["text"] = text
for B in %(pigeon_reads)r:
    L = 100
    lens = rs.randint(30, L + 1, B).astype(np.int32)
    mat = np.full((B, L), 5, np.uint8)
    for j in range(B):
        p = rs.randint(0, len(text) - L)
        mat[j, :lens[j]] = text[p:p + lens[j]]
        if j %% 7 == 0:
            mat[j, rs.randint(0, lens[j])] = 4
    md = rs.randint(0, 6, B).astype(np.int32)
    out[f"pigeon_in_{B}"] = mat
    out[f"pigeon_lens_{B}"] = lens
    out[f"pigeon_md_{B}"] = md
    for n_seg, K, tail in ((3, 0, 3), (4, 12, 6)):
        buf, shape = refpack.pigeon_pack(mat, lens, md, n_seg, K, tail)
        out[f"pigeon_{B}_{n_seg}_{K}"] = buf
        out[f"pigeon_shape_{B}_{n_seg}_{K}"] = np.asarray(shape)


def dp_jobs(n, Lm, G):
    reads = np.full((n, Lm), 5, np.uint8)
    lens = rs.randint(1, Lm + 1, n).astype(np.int32)
    offs = rs.randint(0, len(text) - Lm - G - 8, n).astype(np.int64)
    for i in range(n):
        reads[i, :lens[i]] = text[offs[i] + 3:offs[i] + 3 + lens[i]]
        q = rs.choice(lens[i], min(3, lens[i]), replace=False)
        reads[i, q] = rs.randint(0, 5, q.size)        # N codes too
    return reads, lens, offs


for n in %(banded_jobs)r:
    reads, lens, offs = dp_jobs(n, 60, 4)
    cig, mds, nm, glen, gapb = refpack.banded_batch(
        reads, np.arange(n) * reads.shape[1], lens, text, offs + 3, lens + 2,
        3, 11, 4, np.full(n, 3, np.int32))
    out[f"banded_cigar_{n}"] = np.asarray(cig)
    out[f"banded_md_{n}"] = np.asarray(mds)
    out[f"banded_stats_{n}"] = np.stack([nm, glen, gapb])
for i in range(12):
    r = reads[i, :lens[i]]
    g = text[offs[i] + 3:offs[i] + 3 + lens[i] + 2].astype(np.uint8)
    assert refpack.banded_global(r, g, 3, 11, 4, 3) == \
        banded_global_ref(r, g, 3, 11, 4, 3), i
for n in %(glocal_jobs)r:
    reads, lens, offs = dp_jobs(n, 40, 300)
    w_len = rs.randint(0, 300, n).astype(np.int32)
    cost, start, ops = refpack.glocal_batch(
        reads, np.arange(n) * reads.shape[1], lens, text, offs, w_len, 3, 11,
        4)
    out[f"glocal_in_{n}"] = reads
    out[f"glocal_lens_{n}"] = lens
    out[f"glocal_offs_{n}"] = offs
    out[f"glocal_wlen_{n}"] = w_len
    out[f"glocal_{n}"] = np.stack([cost, start])
    out[f"glocal_ops_{n}"] = np.concatenate(ops + [np.zeros(0, np.uint8)])

recs = []
for j in range(37):
    L = int(rs.randint(1, 150))
    seq = "".join("ACGTN"[c] for c in rs.randint(0, 5, L))
    recs.append(f"@q{j} extra\n{seq}\n+\n{'I' * L}\n")
for kind in ("plain", "crlf", "gz"):
    path = os.path.join(work, f"reads_{kind}.fq")
    body = "".join(recs)
    if kind == "crlf":
        body = body.replace("\n", "\r\n")
    if kind == "gz":
        path += ".gz"
        with gzip.open(path, "wt") as fh:
            fh.write(body)
    else:
        with open(path, "w") as fh:
            fh.write(body)
    for i, (names, codes, lens, quals) in enumerate(
            FastqBatcher(path, batch=8, max_len=100)):
        out[f"fastq_{kind}_{i}"] = codes[:len(lens)]
        out[f"fastq_{kind}_lens_{i}"] = lens
        out[f"fastq_{kind}_names_{i}"] = np.asarray(list(names))
np.savez(out_path, **out)
print("ASAN-BATTERY-OK")
"""


def _asan_runtime():
    out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                         capture_output=True, text=True)
    p = out.stdout.strip()
    return p if p and os.path.sep in p else None


def _battery(tmp_path, tag, so, env):
    """Runs the battery with library ``so`` ("-": the port's own build);
    returns what it wrote."""
    work = tmp_path / tag
    work.mkdir()
    script = tmp_path / "battery.py"
    script.write_text(_BATTERY % dict(root=ROOT, pigeon_reads=PIGEON_READS,
                                      banded_jobs=BANDED_JOBS,
                                      glocal_jobs=GLOCAL_JOBS))
    out = work / "out.npz"
    r = subprocess.run([sys.executable, str(script), so, str(out), str(work)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (tag, r.stdout[-2000:], r.stderr[-6000:])
    assert "ASAN-BATTERY-OK" in r.stdout
    with np.load(out) as z:
        return dict(z)


@pytest.mark.slow
def test_port_refpack_battery_under_asan(tmp_path):
    asan_rt = _asan_runtime()
    if asan_rt is None:
        pytest.skip("libasan runtime not found")
    so = tmp_path / "librefpack_asan.so"
    r = subprocess.run([os.environ.get("CXX", "g++"), *SAN_FLAGS, "-o",
                        str(so), os.path.join(CSRC, "refpack.cpp")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    san = _battery(tmp_path, "asan", str(so), dict(
        env, LD_PRELOAD=asan_rt,
        ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",  # CPython "leaks"
        UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1"))
    plain = _battery(tmp_path, "plain", "-", env)
    assert san.keys() == plain.keys()
    for k in san:
        np.testing.assert_array_equal(san[k], plain[k], err_msg=k)

    # the threaded pack against the numpy pack, the DP against fit_in_window
    from hsa_tpu_torch import alphabet
    from hsa_tpu_torch.resolve.sampe import fit_in_window
    from hsa_tpu_torch.search import pigeon as pg
    for B in PIGEON_READS:
        mat, lens = san[f"pigeon_in_{B}"], san[f"pigeon_lens_{B}"]
        md = san[f"pigeon_md_{B}"]
        reads = [mat[j, :lens[j]] for j in range(B)]
        both = reads + [alphabet.revcomp(r) for r in reads]
        for n_seg, K, tail in ((3, 0, 3), (4, 12, 6)):
            b = pg.pack_pigeon_batch(both, n_seg=n_seg, max_len=mat.shape[1],
                                     kmer_k=K, anchor_tail=tail,
                                     device_masks=True)
            buf, shape = pg.pack_pigeon_upload(b, np.concatenate([md, md]))
            np.testing.assert_array_equal(buf, san[f"pigeon_{B}_{n_seg}_{K}"])
            assert tuple(shape) == tuple(san[f"pigeon_shape_{B}_{n_seg}_{K}"])
    text = san["text"]
    for n in GLOCAL_JOBS:
        reads, lens = san[f"glocal_in_{n}"], san[f"glocal_lens_{n}"]
        offs, w_len = san[f"glocal_offs_{n}"], san[f"glocal_wlen_{n}"]
        for i in range(n):
            cost, start, _ = fit_in_window(
                reads[i, :lens[i]], text[offs[i]:offs[i] + w_len[i]], 3, 11, 4)
            assert (cost, start) == tuple(san[f"glocal_{n}"][:, i]), (n, i)

