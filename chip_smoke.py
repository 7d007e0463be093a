#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsa_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py [--seed 1] [--profile]

It imports nothing of JAX and nothing of the JAX package: it drives the
port through its CLI (``hsa_tpu_torch.cli``), its ``Aligner`` and its
kernel wrapper.  Every phase that fails exits non-zero; there is no CPU
fallback, and without a CUDA device (or without the rest of the repository
beside it) it exits non-zero before printing any result.

1. Device and build: the card's name and power limit (``nvidia-smi``),
   the torch/CUDA versions; builds the select_topk CUDA kernel from
   ``hsa_tpu_torch/csrc``, with its time.
2. Kernel against plain, on the card, at the beam step's two shapes
   (frontier ``[576, 32768]`` K=64 with window, hit merge ``[352, 32768]``
   K=32; three payloads each; seeded): valid keys and payloads, the drop
   row and nvalid must be exactly equal.  Median ms of both versions,
   timed in turns with CUDA events.
3. Main path through the CLI, in process: an i.i.d. genome of
   46,709,983 bp (human chr21 scale) from ``--seed``; ``hsa_tpu_torch.cli
   index`` (which builds the native index library and prints its time;
   the index is cached under ``hsa_tpu_torch/_build/smoke/``, keyed by
   size and seed), then ``align --engine beam --device cuda`` at the CLI
   defaults on 32,768 reads of 100 bp: half reverse-strand, each with 2
   mismatches, every fourth also with a 1-bp deletion.
4. Checks: mapped fraction >= 0.95; mapped reads within 2 bp of their
   origin >= 0.99; the kernel's launch count during phase 3 alone equals
   2 x n_steps x batches; the first 256 reads through ``align --device
   cpu`` (the plain path) give a byte-equal SAM.  Prints reads/s over the
   whole align window and, per batch, how long its yield was waited for
   (the stream searches batches ahead, so that is no per-batch rate).
5. With ``--profile``, where the time goes on the warm card: each batch's
   stream phases (search; readback + hits + locate; resolve) one after
   another with the device synchronised between them; one batch's search
   under ``torch.profiler`` (kernel launches, host time in torch ops,
   device busy time, idle share, the top kernels, peak memory); then
   ``align --device cuda`` twice more, warm, against the sequential sum.
6. Prints the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 46_709_983          # human chr21 (BASELINE config 3)
N_READS, READ_LEN, BATCH = 32_768, 100, 16_384
CROSS_CHECK = 256
MAPPED_MIN, PLACED_MIN = 0.95, 0.99
FRONTIER = dict(C=576, B=32_768, K=64, window=True)
MERGE = dict(C=352, B=32_768, K=32, window=False)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


# -- 1. device and build ------------------------------------------------------
def device_info():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    print(r.stdout.strip())
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")


def build_kernel():
    from hsa_tpu_torch.kernels import select
    t0 = time.perf_counter()
    select.KERNEL.lib()
    print(f"select_topk kernel built in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {select.KERNEL.build_s} s)")
    for line in select.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


# -- 2. kernel against plain ---------------------------------------------------
def make_select_case(C, B, window, rs, device):
    """Beam-like select inputs: unique row-tagged keys, ~30% valid."""
    import torch
    from hsa_tpu_torch.kernels.select import KEY_SH, SENT
    row = np.arange(C, dtype=np.int64)[:, None]
    score = rs.randint(0, 40, (C, B)).astype(np.int64)
    key = np.where(rs.rand(C, B) < 0.3, (score << KEY_SH) | row, SENT | row)
    pays = [rs.randint(-2 ** 31, 2 ** 31, (C, B), dtype=np.int64)
            for _ in range(3)]
    win = rs.randint(5, 40, B) if window else None

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
    return dev(key), [dev(p) for p in pays], dev(win)


def compare_select(k_out, p_out):
    """Max |kernel - plain| over valid slots, the drop row and nvalid;
    fails on any difference or on a malformed invalid slot."""
    import torch
    from hsa_tpu_torch.kernels.select import SENT
    (kk, kp, kd), (pk, pp, pd) = k_out, p_out
    K = kk.shape[0] - 1
    kv, pv = kk[:K] < SENT, pk[:K] < SENT
    if not torch.equal(kv, pv):
        fail("select_topk: valid slots differ from the plain version")
    errs = [(torch.where(kv, kk[:K], 0).long() - torch.where(pv, pk[:K], 0).long()).abs().max(),
            (kd.long() - pd.long()).abs().max()]
    for a, b in zip(kp, pp):
        errs.append((torch.where(kv, a, 0).long() - torch.where(pv, b, 0).long()).abs().max())
    if (kk[:K][~kv] != SENT).any() or any((a[~kv] != 0).any() for a in kp):
        fail("select_topk: invalid slots are not SENT / payload 0")
    err = int(torch.stack(errs).max())
    if err:
        fail(f"select_topk differs from the plain version (max |err| {err})")
    return err


def time_turns(fns, rounds=15, warm=3):
    """Median ms of each function, timed in turns (a, b, b, a, ...) with
    CUDA events around every call."""
    import torch
    for f in fns:
        for _ in range(warm):
            f()
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[i]()
            e1.record()
            torch.cuda.synchronize()
            times[i].append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in times]


def kernel_phase(seed):
    import torch
    from hsa_tpu_torch.kernels import select
    rs = np.random.RandomState(seed)
    shapes = []
    for shp in (FRONTIER, MERGE):
        C, B, K, window = shp["C"], shp["B"], shp["K"], shp["window"]
        key, pays, win = make_select_case(C, B, window, rs, "cuda")
        run_k = lambda: select.select_topk(key, pays, K, window=win)   # noqa: E731
        run_p = lambda: select.select_topk_plain(key, pays, K, window=win)  # noqa: E731
        err = compare_select(run_k(), run_p())
        torch.cuda.synchronize()
        ms, plain_ms = time_turns([run_k, run_p])
        print(f"select_topk [{C}, {B}] K={K} window={window}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, max |err| {err}")
        shapes.append(dict(shape=f"[{C}, {B}] K={K}" + (" window" if window
                                                          else ""),
                           ms=ms, plain_ms=plain_ms, max_abs_err=err))
    return shapes


# -- 3. main path ----------------------------------------------------------------
def make_genome(n, seed):
    return np.random.RandomState(seed).randint(0, 4, n).astype(np.int8)


def revcomp(codes):
    return (3 - codes[::-1]).astype(np.int8)


def write_fasta(path, genome):
    s = ACGT[genome].tobytes()
    with open(path, "wb") as fh:
        fh.write(b">chrS\n")
        fh.write(b"\n".join(s[i:i + 80] for i in range(0, len(s), 80)))
        fh.write(b"\n")


def make_reads(genome, n_reads, seed):
    """Reads of READ_LEN bp: odd reads reverse-strand, 2 mismatches each,
    every fourth with a 1-bp deletion (the read classes of
    benchmarks/common.py:sample_reads).  Returns (codes, origins)."""
    rs = np.random.RandomState(seed + 1)
    reads, origin = [], np.empty(n_reads, np.int64)
    for j in range(n_reads):
        dele = j % 4 == 0
        p = rs.randint(0, len(genome) - READ_LEN - 2)
        r = genome[p:p + READ_LEN + dele].copy()
        if dele:
            cut = rs.randint(8, READ_LEN - 8)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        q = rs.choice(READ_LEN, size=2, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, size=2)) % 4
        reads.append(revcomp(r) if j % 2 else r)
        origin[j] = p
    return reads, origin


def write_fastq(path, reads):
    qual = "I" * READ_LEN
    with open(path, "w") as fh:
        for j, r in enumerate(reads):
            fh.write(f"@r{j}\n{ACGT[r].tobytes().decode()}\n+\n{qual}\n")


def ensure_index(genome, seed, workdir):
    """``hsa_tpu_torch.cli index`` on the genome's FASTA, cached by size and
    seed.  Returns (prefix, seconds or None when cached)."""
    from hsa_tpu_torch import cli
    prefix = os.path.join(workdir, f"genome_{len(genome)}_s{seed}")
    if os.path.exists(os.path.join(prefix + ".hsa", "text.pac")):
        return prefix, None
    fa = prefix + ".fa"
    write_fasta(fa, genome)
    t0 = time.perf_counter()
    if cli.main(["index", fa, "-p", prefix]) != 0:
        fail("index build failed")
    secs = time.perf_counter() - t0
    os.remove(fa)
    return prefix, secs


def run_align(prefix, fq, out_dir, device, tag):
    """``hsa_tpu_torch.cli align --engine beam`` at the CLI defaults.
    Returns (SAM lines, header included; metrics dict)."""
    from hsa_tpu_torch import cli
    sam = os.path.join(out_dir, f"{tag}.sam")
    met = os.path.join(out_dir, f"{tag}_metrics.json")
    if cli.main(["align", prefix, fq, "--engine", "beam", "--device", device,
                 "-f", sam, "--metrics", met]) != 0:
        fail(f"align --device {device} failed")
    with open(sam) as fh:
        lines = fh.read().split("\n")
    with open(met) as fh:
        return lines[:-1], json.load(fh)


def align_window(met):
    """Seconds from the start of ``align`` to its end, index load excluded."""
    return met["wall_s"] - met["t_index_load_s"]


def check_placement(records, origin):
    """(mapped fraction, fraction of mapped reads within 2 bp of origin)."""
    if len(records) != len(origin):
        fail(f"{len(records)} SAM records for {len(origin)} reads")
    mapped = placed = 0
    for j, line in enumerate(records):
        f = line.split("\t", 4)
        if f[0] != f"r{j}":
            fail(f"SAM record {j} is {f[0]}")
        if int(f[1]) & 4:
            continue
        mapped += 1
        placed += abs(int(f[3]) - 1 - origin[j]) <= 2
    return mapped / len(records), placed / max(mapped, 1)


def cross_check(prefix, reads, lines, workdir):
    """The first CROSS_CHECK reads through ``align --device cpu``, the plain
    path: its SAM must equal the card's header and first records, byte for
    byte."""
    fq = os.path.join(workdir, "reads_cross_check.fq")
    write_fastq(fq, reads[:CROSS_CHECK])
    cpu, _ = run_align(prefix, fq, workdir, "cpu", "cross_check")
    n_hdr = sum(l.startswith("@") for l in lines)
    card = lines[:n_hdr + CROSS_CHECK]
    if cpu != card:
        bad = next(j for j in range(max(len(cpu), len(card)))
                   if cpu[j:j + 1] != card[j:j + 1])
        fail(f"the CPU plain path's SAM differs from the card's at line "
             f"{bad}:\n  card: {card[bad:bad + 1]}\n  cpu:  {cpu[bad:bad + 1]}")
    return CROSS_CHECK


# -- 5. where the time goes (--profile) ------------------------------------------
def profile_phase(prefix, reads, opt_dict, fq, workdir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hsa_tpu_torch.pipeline import Aligner
    al = Aligner(prefix, engine="beam", device="cuda")
    if al.opt.to_dict() != opt_dict:
        fail("Aligner() defaults differ from the CLI defaults")
    seq = 0.0
    for s in range(0, len(reads), BATCH):
        t = [time.perf_counter()]
        h = al._align_device(reads[s:s + BATCH])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        occ, trunc, c2x = al._align_occ(h)
        t.append(time.perf_counter())
        al._resolve_occ(h[1], None, None, occ, trunc, c2x, read_offset=s,
                        emit="sam")
        t.append(time.perf_counter())
        d = np.diff(t)
        seq += t[-1] - t[0]
        print(f"sequential batch at {s}: search {d[0]:.6f} s, readback + "
              f"hits + locate {d[1]:.6f} s, resolve {d[2]:.6f} s, "
              f"sum {t[-1] - t[0]:.6f} s")
    print(f"sequential: {len(reads)} reads in {seq:.6f} s "
          f"({len(reads) / seq:.1f} reads/s)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        al._align_device(reads[:BATCH])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kern:
        fail("the profiler recorded no device kernels")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    host = sum(e.self_cpu_time_total for e in events
               if e.device_type == DeviceType.CPU) / 1e6
    print(f"profiled search of {BATCH} reads: wall {wall:.6f} s, "
          f"{len(kern)} device kernels, host self time in torch ops "
          f"{host:.6f} s, device busy {busy:.6f} s, idle share "
          f"{1 - busy / wall:.6f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.6f} GB")
    per = defaultdict(lambda: [0, 0.0])
    for e in kern:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (n, ms) in sorted(per.items(), key=lambda x: -x[1][1])[:8]:
        print(f"  {ms:10.3f} ms {n:6d} launches  {name[:90]}")
    del al, events, kern, prof

    for rep in range(2):
        _, met = run_align(prefix, fq, workdir, "cuda", f"stream{rep}")
        w = align_window(met)
        print(f"warm align --device cuda, run {rep}: {met['reads_in']} reads "
              f"in an align window of {w:.3f} s ({met['reads_in'] / w:.1f} "
              f"reads/s), sequential sum {seq:.6f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="also break the warm run down by stream phase and "
                         "profile one batch's search")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, ROOT)
    try:
        import hsa_tpu_torch  # noqa: F401
        from hsa_tpu_torch.kernels import select
    except ImportError as e:
        fail(f"the repository is not beside this script ({e})")

    phase("1. device and build")
    device_info()
    build_kernel()

    phase("2. select_topk kernel against its plain version on the card")
    shapes = kernel_phase(a.seed)

    phase("3. main path: index + align --engine beam --device cuda")
    workdir = os.path.join(ROOT, "hsa_tpu_torch", "_build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    genome = make_genome(GENOME_BP, a.seed)
    prefix, index_s = ensure_index(genome, a.seed, workdir)
    print(f"index build seconds: {index_s if index_s is not None else 'cached'}"
          f" ({GENOME_BP} bp)")
    reads, origin = make_reads(genome, N_READS, a.seed)
    del genome
    fq = os.path.join(workdir, f"reads_{GENOME_BP}_s{a.seed}.fq")
    write_fastq(fq, reads)
    print(f"genome + reads ready in {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    select.KERNEL.launches = 0
    lines, met = run_align(prefix, fq, workdir, "cuda", "smoke")
    launches = select.KERNEL.launches

    phase("4. checks")
    batches = met.get("batches", [])
    for i, b in enumerate(batches):
        print(f"batch {i}: {b['n']} reads, yield waited for "
              f"{b['wait_s']:.6f} s")
    w = align_window(met)
    print(f"align: {met['reads_in']} reads in an align window of {w:.3f} s "
          f"({met['reads_in'] / w:.1f} reads/s, first run: includes "
          f"first-use warm-up); index load {met['t_index_load_s']} s")
    mapped, placed = check_placement(
        [l for l in lines if not l.startswith("@")], origin)
    overflow = met.get("beam_overflow_reads", 0)
    print(f"mapped fraction {mapped:.6f} (min {MAPPED_MIN}); placed within "
          f"2 bp {placed:.6f} (min {PLACED_MIN}); overflow reads {overflow}")
    opt = met["config"]["opt"]
    if met["config"]["batch"] != BATCH or len(batches) != -(-N_READS // BATCH):
        fail(f"align ran batches of {met['config']['batch']}, not {BATCH}")
    n_steps = READ_LEN + opt["max_gapo"] + opt["max_gape"]
    want = 2 * n_steps * len(batches)
    print(f"select_topk launches on the main path: {launches} "
          f"(expected 2 x {n_steps} steps x {len(batches)} batches = {want})")
    if mapped < MAPPED_MIN:
        fail(f"mapped fraction {mapped} < {MAPPED_MIN}")
    if placed < PLACED_MIN:
        fail(f"placed fraction {placed} < {PLACED_MIN}")
    if launches == 0 or launches != want:
        fail(f"select_topk launched {launches} times, expected {want}")
    t0 = time.perf_counter()
    n = cross_check(prefix, reads, lines, workdir)
    print(f"cross-check: align --device cpu on the first {n} reads gives a "
          f"SAM byte-equal to the card's ({time.perf_counter() - t0:.3f} s)")

    if a.profile:
        phase("5. where the time goes (warm card)")
        profile_phase(prefix, reads, opt, fq, workdir)

    sum_ms = sum(s["ms"] for s in shapes)
    sum_plain = sum(s["plain_ms"] for s in shapes)
    print(json.dumps({"kernels": [{
        "name": "select_topk", "route": "cuda",
        "source": "hsa_tpu_torch/csrc/select_topk.cu",
        "replaces": "hsa_tpu/kernels/select.py:50",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum_ms, "plain_ms": sum_plain,
        "ms_per": "one beam step: frontier select + hit merge",
        "shapes": shapes}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
