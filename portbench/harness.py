"""One run of one cell: set-up, the measured window over the served stream,
the traced sub-window, the comparison that decides ``correct``, the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name in
``BENCHMARK.json``: ``configs/<config>.json`` (named by the entry's
``file``), ``traffic/<traffic>.json``, ``cells/<cell>.json`` and
``metrics/<metric>.py``.  The program under test is ``hsa_tpu_torch``; this
package imports nothing else of the repository.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

from . import genome, spans
from .traffic import generator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hsa_tpu")


class Spec:
    """A cell as ``BENCHMARK.json`` and its files describe it."""

    def __init__(self, workload: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        self.cell = next(w for w in bench["workloads"] if w["name"] == workload)
        entry = next(c for c in bench["configs"]
                     if c["name"] == self.cell["config"])
        with open(os.path.join(root, entry["file"])) as fh:
            self.config = json.load(fh)
        here = os.path.join(root, "portbench")
        with open(os.path.join(here, "traffic",
                               self.cell["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)
        with open(os.path.join(here, "cells", workload + ".json")) as fh:
            self.params = json.load(fh)
        self.name = workload
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m["workloads"]]


def aln_options(cfg):
    """``AlnOpt`` as the port's CLI builds it from the configuration's
    arguments (the CLI's own parser, so its defaults hold)."""
    from hsa_tpu_torch.cli import _add_search_opts, _opt_from_args
    p = argparse.ArgumentParser()
    _add_search_opts(p)
    a = p.parse_args([str(x) for kv in cfg["options"].items() for x in kv])
    return _opt_from_args(a), a


class Reads:
    """The run's pool of reads, drawn from the seed and written once as
    FASTQ, with each pair's true outer distance (``frag``)."""

    def __init__(self, spec: Spec, g, seed: int, tmp: str):
        cfg = spec.config
        self.paired = cfg["mode"] == "pe"
        self.L = cfg["read_length"]
        self.n = spec.params["pool_batches"] * cfg["batch"]
        d = generator.draw(spec.traffic, g, self.n, self.L, self.paired, seed)
        self.r1, self.r2, self.frag = d["r1"], d["r2"], d["frag"]
        self.paths = [os.path.join(tmp, "r1.fq")]
        generator.write_fastq(self.paths[0], self.r1, 0,
                              spec.traffic["qual_char"])
        if self.paired:
            self.paths.append(os.path.join(tmp, "r2.fq"))
            generator.write_fastq(self.paths[1], self.r2, 0,
                                  spec.traffic["qual_char"])

    def batches(self, batch: int):
        """The stream's input as the port's CLI makes it, restarted at the
        pool's end with read ordinals still rising (tie-breaks hash the
        stream's ordinal)."""
        from hsa_tpu_torch.cli import _stream_batches, _zip_lockstep
        base = 0
        while True:
            if self.paired:
                for (s, n1, r1, q1), (_s, _n, r2, q2) in _zip_lockstep(
                        _stream_batches(self.paths[0], batch),
                        _stream_batches(self.paths[1], batch)):
                    yield base + s, n1, r1, q1, r2, q2
            else:
                for s, bn, br, bq in _stream_batches(self.paths[0], batch):
                    yield base + s, bn, br, bq
            base += self.n


def _stream(al, spec, reads, opt_args):
    from hsa_tpu_torch.cli import _prefetch
    from hsa_tpu_torch.config import PEOpt, SamseOpt
    cfg = spec.config
    src = _prefetch(reads.batches(cfg["batch"]))
    if reads.paired:
        return al.align_pe_stream(src, beam_width=opt_args.beam_width,
                                  peopt=PEOpt(max_isize=cfg["max_isize"]),
                                  emit="sam")
    return al.align_stream(src, beam_width=opt_args.beam_width,
                           sopt=SamseOpt(n_multi=cfg["n_multi"]), emit="sam")


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("portbench_metric", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload, seed, seconds, trace, *, device="cuda", root=ROOT,
        cache=genome.CACHE, t_start=None, out=sys.stdout, log=sys.stderr,
        aligner=None, numbers=None, dump=None):
    """One run; prints the result line and returns it (None when it may not
    print one).  ``aligner``: an ``Aligner`` of the cell's index already
    set up, used in place of a new one; ``numbers``: a dict that receives
    every number of the comparison, compared or read; ``dump``: a list that
    receives the judged records (``check.compare``)."""
    import torch
    from hsa_tpu_torch.pipeline import Aligner
    from . import check
    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(workload, root)
    cfg = spec.config
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < spec.cell["chips"]):
        print(f"portbench: {spec.cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=log)
        return None
    opt, opt_args = aln_options(cfg)
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = step("imports", t_start)
    g = genome.load_genome(cfg, cache)
    t = step("genome", t)

    def warm_tables(prefix):
        Aligner(prefix, opt, engine=cfg["engine"], device=device).warm_pigeon()

    prefix = genome.port_index(cfg, g, warm_tables, cache)
    t = step("index", t)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        reads = Reads(spec, g, seed, tmp)
        t = step("reads", t)
        al = aligner
        if al is None:
            al = Aligner(prefix, opt, engine=cfg["engine"], device=device)
            al.warm_pigeon()
        t = step("index_load", t)
        rec = spans.Recorder(al, reads.paired, trace)
        stream = _stream(al, spec, reads, opt_args)
        # set-up leaves out the making of the reads' pool: a user's job
        # finds its FASTQ written
        win = rec.run_window(stream, seconds, spec.params,
                             t_start + steps["reads"], tmp if trace else None,
                             device)
        step("warm_up", t)
        steps["warm_up"] -= win["window_s"]
        stream.close()
        ts = [win["t_open"]] + [y[0] for y in win["yields"]]
        print(f"portbench: set-up {json.dumps(steps)}; window "
              f"{win['window_s']:.3f} s, {win['n_batches']} batches, "
              f"{win['units']} units, {win['sam_bytes']} SAM bytes, "
              f"escalations in warm-up "
              f"{win['warm_escalations']}, process CPU "
              f"{win['cpu_s']:.1f} s (user {win['cpu_user_s']:.1f}, system "
              f"{win['cpu_sys_s']:.1f}); yield gaps "
              f"{[round(b - a, 2) for a, b in zip(ts, ts[1:])]}; profiles "
              f"{''.join(y[2][4][0] for y in win['yields'])}", file=log)
        t = time.perf_counter()
        peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
                else 0)
        kind = (torch.cuda.get_device_name() if device == "cuda"
                else "cpu")
        rec.detach()
        del al, stream
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers = {} if numbers is None else numbers
        numbers.update(check.judge(spec, g, reads, win, seed, cache, log,
                                   dump))
        print(f"portbench: the comparison took "
              f"{time.perf_counter() - t:.3f} s", file=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    unit = "pairs" if reads.paired else "reads"
    metrics = {}
    if trace:
        for m in spec.per_layer:
            v = load_reader(m["name"])(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {f"{unit}_per_s": win["units"] / win["window_s"],
                  "setup_s": win["setup_s"]}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": spec.cell["chips"], "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = win["profile"]["busy_s"]
        dev["window_s"] = win["profile"]["window_s"]
    limits = spec.params["limits"]
    checked = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    for k in sorted(set(numbers) - set(limits)):
        print(f"portbench: {k} {numbers[k]} (read, not compared)", file=log)
    result = {"correct": all(n["value"] <= n["limit"]
                             for n in checked.values()),
              "attempted": win["units"], "failed": numbers["missing"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = win["profile"]["breakdown"]
    result["checked"] = checked
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=log)
        return None
    for k, n in checked.items():
        print(f"{k} {n['value']} (limit {n['limit']})", file=log)
    print(json.dumps(result), file=out)
    return result


def main(argv=None, t_start=None):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    res = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start=t_start)
    return 0 if res is not None else 1
