"""The readings that the limits of ``correct`` are set from: every number
of the comparison for the program over ``--seeds`` (short windows at the
cell's own load, one ``Aligner`` set up once), then for the control over
``--control-seeds``, one JSON line a seed; with ``--dump DIR``, each
seed's judged records as ``DIR/<cell>.<side>.<seed>.json.gz``.

    python3 portbench/readings.py --workload <cell> --seeds 1,2 \
        --control-seeds 3,4,5 --seconds 10 [--dump DIR]

Needs a CUDA device for ``--seeds``; no part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import genome, harness  # noqa: E402
from portbench import run as _caches  # noqa: E402,F401  (cache directories)
from portbench.control import control_numbers  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def _write(where, cell, side, seed, records):
    if where:
        os.makedirs(where, exist_ok=True)
        with gzip.open(os.path.join(where, f"{cell}.{side}.{seed}.json.gz"),
                       "wt") as fh:
            json.dump(records, fh)


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--dump", default="")
    a = p.parse_args(argv)
    spec = harness.Spec(a.workload)
    seeds = _seeds(a.seeds)
    if seeds:
        from hsa_tpu_torch.pipeline import Aligner
        cfg = spec.config
        opt, _args = harness.aln_options(cfg)
        prefix = genome.port_index(
            cfg, genome.load_genome(cfg),
            lambda pr: Aligner(pr, opt, engine=cfg["engine"],
                               device="cuda").warm_pigeon())
        al = Aligner(prefix, opt, engine=cfg["engine"], device="cuda")
        al.warm_pigeon()
        for s in seeds:
            nums, rec = {}, []
            res = harness.run(a.workload, s, a.seconds, False, aligner=al,
                              numbers=nums, dump=rec, out=io.StringIO())
            _write(a.dump, a.workload, "program", s, rec)
            print(json.dumps(dict(seed=s, side="program",
                                  correct=res["correct"], **nums)),
                  flush=True)
    for s in _seeds(a.control_seeds):
        t0 = time.perf_counter()
        rec = []
        nums = control_numbers(spec, s, dump=rec)
        _write(a.dump, a.workload, "control", s, rec)
        print(json.dumps(dict(seed=s, side="control",
                              seconds=time.perf_counter() - t0, **nums)),
              flush=True)


if __name__ == "__main__":
    main()
