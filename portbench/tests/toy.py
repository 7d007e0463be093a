"""A toy copy of the benchmark's files for CPU tests: the same cell names
and metrics over a small genome and small batches."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)


def toy_root(tmp, genome_bp=300_000, batch=256, pool_batches=4,
             sample=24, limits=None, workers=0):
    """A directory shaped as the repository's root for ``Spec``: the real
    ``BENCHMARK.json``, traffic and configurations, cut to ``genome_bp``
    bases, ``batch`` reads a batch, ``sample`` sampled reads and
    ``workers`` reference processes."""
    root = os.path.join(tmp, "root")
    for sub in ("configs", "traffic", "cells"):
        shutil.copytree(os.path.join(PB, sub),
                        os.path.join(root, "portbench", sub))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        p = os.path.join(root, c["file"])
        with open(p) as fh:
            cfg = json.load(fh)
        cfg["genome"]["length"] = genome_bp
        cfg["batch"] = batch
        with open(p, "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        p = os.path.join(root, "portbench", "cells", w["name"] + ".json")
        with open(p) as fh:
            cell = json.load(fh)
        cell.update(pool_batches=pool_batches, warm_batches=2,
                    warm_max_batches=6, sample=sample,
                    reference_workers=workers)
        if limits:
            cell["limits"].update(limits)
        with open(p, "w") as fh:
            json.dump(cell, fh)
    return root, bench
