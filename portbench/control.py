"""The control of the comparison: the plain reference put in the program's
place at a lower difference budget (one below the configuration's), judged
by the same numbers on the cell's own genome and traffic.  It runs on the
host alone (the reference is numpy) and is no part of a benchmark run;
``readings.py`` runs it over seeds.
"""

from __future__ import annotations

import numpy as np

from portbench import check, genome
from portbench.traffic import generator


def control_numbers(spec, seed, cache=genome.CACHE, dump=None):
    """The numbers of the control on ``seed``: ``sample`` reads of the
    seed's pool, at their pool ordinals, aligned by the reference at a
    budget one lower and judged against the reference (``dump`` as for
    ``check.compare``)."""
    cfg = spec.config
    paired = cfg["mode"] == "pe"
    g = genome.load_genome(cfg, cache)
    n = spec.params["pool_batches"] * cfg["batch"]
    d = generator.draw(spec.traffic, g, n, cfg["read_length"], paired, seed)
    r1, r2 = d["r1"], d["r2"]
    opt = check.reference_opt(cfg)
    rng = np.random.default_rng([seed, 17])
    ords = np.sort(rng.choice(n, size=spec.params["sample"], replace=False))
    qual = "2" * cfg["read_length"]
    names = [generator.read_name(int(o)) for o in ords]
    with check.reference(cfg, g, cache,
                         [opt, check.reference_opt(cfg, 1)],
                         spec.params["reference_workers"]) as refs:
        if paired:
            models = check.models_of([(int(o),) for o in ords], d["frag"], n,
                                     cfg["batch"], cfg["max_isize"])
            lines = check.paired_reference(cfg, refs, 1, g).resolve(
                [(r1[o], r2[o], nm, qual, qual, int(o))
                 for o, nm in zip(ords, names)], models)
            got = [(int(o), lines[2 * k], lines[2 * k + 1])
                   for k, o in enumerate(ords)]
            return check.compare_pe(refs, check.paired_reference(cfg, refs, 0,
                                                                 g),
                                    g, r1, r2, n, got, opt, models,
                                    dump=dump, beam=check.beam_route(cfg))
        low = refs.align(1, [(r1[o], nm, qual, int(o))
                             for o, nm in zip(ords, names)])
        got = [(int(o), w[0]) for o, w in zip(ords, low)]
        return check.compare(refs, g, r1, n, got, opt, dump=dump,
                             beam=check.beam_route(cfg))
