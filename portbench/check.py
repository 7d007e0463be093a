"""The comparison that decides ``correct``.

Every record of the window is checked to have come, in order, under its
read's name (``missing``).  A sample of the window's reads (pairs), drawn
from the seed, is aligned again by the plain reference
(``reference/oracle.py``: a frozen copy of the port's oracle on its own index
of the genome) at the read's own ordinal in the stream, and the port's
records are judged against it:

- ``status_diff``: the share of sampled reads (ends) mapped by one side
  only;
- ``line_diff``: the share of sampled reads (pairs) whose records are not the
  reference's, held as :func:`_judge` says: a read the reference finds
  repetitive (:func:`repeats`) by its flag (strand aside), edit score and
  best positions; a read the port marks as capped (no ``X1``; the port also
  caps where a batch's candidate pool overflows) by every field but ``X1``
  and ``XA``, MAPQ at most the reference's; any other read by its whole
  line.  A pair is repetitive when one of its ends is.

A read is repetitive where the cap of the route it takes in the port could
have cut its hits (``docs/PARITY.md`` #14).  Where every read takes the beam
(:func:`beam_route`: ``-o`` over 1, or the engine ``beam``), the cap is the
beam's hit buffer: a read is repetitive where, on either strand, the
reference counts more hits than the buffer holds (``BEAM_HITS``), counted as
the buffer stores them (``oracle.buffer_hits``).  On every other
configuration the cap is the pigeon search's: some :func:`repeat_k` of its
bases occur more than ``REPEAT_OVER`` times.

A cell compares the numbers its ``limits`` name (``cells/<cell>.json``),
each limit set from the readings in ``PERF.md``; the others are printed as
readings.
"""

from __future__ import annotations

import os
import re
from collections import Counter

import numpy as np

from . import genome
from .reference import oracle, pool
from .reference.paired import PairedReference, model_of
from .traffic.generator import read_name

_CIGAR = re.compile(r"(\d+)([MID])")
# the least segment cap of the port's pigeon search (``seg_cap``)
REPEAT_OVER = 32
# the hit buffer of the port's beam: ``max_hits``, as ``Aligner.align_stream``
# and ``align_pe_stream`` default it (``search/beam.py:beam_search`` too) and
# the stream passes it on
BEAM_HITS = 32


def beam_route(cfg) -> bool:
    """Whether every read of the configuration takes the port's beam: ``-o``
    over 1 (``pipeline.py:_pigeon_split``) or the engine ``beam``."""
    return cfg["engine"] == "beam" or int(cfg["options"]["-o"]) > 1


def repeat_k(L: int, opt) -> int:
    """The shortest segment of the port's pigeonhole partition of an
    ``L``-base read: ``L // (budget + 1)``."""
    return L // (opt.diff_budget(L) + 1)


def repeats(refs, reads, L, opt, beam):
    """Each ``L``-base read's mark as repetitive by the reference's workers
    ``refs``: on the beam route (``beam``) where its hit buffer could have
    been cut, on the pigeon route by :func:`repeat_k` and ``REPEAT_OVER``."""
    if beam:
        return refs.beam_repeats(reads, BEAM_HITS)
    return refs.repeats(reads, repeat_k(L, opt), REPEAT_OVER)


def reference_opt(cfg, budget_less: int = 0) -> oracle.Opt:
    """The reference's options from the configuration's ``bwa aln`` flags;
    ``budget_less`` lowers the difference budget (the control)."""
    o = cfg["options"]
    opt = oracle.Opt(max_gapo=int(o["-o"]), max_gape=int(o["-e"]),
                     seed_len=int(o["-l"]), max_seed_diff=int(o["-k"]),
                     s_mm=int(o["-M"]), s_gapo=int(o["-O"]),
                     s_gape=int(o["-E"]), n_multi=int(cfg["n_multi"]))
    try:
        opt.max_diff = int(o["-n"])
    except ValueError:
        opt.fnr = float(o["-n"])
    if budget_less:
        opt.max_diff = opt.diff_budget(cfg["read_length"]) - budget_less
    return opt


def reference_paths(cfg, g, cache):
    """The cached arrays of the reference's index of ``g`` (built once: the
    suffix arrays by prefix doubling, and their occ tables)."""
    def build(d):
        for tag, t in (("fwd", g), ("rev", g[::-1].copy())):
            sa = oracle.suffix_array(t)
            np.save(os.path.join(d, f"sa_{tag}.npy"), sa)
            np.save(os.path.join(d, f"cum_{tag}.npy"), oracle.occ_table(t, sa))
            del sa

    d = genome.entry("refsa", genome.genome_key(cfg), build, cache)
    paths = {k: os.path.join(d, k + ".npy")
             for k in ("sa_fwd", "sa_rev", "cum_fwd", "cum_rev")}
    paths["genome"] = genome.genome_file(cfg, cache)
    return paths


def reference(cfg, g, cache, opts, workers):
    """The reference's workers over ``g`` under each of ``opts``."""
    return pool.Refs(reference_paths(cfg, g, cache), cfg["genome"]["name"],
                     opts, workers)


def edit_score(line: str, read, g, opt) -> int:
    """The edit score of a mapped record's alignment, from its position,
    strand and CIGAR against the genome."""
    f = line.split("\t")
    aln = oracle.revcomp(read) if int(f[1]) & 16 else np.asarray(read)
    p = int(f[3]) - 1
    score, i = 0, 0
    for ln, op in _CIGAR.findall(f[5]):
        ln = int(ln)
        if op == "M":
            ref = g[p:p + ln]
            rd = aln[i:i + ln]
            score += opt.s_mm * int(((rd != ref) | (rd > 3)).sum())
            i += ln
            p += ln
        else:
            score += opt.s_gapo + (ln - 1) * opt.s_gape
            if op == "I":
                i += ln
            else:
                p += ln
    return score


def count_missing(batches, n_pool, batch, paired) -> int:
    """Records that did not come: per batch, the records short of one a
    read (two a pair) or not named as the pool's read at their ordinal, and
    whole batches skipped."""
    missing, expect = 0, batches[0][0] if batches else 0
    per = 2 if paired else 1
    for s, lines in batches:
        if s != expect:
            missing += abs(s - expect)
        expect = s + batch
        ok = 0
        for j in range(batch):
            want = read_name((s + j) % n_pool)
            ok += all(len(lines) > per * j + e and lines[per * j + e]
                      .split("\t", 1)[0] == want for e in range(per))
        missing += batch - ok
    return missing


def sample(win, seed, k, paired=False):
    """``k`` reads (pairs) of the window drawn from the seed: (ordinal,
    line) or (ordinal, line 1, line 2)."""
    per = 2 if paired else 1
    units = [(s + j, *b[per * j:per * j + per]) for s, b in win["batches"]
             for j in range(len(b) // per)]
    rng = np.random.default_rng([seed, 17])
    pick = np.sort(rng.choice(len(units), size=min(k, len(units)),
                              replace=False))
    return [units[i] for i in pick]


def _mapped(line):
    return not int(line.split("\t", 2)[1]) & 4


def _no_x1(line):
    """A mapped record found by the search with no ``X1``: the port's mark
    of a capped enumeration."""
    return (_mapped(line) and "\tX1:i:" not in line
            and "\tXT:Z:M" not in line)


def _where(f):
    return int(f[3]) - 1, 1 if int(f[1]) & 16 else 0


def _score(line, read, g, opt):
    return edit_score(line, read, g, opt) if _mapped(line) else None


# the flag's strand bits (the read's and its mate's): part of the pick among
# equal hits
_STRANDS = 0x10 | 0x20


def _core_same(line, wline, score, wscore, allowed):
    """A repetitive read's record: the reference's flag but for the strand
    bits, the reference's edit score, and a position and strand of
    ``allowed`` (None: not held)."""
    f, w = line.split("\t"), wline.split("\t")
    return ((int(f[1]) ^ int(w[1])) & ~_STRANDS == 0 and score == wscore
            and (score is None or allowed is None or _where(f) in allowed))


def _tags(f):
    return {t[:2]: t for t in f[11:] if t[:2] not in ("X1", "XA")}


def _capped_same(line, wline):
    """A record the port marks as capped, of a read the reference does not
    find repetitive: every field the reference's, but ``X1`` and ``XA``
    (the cut enumeration's) left out and MAPQ at most the reference's."""
    f, w = line.split("\t"), wline.split("\t")
    return (f[:4] == w[:4] and f[5:11] == w[5:11]
            and int(f[4]) <= int(w[4]) and _tags(f) == _tags(w))


def _judge(lines, wlines, scores, wscores, allowed, repeat):
    """Whether a read's (pair's) records are the reference's: held as
    :func:`_core_same` where it is repetitive, as :func:`_capped_same`
    where the port marks a record as capped, else line for line."""
    if repeat:
        return all(map(_core_same, lines, wlines, scores, wscores, allowed))
    if any(map(_no_x1, lines)):
        return all(map(_capped_same, lines, wlines))
    return list(lines) == list(wlines)


def compare(refs, g, reads, n_pool, got, opt, log=None, dump=None,
            beam=False):
    """The sample's numbers: ``got`` is [(ordinal, line)] of the side judged
    (the port's records, or the control's); ``refs`` the reference's
    workers (option set 0).  ``dump``: a list that receives each read's
    records and what they were judged by; ``beam``: the configuration's
    reads take the beam (:func:`beam_route`)."""
    qual = "2" * reads.shape[1]
    sampled = [reads[o % n_pool] for o, _line in got]
    want = refs.align(0, [(r, read_name(o % n_pool), qual, o)
                          for r, (o, _line) in zip(sampled, got)])
    rep = repeats(refs, sampled, reads.shape[1], opt, beam)
    status = diff = outside = 0
    shown = Counter()
    for (o, line), (wline, best, best_set, trunc), read, r in zip(
            got, want, sampled, rep):
        if _mapped(line) != (best is not None):
            status += 1
            _show(log, shown, "status_diff", line, wline)
        outside += _no_x1(line) and not r
        one = dict(o=o, p=[line], w=[wline], r=r,
                   sp=[_score(line, read, g, opt)],
                   sw=[_score(wline, read, g, opt)],
                   a=[None if trunc else sorted(best_set)])
        if not _judge(one["p"], one["w"], one["sp"], one["sw"],
                      [x and set(x) for x in one["a"]], r):
            diff += 1
            _show(log, shown, "line_diff", line, wline)
        if dump is not None:
            dump.append(one)
    n = max(len(got), 1)
    return dict(status_diff=status / n, line_diff=diff / n,
                repeat_share=sum(rep) / n, no_x1_outside=outside / n)


def _show(log, shown, what, got, want):
    """The first few records of each kind that differ, to ``log``."""
    if log is None or shown[what] >= 3:
        return
    shown[what] += 1
    print(f"portbench: {what}\n  program:   {got[:600]}\n  reference: "
          f"{want[:600]}", file=log)


def _allowed(wline, occs, trunc):
    """The (position, strand) pairs an end may take: the reference's own
    and those of its occurrences at the same score (None where the list
    is cut)."""
    if trunc:
        return None
    where = _where(wline.split("\t"))
    score = next((o.score for o in occs if (o.pos, o.strand) == where), None)
    return {where} | {(o.pos, o.strand) for o in occs if o.score == score}


def compare_pe(refs, pref, g, reads1, reads2, n_pool, got, opt, models,
               log=None, dump=None, beam=False):
    """The sample's numbers for pairs: ``got`` is [(ordinal, line 1, line
    2)], ``models`` each pair's insert-size model; ``pref`` (the paired
    reference over ``refs``) resolves the sampled pairs together as one
    batch.  Status is judged by end, the lines by pair; ``dump`` and
    ``beam`` as for :func:`compare`."""
    L = reads1.shape[1]
    qual = "2" * L
    ends = [(reads1[o % n_pool], reads2[o % n_pool]) for o, _a, _b in got]
    want, occs = pref.resolve_ends(
        [(r1, r2, read_name(o % n_pool), qual, qual, o)
         for (r1, r2), (o, _a, _b) in zip(ends, got)], models)
    rep = repeats(refs, [r for pair in ends for r in pair], L, opt, beam)
    status = diff = outside = 0
    shown = Counter()
    for k, (o, l1, l2) in enumerate(got):
        w = want[2 * k:2 * k + 2]
        for e, line in enumerate((l1, l2)):
            if _mapped(line) != _mapped(w[e]):
                status += 1
                _show(log, shown, "status_diff", line, w[e])
            outside += _no_x1(line) and not rep[2 * k + e]
        allowed = [_allowed(w[e], *occs[2 * k + e]) for e in (0, 1)]
        one = dict(o=o, p=[l1, l2], w=w, r=rep[2 * k] or rep[2 * k + 1],
                   sp=[_score(x, r, g, opt) for x, r in zip((l1, l2),
                                                            ends[k])],
                   sw=[_score(x, r, g, opt) for x, r in zip(w, ends[k])],
                   a=[x and sorted(x) for x in allowed])
        if not _judge(one["p"], w, one["sp"], one["sw"], allowed, one["r"]):
            diff += 1
            _show(log, shown, "line_diff", l1 + "\n  " + l2, "\n  ".join(w))
        if dump is not None:
            dump.append(one)
    n = max(len(got), 1)
    return dict(status_diff=status / (2 * n), line_diff=diff / n,
                repeat_share=sum(rep) / (2 * n),
                no_x1_outside=outside / (2 * n))


def models_of(got, frags, n_pool, batch, max_isize):
    """Each sampled pair's insert-size model: that of its batch's true
    outer distances (the port infers it from the batch's unique pairs)."""
    cache = {}
    out = []
    for o, *_lines in got:
        s = o // batch * batch
        if s not in cache:
            cache[s] = model_of(frags[np.arange(s, s + batch) % n_pool],
                                max_isize)
        out.append(cache[s])
    return out


def paired_reference(cfg, refs, which, g):
    """The paired reference over the workers' option set ``which``."""
    return PairedReference(
        g, cfg["genome"]["name"], refs.refs[which].opt,
        lambda reads: refs.occurrences(which, reads, PairedReference.MAX_OCC),
        cfg["max_isize"], n_multi=cfg["n_multi"])


def judge(spec, g, reads, win, seed, cache, log=None, dump=None):
    """{name: value} of every number of the comparison; the cell's
    ``limits`` say which are compared.  ``dump``: as for :func:`compare`."""
    cfg = spec.config
    numbers = {"missing": count_missing(win["batches"], reads.n, cfg["batch"],
                                        reads.paired)}
    opt = reference_opt(cfg)
    got = sample(win, seed, spec.params["sample"], reads.paired)
    with reference(cfg, g, cache, [opt],
                   spec.params["reference_workers"]) as refs:
        if reads.paired:
            models = models_of(got, reads.frag, reads.n, cfg["batch"],
                               cfg["max_isize"])
            numbers.update(compare_pe(refs, paired_reference(cfg, refs, 0, g),
                                      g, reads.r1, reads.r2, reads.n, got,
                                      opt, models, log, dump,
                                      beam_route(cfg)))
        else:
            numbers.update(compare(refs, g, reads.r1, reads.n, got, opt, log,
                                   dump, beam_route(cfg)))
    return numbers
