"""Command-line interface of the port (counterpart of ``hsa_tpu/cli.py``).

Subcommands, in the reference's order: ``index`` (both packages read and
write the same index directory); the two-phase flow ``aln`` (search ->
``.sai.npz`` v2 position records, one part shard per batch, resumable),
``samse`` and ``sampe`` (resolve a ``.sai`` with its reads, or two with
their mates, to SAM; a ``.sai`` written by either package resolves in the
other); ``align`` (fused search + resolution -> SAM) and ``align-pe``
(paired ends, with mate rescue).  The searching commands take ``--engine
auto|pigeon|beam``, default ``auto``: the pigeonhole engine with the beam as
its fallback; ``--ladder 8,64`` makes that beam the adaptive one.  Options,
the ``--resume`` manifests and the ``--metrics`` JSON are ``hsa-tpu``'s;
``--device`` picks the torch device (default ``cuda``).

Usage:
    python -m hsa_tpu_torch.cli index ref.fa [-p prefix] [-s sa_intv]
    python -m hsa_tpu_torch.cli aln prefix reads.fq -f out.sai.npz
        [--engine auto] [--device cuda] [--metrics m.json] [--resume]
        [search opts]
    python -m hsa_tpu_torch.cli samse prefix out.sai.npz reads.fq
        [-f out.sam] [-n n_multi] [--device cuda] [--metrics m.json]
        [--resume]
    python -m hsa_tpu_torch.cli sampe prefix r1.sai.npz r2.sai.npz r1.fq
        r2.fq [-f out.sam] [-a max_isize] [-n n_multi] [--device cuda]
        [--metrics m.json] [--resume]
    python -m hsa_tpu_torch.cli align prefix reads.fq [-f out.sam]
        [--engine auto] [--device cuda] [--metrics m.json] [--resume]
        [search opts]
    python -m hsa_tpu_torch.cli align-pe prefix r1.fq r2.fq [-f out.sam]
        [-a max_isize] [--engine auto] [--device cuda] [--metrics m.json]
        [--resume] [search opts]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import sys
import threading
import time
from itertools import zip_longest

import numpy as np

from . import alphabet, metrics
from .config import AlnOpt, PEOpt, SamseOpt
from .io.fastq_fast import FastqBatcher
from .io.fastx import read_fasta, read_fastq, trim_read_length
from .io.sam import sam_header
from .metrics import RunMetrics
from .pipeline import ENGINES, Aligner, ReadBatch, build_index
from .refpack import ensure_refpack
from .resolve.samse import resolve_from_occ_arrays


def _add_search_opts(p):
    p.add_argument("-n", dest="n", default=None,
                   help="max #diff (int) or missing-prob (float, default 0.04)")
    p.add_argument("-o", dest="max_gapo", type=int, default=1, help="max gap opens")
    p.add_argument("-e", dest="max_gape", type=int, default=6, help="max gap extensions")
    p.add_argument("-l", dest="seed_len", type=int, default=32, help="seed length")
    p.add_argument("-k", dest="max_seed_diff", type=int, default=2, help="max seed diffs")
    p.add_argument("-M", dest="s_mm", type=int, default=3, help="mismatch penalty")
    p.add_argument("-O", dest="s_gapo", type=int, default=11, help="gap open penalty")
    p.add_argument("-E", dest="s_gape", type=int, default=4, help="gap extension penalty")
    p.add_argument("-q", dest="trim_qual", type=int, default=0,
                   help="3' quality trimming threshold (0 = off)")
    p.add_argument("-W", dest="beam_width", type=int, default=None,
                   help="beam width (frontier capacity per read)")
    p.add_argument("--ladder", default=None,
                   help="adaptive beam widths, e.g. 8,64 (overrides -W)")
    p.add_argument("--batch", type=int, default=16384,
                   help="reads per device batch")


def _opt_from_args(a) -> AlnOpt:
    opt = AlnOpt(max_gapo=a.max_gapo, max_gape=a.max_gape, seed_len=a.seed_len,
                 max_seed_diff=a.max_seed_diff, s_mm=a.s_mm, s_gapo=a.s_gapo,
                 s_gape=a.s_gape, trim_qual=getattr(a, "trim_qual", 0))
    if a.n is not None:
        try:
            opt.max_diff = int(a.n)
        except ValueError:
            opt.max_diff = -1
            opt.fnr = float(a.n)
    return opt


def _apply_trim(reads, quals, trim_qual):
    if trim_qual < 1:
        return reads, quals
    out_r, out_q = [], []
    for r, q in zip(reads, quals):
        L = trim_read_length(q, trim_qual)
        out_r.append(r[:L])
        out_q.append(q[:L] if q and q != "*" else q)
    return out_r, out_q


def _load_reads(path, limit=None):
    names, reads, quals = [], [], []
    it = read_fastq(path) if any(path.endswith(s) for s in
                                 (".fq", ".fastq", ".fq.gz", ".fastq.gz")) else None
    if it is not None:
        for name, seq, qual in it:
            names.append(name); reads.append(alphabet.encode(seq)); quals.append(qual)
            if limit and len(reads) >= limit:
                break
    else:
        for name, seq in read_fasta(path):
            names.append(name); reads.append(alphabet.encode(seq)); quals.append("*")
            if limit and len(reads) >= limit:
                break
    return names, reads, quals


def _iter_batches(names, reads, quals, batch):
    for s in range(0, len(reads), batch):
        yield s, names[s:s + batch], reads[s:s + batch], quals[s:s + batch]


def _prefetch(gen, depth: int = 2):
    """Run a batch generator on a reader thread, ``depth`` items ahead.

    The stream pipelines device work against host resolution, but the
    GENERATOR itself (gz inflate + FASTQ parse + name/qual string
    materialization) otherwise runs serially inside the stream's fill loop
    on the main thread.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(DONE)
        except BaseException as e:     # surface reader errors in-loop
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def _zip_lockstep(*iters):
    """zip() that FAILS when the streams exhaust unevenly.

    Plain zip() silently drops whole trailing batches when mate/.sai
    files differ by a multiple of the batch size — the per-batch length
    asserts never fire.  Streaming commands must use this instead.
    """
    sentinel = object()
    for tup in zip_longest(*iters, fillvalue=sentinel):
        assert sentinel not in tup, \
            "input streams exhausted unevenly (mate/.sai files do not match)"
        yield tup


def _manifest_path(out):
    return out + ".manifest.json"


def _load_manifest(out, args_key):
    """Completed-batch count if a matching resume manifest exists, else 0.

    Batch-granular restart (SURVEY.md §5 failure-recovery row): the input
    stream is resumable by read ordinal, so a crashed run resumes at the
    first incomplete batch.
    """
    if not out or not os.path.exists(_manifest_path(out)):
        return 0
    try:
        with open(_manifest_path(out)) as fh:
            m = json.load(fh)
        if m.get("args_key") == args_key:
            return int(m.get("completed_reads", 0))
    except Exception:
        pass
    return 0


def _save_manifest(out, args_key, completed_reads, total):
    if not out:
        return
    with open(_manifest_path(out), "w") as fh:
        json.dump(dict(args_key=args_key, completed_reads=completed_reads,
                       total_reads=total), fh)


def _stream_batches(path, batch, trim_qual=0):
    """Yield (start_ordinal, names, reads, quals) batches with bounded RSS.

    FASTQ goes through the native mmap batcher (no per-read Python objects
    until a batch materializes); FASTA falls back to the simple loader.
    """
    if any(path.endswith(s) for s in (".fq", ".fastq", ".fq.gz", ".fastq.gz")):
        s = 0
        for names, codes, lens, quals in FastqBatcher(path, batch=batch):
            lens = np.asarray(lens, np.int32)
            if trim_qual >= 1:
                tl = np.fromiter((trim_read_length(q, trim_qual)
                                  for q in quals), np.int32, len(quals))
                lens = np.minimum(lens, tl)
                quals = [q[:l] if q and q != "*" else q
                         for q, l in zip(quals, lens.tolist())]
            # trim the [B, max_len=512] parser matrix to the batch's
            # actual max read length: the packed-word count (and with it
            # the whole device program width) follows the matrix width,
            # so a 100bp batch in a 512-wide matrix would run a 4x-wider
            # search
            Lmax = int(lens.max()) if len(lens) else 1
            yield s, names, ReadBatch(codes[:, :max(Lmax, 1)], lens), quals
            s += len(names)
    else:
        names, reads, quals = _load_reads(path)
        reads, quals = _apply_trim(reads, quals, trim_qual)
        for s, bn, br, bq in _iter_batches(names, reads, quals, batch):
            yield s, bn, br, bq


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu-torch index")
    p.add_argument("fasta")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-s", "--sa-intv", type=int, default=32)
    a = p.parse_args(argv)
    # the index build is native only: the library is compiled with g++ at
    # first use, and its time is reported apart from the build
    t0 = time.perf_counter()
    ensure_refpack()
    print(f"[hsa-tpu-torch] native refpack library ready in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    out = build_index(a.fasta, a.prefix or a.fasta, sa_intv=a.sa_intv)
    print(f"[hsa-tpu-torch] index written to {out}", file=sys.stderr)


_OCC_FIELDS = ("rid", "pos", "strand", "score", "nmm", "ngapo", "ngape")


def cmd_aln(argv):
    """Search phase of the two-phase flow (``hsa-tpu aln``).

    The ``.sai.npz`` v2 holds position records (the located, deduped
    occurrence arrays of ``Aligner._align_occ`` with their truncation
    information) and the search options, field for field and dtype for
    dtype as ``hsa-tpu aln`` writes them: ``samse``/``sampe`` of either
    package re-apply the same trim and budgets and locate nothing.  Each
    batch runs its own beam fallback, as the reference's does (no pooling
    across batches), and is written as one part shard; the shards are
    merged, with ``rid`` made global, at the end.  ``--resume`` reuses the
    shards the manifest covers and, where the manifest and the ``.sai``
    show a finished run, searches nothing.
    """
    p = argparse.ArgumentParser(prog="hsa-tpu-torch aln")
    p.add_argument("prefix")
    p.add_argument("reads")
    p.add_argument("-f", "--out", required=True, help="output .sai.npz")
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its part shards")
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="search engine routing (default auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device to search on (default cuda)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="aln", reads=a.reads, batch=a.batch,
                      beam_width=a.beam_width, ladder=a.ladder,
                      engine=a.engine, device=a.device, opt=opt.to_dict())
    args_key = f"aln|{a.reads}|{a.batch}|{a.beam_width}|{a.n}|{a.engine}"
    done = _load_manifest(a.out, args_key) if a.resume else 0
    if done and _sai_finished(a.out, done, a.batch, opt):
        met.log(f"{a.out} already holds all {done} reads")
        met.count("reads_in", done)
        met.dump(a.metrics)
        return
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine,
                     device=a.device)
        al.warm_pigeon()       # K-mer tables: built once, loaded after
    if done:
        met.log(f"resuming at read {done}")
    parts_dir = a.out + ".parts"
    os.makedirs(parts_dir, exist_ok=True)
    # one part shard per batch: host memory stays flat whatever the input's
    # size, and the final .sai.npz is the shards' concatenation.  A shard
    # also holds the pigeon engine's repeat profile as the batch left it
    # (the profile moves from batch to batch), so that a resumed run
    # searches the next batch at the caps an uninterrupted run would
    n_reads = 0
    part_files = []
    for s, _bn, br, _bq in _stream_batches(a.reads, a.batch, opt.trim_qual):
        n_reads = s + len(br)
        pf = os.path.join(parts_dir, f"part_{s:012d}.npz")
        part_files.append(pf)
        if n_reads <= done and os.path.exists(pf):
            with np.load(pf) as z:
                if "profile" in z:
                    al._pigeon_profile = str(z["profile"])
                    al._profile_clean = int(z["profile_clean"])
            met.count("reads_in", len(br))
            continue
        prof = al._pigeon_profile
        with met.timer("search"):
            h = al._align_device(br, beam_width=a.beam_width)
            occ, trunc, c2x = al._align_occ(h, beam_width=a.beam_width)
        ld, _hd = al.last_overflow
        met.count("beam_overflow_reads", int((np.asarray(ld) > 0).sum()))
        met.count("reads_in", len(br))
        met.batches.append(dict(
            n=len(br), profile=prof,
            fallback=round(al.last_fallback_frac, 4),
            trunc=round(al.last_trunc_frac, 4),
            retry=round(al.last_retry_frac, 4)))
        np.savez(pf, nreads=np.int64(len(br)),
                 trunc=np.asarray(trunc, bool),
                 c2x=np.asarray(c2x, np.int64),
                 profile=al._pigeon_profile,
                 profile_clean=np.int64(al._profile_clean),
                 **{k: occ[k] for k in _OCC_FIELDS})
        _save_manifest(a.out, args_key, n_reads, -1)
        met.log(f"aln {n_reads} reads")
    # merge the shards in order, rid made global
    merged = {k: [] for k in _OCC_FIELDS + ("trunc", "c2x")}
    start = 0
    for pf in part_files:
        with np.load(pf) as z:
            for k in merged:
                merged[k].append(z[k] + start if k == "rid" else z[k])
            start += int(z["nreads"])
    np.savez_compressed(
        a.out, version=np.int64(2), batch=np.int64(a.batch),
        nreads=np.int64(start), opt=json.dumps(opt.to_dict()),
        **{k: (np.concatenate(v) if v else np.zeros(0, np.int64))
           for k, v in merged.items()})
    for pf in part_files:
        os.remove(pf)
    os.rmdir(parts_dir)
    met.dump(a.metrics)


def _sai_finished(path, nreads, batch, opt):
    """Whether ``path`` is the v2 .sai of a finished ``aln`` over ``nreads``
    reads in batches of ``batch`` with the search options ``opt``."""
    if not os.path.exists(path):
        return False
    try:
        sopt, sbatch, snreads = _sai_meta(path)
    except (SystemExit, OSError, ValueError, KeyError):
        return False
    return (sbatch, snreads, sopt.to_dict()) == (batch, nreads, opt.to_dict())


def _sai_meta(path):
    """(AlnOpt, batch_size, nreads) stored in a v2 .sai.npz."""
    with np.load(path) as z:
        if "version" not in z or int(z["version"]) != 2:
            raise SystemExit(f"error: {path} is not a v2 .sai.npz "
                             "(re-run `hsa-tpu-torch aln`)")
        return (AlnOpt(**json.loads(str(z["opt"]))), int(z["batch"]),
                int(z["nreads"]))


def _sai_stream(path):
    """Yield (start, occ dict (batch-local rid), trunc, c2x) per batch.

    The v2 payload is position records: the occurrence arrays are already
    located and deduped, so resolution needs no device locate pass.
    """
    with np.load(path) as z:
        if "version" not in z or int(z["version"]) != 2:
            raise SystemExit(f"error: {path} is not a v2 .sai.npz")
        bsz = max(int(z["batch"]), 1)
        nreads = int(z["nreads"])
        fields = {k: z[k] for k in _OCC_FIELDS}
        trunc = z["trunc"]
        c2x = z["c2x"]
    rid = fields["rid"]
    if not (rid[1:] >= rid[:-1]).all():
        raise ValueError(f"corrupt .sai stream (rid order): {path}")
    if len(trunc) != nreads or len(c2x) != nreads:
        raise ValueError(f"corrupt .sai: {path}")
    for s in range(0, nreads, bsz):
        e = min(s + bsz, nreads)
        lo, hi = np.searchsorted(rid, [s, e])
        occ = {k: (v[lo:hi] - s if k == "rid" else v[lo:hi])
               for k, v in fields.items()}
        yield s, occ, trunc[s:e], c2x[s:e]


def _sam_sink(a, args_key):
    """(SAM sink, reads or pairs already written): with ``--resume`` and a
    manifest that matches ``args_key`` the output ``-f`` is appended to,
    else written anew (stdout without ``-f``)."""
    done = _load_manifest(a.out, args_key) if a.resume else 0
    if not a.out:
        return contextlib.nullcontext(sys.stdout), done
    return open(a.out, "a" if done else "w"), done


def cmd_samse(argv):
    """Resolve a ``.sai.npz`` (either package's ``aln``) with its reads to
    SAM (``hsa-tpu samse``): the aln-time options come from the ``.sai``,
    so trim and budgets are applied again and resolution sees exactly the
    reads the search saw."""
    p = argparse.ArgumentParser(prog="hsa-tpu-torch samse")
    p.add_argument("prefix")
    p.add_argument("sai")
    p.add_argument("reads")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-n", dest="n_multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run (requires -f)")
    p.add_argument("--device", default="cuda",
                   help="torch device the index loads onto (default cuda)")
    a = p.parse_args(argv)
    met = RunMetrics()
    opt, bsz, _n_sai = _sai_meta(a.sai)
    met.config = dict(cmd="samse", sai=a.sai, reads=a.reads, device=a.device,
                      opt=opt.to_dict())
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, device=a.device)
    args_key = f"samse|{a.sai}|{a.reads}|{bsz}"
    sink, done = _sam_sink(a, args_key)
    sopt = SamseOpt(n_multi=a.n_multi)
    n = 0
    with sink as out:
        if not done:
            out.write(sam_header(al.meta, "samse"))
        else:
            met.log(f"resuming at read {done}")
        for (s, bn, br, bq), (s2, occ, trunc, c2x) in _zip_lockstep(
                _stream_batches(a.reads, bsz, opt.trim_qual),
                _sai_stream(a.sai)):
            if s != s2 or len(br) != len(trunc):
                raise ValueError(f"read file {a.reads} does not match .sai "
                                 f"{a.sai}")
            n = s + len(br)
            if n <= done:
                met.count("reads_in", len(br))
                continue
            with met.timer("resolve"):
                lines, flags = resolve_from_occ_arrays(
                    al.text, al.meta, br, bn, bq, occ, trunc.tolist(), opt,
                    sopt, read_offset=s, emit="sam", c2_extra=c2x)
            out.write("\n".join(lines) + "\n")
            met.count("reads_in", len(br))
            met.count("records_out", len(lines))
            met.count("reads_mapped", sum(1 for f in flags if not f & 4))
            _save_manifest(a.out, args_key, n, -1)
        out.flush()
    print(f"[hsa-tpu-torch samse] {n} reads", file=sys.stderr)
    met.dump(a.metrics)


@contextlib.contextmanager
def _traced(met, on: bool):
    """The tracer on over a command's stream where ``--metrics`` asks for
    its metrics: each span name's seconds and count go into them."""
    if not on or metrics.enabled():
        yield
        return
    metrics.enable()
    try:
        yield
    finally:
        metrics.disable()
        met.spans = metrics.totals()


def _write_stream(stream, out, met, al, path, args_key, *, pairs: bool):
    """Write a stream of ``(start, (SAM lines, flags))`` batches to ``out``:
    per batch its metrics, its lines and the resume manifest.  With
    ``pairs`` a batch is of pairs (two lines each) and its metrics also
    hold its mate-rescue job count."""
    while True:
        t0 = time.perf_counter()
        with met.timer("align"):   # wall per batch incl. overlap wait
            item = next(stream, None)
        if item is None:
            return
        s, (lines, flags) = item
        total = s + (len(lines) // 2 if pairs else len(lines))
        met.note_batch(len(lines), lines, al.last_overflow, flags=flags,
                       aligner=al)
        # How long this yield was waited for.  Batches are searched ahead,
        # concurrently, so this is no per-batch latency or rate: reads/s is
        # all reads over the whole align window.
        met.batches[-1]["wait_s"] = time.perf_counter() - t0
        if pairs:
            met.batches[-1]["rescue_jobs"] = al.last_rescue_jobs
        with met.timer("write"):
            out.write("\n".join(lines))
            out.write("\n")
            out.flush()
        _save_manifest(path, args_key, total, -1)
        met.log(f"{met.config['cmd']} {total} {'pairs' if pairs else 'reads'}")


def cmd_align(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu-torch align")
    p.add_argument("prefix")
    p.add_argument("reads")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("--n-multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler chrome trace of one batch "
                        "to this dir")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its .manifest.json")
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="search engine routing (default auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device to search on (default cuda)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="align", reads=a.reads, batch=a.batch,
                      beam_width=a.beam_width, engine=a.engine,
                      device=a.device, opt=opt.to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine,
                     device=a.device)
        al.warm_pigeon()       # K-mer tables: built once, loaded after
    args_key = f"align|{a.reads}|{a.batch}|{a.beam_width}|{a.n}"
    sink, done = _sam_sink(a, args_key)
    with sink as out, _traced(met, bool(a.metrics)):
        if not done:
            out.write(sam_header(al.meta, "align"))
        if done:
            met.log(f"resuming at read {done}")
        sopt = SamseOpt(n_multi=a.n_multi)
        trim = getattr(a, "trim_qual", 0)
        # Streaming single-phase flow: each batch is searched, resolved and
        # written in input order.  The default path is pipelined
        # (Aligner.align_stream); --profile runs batches one at a time so the
        # trace holds one isolated batch.
        total = 0
        if a.profile:
            profiled = False
            for s, bn, br, bq in _stream_batches(a.reads, a.batch, trim):
                total = s + len(br)
                if total <= done:
                    continue
                if not profiled:
                    from torch.profiler import ProfilerActivity, profile
                    profiled = True
                    acts = [ProfilerActivity.CPU]
                    if al.device.type == "cuda":
                        acts.append(ProfilerActivity.CUDA)
                    with profile(activities=acts) as prof:
                        recs = al.align(br, bn, bq, read_offset=s,
                                        beam_width=a.beam_width, sopt=sopt)
                    os.makedirs(a.profile, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(a.profile, "trace.json"))
                    met.log(f"profiler trace written to {a.profile}")
                else:
                    with met.timer("align"):
                        recs = al.align(br, bn, bq, read_offset=s,
                                        beam_width=a.beam_width, sopt=sopt)
                met.note_batch(len(br), recs, al.last_overflow, aligner=al)
                with met.timer("write"):
                    for r in recs:
                        out.write(r.to_sam() + "\n")
                    out.flush()
                _save_manifest(a.out, args_key, total, -1)
                met.log(f"align {total} reads")
        else:
            def todo():
                for s, bn, br, bq in _stream_batches(a.reads, a.batch, trim):
                    if s + len(br) > done:
                        yield s, bn, br, bq
            _write_stream(al.align_stream(_prefetch(todo()),
                                          beam_width=a.beam_width, sopt=sopt,
                                          emit="sam"),
                          out, met, al, a.out, args_key, pairs=False)
    s = met.dump(a.metrics)
    met.log(f"done: {s.get('reads_mapped', 0)}/{s.get('reads_in', 0)} mapped, "
            f"{s.get('beam_overflow_reads', 0)} overflow reads")


def cmd_align_pe(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu-torch align-pe")
    p.add_argument("prefix")
    p.add_argument("reads1")
    p.add_argument("reads2")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-a", dest="max_isize", type=int, default=500)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its .manifest.json")
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="search engine routing (default auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device to search and rescue on (default cuda)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="align-pe", reads1=a.reads1, reads2=a.reads2,
                      batch=a.batch, beam_width=a.beam_width, engine=a.engine,
                      device=a.device, opt=opt.to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine,
                     device=a.device)
        al.warm_pigeon()       # K-mer tables: built once, loaded after
    args_key = f"align-pe|{a.reads1}|{a.reads2}|{a.batch}|{a.beam_width}|{a.n}"
    sink, done = _sam_sink(a, args_key)
    with sink as out, _traced(met, bool(a.metrics)):
        if not done:
            out.write(sam_header(al.meta, "align-pe"))
        else:
            met.log(f"resuming at pair {done}")
        peopt = PEOpt(max_isize=a.max_isize)
        trim = getattr(a, "trim_qual", 0)

        # both mates' batches advance in lockstep; each pair batch is
        # searched (ahead, on worker threads), resolved and written in
        # input order
        def todo():
            for (s, n1, r1, q1), (s2, _n2, r2, q2) in _zip_lockstep(
                    _stream_batches(a.reads1, a.batch, trim),
                    _stream_batches(a.reads2, a.batch, trim)):
                if s != s2 or len(r1) != len(r2):
                    raise ValueError(f"{a.reads1} and {a.reads2} differ in "
                                     "read count")
                if s + len(r1) > done:
                    yield s, n1, r1, q1, r2, q2
        _write_stream(al.align_pe_stream(_prefetch(todo()),
                                         beam_width=a.beam_width, peopt=peopt,
                                         emit="sam"),
                      out, met, al, a.out, args_key, pairs=True)
    s_ = met.dump(a.metrics)
    met.log(f"done: {s_.get('reads_mapped', 0)}/{s_.get('reads_in', 0)} "
            "ends mapped")


def cmd_sampe(argv):
    """Resolve two ``.sai.npz`` (either package's ``aln`` over each mate
    file) with their mates to paired SAM (``hsa-tpu sampe``); the mate
    rescue screens on ``--device``.  Both ``.sai`` files must agree on batch
    size and search options."""
    p = argparse.ArgumentParser(prog="hsa-tpu-torch sampe")
    p.add_argument("prefix")
    p.add_argument("sai1")
    p.add_argument("sai2")
    p.add_argument("reads1")
    p.add_argument("reads2")
    p.add_argument("-f", "--out", default=None)
    p.add_argument("-a", dest="max_isize", type=int, default=500)
    p.add_argument("-n", dest="n_multi", type=int, default=3)
    p.add_argument("--metrics", default=None, help="write run metrics JSON here")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run (requires -f)")
    p.add_argument("--device", default="cuda",
                   help="torch device to rescue mates on (default cuda)")
    a = p.parse_args(argv)
    met = RunMetrics()
    opt, bsz, _n1 = _sai_meta(a.sai1)
    opt2, bsz2, _n2 = _sai_meta(a.sai2)
    if bsz != bsz2:
        raise ValueError(".sai batch sizes differ")
    if opt.to_dict() != opt2.to_dict():
        raise ValueError(".sai search options differ")
    met.config = dict(cmd="sampe", sai1=a.sai1, sai2=a.sai2, device=a.device,
                      opt=opt.to_dict())
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, device=a.device)
    peopt = PEOpt(max_isize=a.max_isize, n_multi=a.n_multi)
    args_key = f"sampe|{a.sai1}|{a.sai2}|{a.reads1}|{a.reads2}|{bsz}"
    sink, done = _sam_sink(a, args_key)
    n = 0
    with sink as out:
        if not done:
            out.write(sam_header(al.meta, "sampe"))
        else:
            met.log(f"resuming at pair {done}")
        # both mates' read and .sai streams advance in lockstep; insert-size
        # inference is batch-local, as in align-pe
        for (s, n1, r1, q1), (s2, _n2, r2, q2), (s3, occ1, tr1, cx1), \
                (s4, occ2, tr2, cx2) in _zip_lockstep(
                    _stream_batches(a.reads1, bsz, opt.trim_qual),
                    _stream_batches(a.reads2, bsz, opt.trim_qual),
                    _sai_stream(a.sai1), _sai_stream(a.sai2)):
            if not (s == s2 == s3 == s4 and len(r1) == len(r2) == len(tr1)):
                raise ValueError("mate/sai files do not match")
            n = s + len(r1)
            if n <= done:
                met.count("reads_in", 2 * len(r1))
                continue
            with met.timer("resolve"):
                # one occurrence dict over both ends (end 2's rid shifted by
                # B): each .sai block is rid-sorted, so the concatenation is
                # in the canonical (rid, score, strand, pos) order
                B = len(r1)
                occ = {k: np.concatenate([occ1[k], occ2[k] + B if k == "rid"
                                          else occ2[k]])
                       for k in occ1}
                lines, _flags = al._resolve_pe(
                    r1, r2, n1, q1, q2, occ,
                    np.concatenate([tr1, tr2]).astype(bool),
                    np.concatenate([cx1, cx2]), read_offset=s, peopt=peopt,
                    emit="sam")
            out.write("\n".join(lines))
            out.write("\n")
            met.count("reads_in", 2 * B)
            met.count("records_out", len(lines))
            met.batches.append(dict(n=len(lines),
                                    rescue_jobs=al.last_rescue_jobs))
            _save_manifest(a.out, args_key, n, -1)
        out.flush()
    print(f"[hsa-tpu-torch sampe] {n} pairs", file=sys.stderr)
    met.dump(a.metrics)


COMMANDS = {"index": cmd_index, "aln": cmd_aln, "samse": cmd_samse,
            "sampe": cmd_sampe, "align": cmd_align, "align-pe": cmd_align_pe}


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: hsa-tpu-torch {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
