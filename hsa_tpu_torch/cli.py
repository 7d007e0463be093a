"""Command-line interface of the port (counterpart of ``hsa_tpu/cli.py``).

Subcommands: ``index`` (both packages read and write the same index
directory), ``align`` (fused search + resolution -> SAM; ``--engine
auto|pigeon|beam``, default ``auto``: the pigeonhole engine with the beam
as its fallback; ``--ladder 8,64`` makes that beam the adaptive one) and
``align-pe`` (paired ends, with mate rescue; the same engines and default).
Options, the ``--resume`` manifests and the ``--metrics`` JSON are ``hsa-tpu
align``'s and ``align-pe``'s; ``--device`` picks the torch device.
``sampe`` waits for ``aln`` and raises.

Usage:
    python -m hsa_tpu_torch.cli index ref.fa [-p prefix] [-s sa_intv]
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

from . import alphabet
from .config import AlnOpt, PEOpt, SamseOpt
from .io.fastq_fast import FastqBatcher
from .io.fastx import read_fasta, read_fastq, trim_read_length
from .io.sam import sam_header
from .metrics import RunMetrics
from .pipeline import ENGINES, Aligner, ReadBatch, build_index
from .refpack import ensure_refpack

SAMPE_TODO = ("sampe: the two-phase paired flow waits for `aln` (ROADMAP.md "
              "Queue A item 4); use align-pe")


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
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    sink = open(a.out, mode) if a.out else contextlib.nullcontext(sys.stdout)
    with sink as out:
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
    done = _load_manifest(a.out, args_key) if a.resume else 0
    mode = "a" if (a.resume and done) else "w"
    sink = open(a.out, mode) if a.out else contextlib.nullcontext(sys.stdout)
    with sink as out:
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
    raise NotImplementedError(SAMPE_TODO)


COMMANDS = {"index": cmd_index, "align": cmd_align, "align-pe": cmd_align_pe,
            "sampe": cmd_sampe}


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
