"""Command-line interface of the port (counterpart of ``hsa_tpu/cli.py``).

Subcommands: ``index`` (the shared ``build_index``: both packages read the
same index directory), ``align`` (fused search + resolution -> SAM) and
``align-pe`` (paired ends, with mate rescue), beam engine only.  Options,
the ``--resume`` manifests and the ``--metrics`` JSON are ``hsa-tpu
align``'s and ``align-pe``'s; ``--device`` picks the torch device.
``sampe`` waits for ``aln`` and raises.

Usage:
    python -m hsa_tpu_torch.cli index ref.fa [-p prefix] [-s sa_intv]
    python -m hsa_tpu_torch.cli align prefix reads.fq [-f out.sam]
        [--device cuda] [--metrics m.json] [--resume] [search opts]
    python -m hsa_tpu_torch.cli align-pe prefix r1.fq r2.fq [-f out.sam]
        [-a max_isize] [--device cuda] [--metrics m.json] [--resume]
        [search opts]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from hsa_tpu.cli import (_add_search_opts, _load_manifest, _opt_from_args,
                         _prefetch, _save_manifest, _stream_batches,
                         _zip_lockstep)
from hsa_tpu.config import PEOpt, SamseOpt

SAMPE_TODO = ("sampe: the two-phase paired flow waits for `aln` (ROADMAP.md "
              "Queue A items 3 and 4); use align-pe")


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="hsa-tpu-torch index")
    p.add_argument("fasta")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-s", "--sa-intv", type=int, default=32)
    a = p.parse_args(argv)
    from hsa_tpu.pipeline import build_index
    from .refpack import ensure_refpack
    # The numpy fallback builder is O(n log^2 n): at genome scale only the
    # native library (built with make/g++ at first use) is usable.
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
    p.add_argument("--engine", default="beam", choices=("beam",),
                   help="search engine (only the beam is ported so far)")
    p.add_argument("--device", default="cuda",
                   help="torch device to search on (default cuda)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    from hsa_tpu.io.sam import sam_header
    from hsa_tpu.metrics import RunMetrics
    from .pipeline import Aligner
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="align", reads=a.reads, batch=a.batch,
                      beam_width=a.beam_width, engine=a.engine,
                      device=a.device, opt=opt.to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine,
                     device=a.device)
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
    p.add_argument("--engine", default="beam",
                   choices=("auto", "pigeon", "beam"),
                   help="search engine (only the beam is ported so far)")
    p.add_argument("--device", default="cuda",
                   help="torch device to search and rescue on (default cuda)")
    _add_search_opts(p)
    a = p.parse_args(argv)
    from hsa_tpu.io.sam import sam_header
    from hsa_tpu.metrics import RunMetrics
    from .pipeline import Aligner
    met = RunMetrics()
    opt = _opt_from_args(a)
    met.config = dict(cmd="align-pe", reads1=a.reads1, reads2=a.reads2,
                      batch=a.batch, beam_width=a.beam_width, engine=a.engine,
                      device=a.device, opt=opt.to_dict())
    ladder = tuple(int(x) for x in a.ladder.split(",")) if a.ladder else None
    with met.timer("index_load"):
        al = Aligner(a.prefix, opt, ladder=ladder, engine=a.engine,
                     device=a.device)
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
