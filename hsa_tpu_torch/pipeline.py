"""Single- and paired-end alignment pipeline on a torch device: index to SAM.

Counterpart of ``hsa_tpu/pipeline.py``'s beam route: the host streams read
batches, the device runs the both-strand width pass and beam search, the
host reads the hits back, locates them on the device and resolves records.
Paired ends search both ends as one batch and resolve through the paired
resolver, whose mate rescue screens on the device
(:mod:`hsa_tpu_torch.resolve.sampe`).  The index directory format is
``hsa_tpu``'s; the host layer (``ReadBatch``, ``build_index``, the
resolvers) is the port's own copy of it, and nothing of ``hsa_tpu`` is
imported.

Only ``engine="beam"`` with a single beam width is ported.  The pigeonhole
engine (``"auto"``/``"pigeon"``) and the beam ladder raise
:class:`NotImplementedError` rather than silently running something else.
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import alphabet, refpack
from .config import AlnOpt, PEOpt, SamseOpt
from .index.layout import DeviceIndex, build_device_index, to_device
from .io.fastx import RefMeta, load_reference
from .resolve.sampe import _rescue_batch, resolve_pe_from_occ_arrays
from .resolve.samse import collect_occurrences, resolve_from_occ_arrays
from .search import fm
from .search.adaptive import finalize_any
from .search.beam import (LADDER_TODO, pack_read_batch, result_to_hits,
                          search_device)
from .search.pigeon import occ_lists_to_arrays

ENGINE_TODO = ("engine={!r}: the pigeonhole engine and auto routing are not "
               "ported yet (ROADMAP.md Queue A item 1); use engine='beam'")

# batches in flight on worker threads ahead of the one being resolved
STREAM_DEPTH = 2


class ReadBatch:
    """Matrix-backed read batch: codes uint8 [B, Lmax] + lens int32 [B].

    Replaces list-of-arrays batches on the hot path so packing and
    resolution work matrix-to-matrix (no 65K-iteration Python copy
    loops).  Indexing returns the j-th read's code view, so every
    list-based consumer keeps working.
    """

    __slots__ = ("mat", "lens")

    def __init__(self, mat, lens):
        self.mat = np.asarray(mat, np.uint8)
        self.lens = np.asarray(lens, np.int32)

    @classmethod
    def from_reads(cls, reads):
        if isinstance(reads, ReadBatch):
            return reads
        B = len(reads)
        Lmax = max((len(r) for r in reads), default=1)
        mat = np.full((B, max(Lmax, 1)), 5, np.uint8)
        lens = np.zeros(B, np.int32)
        for j, r in enumerate(reads):
            mat[j, :len(r)] = np.asarray(r, np.uint8)
            lens[j] = len(r)
        return cls(mat, lens)

    def __len__(self):
        return self.mat.shape[0]

    def __getitem__(self, j):
        return self.mat[j, :self.lens[j]].astype(np.int8)

    def __iter__(self):
        return (self[j] for j in range(len(self)))

    def subset(self, idx):
        idx = np.asarray(idx, np.int64)
        return ReadBatch(self.mat[idx], self.lens[idx])

    def padded(self, Lmax=None):
        """(mat, lens) with columns >= lens set to PAD(5)."""
        m = self.mat
        if Lmax is not None and m.shape[1] < Lmax:
            m = np.pad(m, ((0, 0), (0, Lmax - m.shape[1])),
                       constant_values=5)
        t = np.arange(m.shape[1])[None, :]
        return np.where(t < self.lens[:, None], m, 5).astype(np.uint8), \
            self.lens


def build_index(fasta_path: str, prefix: str, sa_intv: int = 32) -> str:
    """``index``: FASTA -> artifact dir (the directory ``hsa-tpu index``
    writes, byte for byte).  Returns the dir path."""
    text, meta = load_reference(fasta_path)
    di = build_device_index(text, sa_intv=sa_intv, with_reverse=True)
    outdir = prefix + ".hsa"
    os.makedirs(outdir, exist_ok=True)
    di.save(os.path.join(outdir, "index.npz"))
    with open(os.path.join(outdir, "meta.json"), "w") as fh:
        json.dump(dict(ref=meta.to_dict(), sa_intv=sa_intv, version=1), fh)
    packed = refpack.pack_2bit(text.astype(np.uint8))
    with open(os.path.join(outdir, "text.pac"), "wb") as fh:
        fh.write(np.int64(len(text)).tobytes())
        fh.write(packed.tobytes())
    return outdir


def _check_route(engine, ladder):
    if engine in ("auto", "pigeon"):
        raise NotImplementedError(ENGINE_TODO.format(engine))
    if engine != "beam":
        raise ValueError(f"unknown engine {engine!r}")
    if ladder:
        raise NotImplementedError(LADDER_TODO)


class Aligner:
    """Loads index artifacts onto ``device`` and aligns read batches
    through the beam engine."""

    def __init__(self, index_dir: str, opt: AlnOpt | None = None,
                 ladder=None, engine: str = "beam", device="cuda"):
        _check_route(engine, ladder)
        refpack.ensure_refpack()
        if not os.path.isdir(index_dir) and os.path.isdir(index_dir + ".hsa"):
            index_dir = index_dir + ".hsa"
        self.index_dir = index_dir
        self.opt = opt or AlnOpt()
        self.ladder = ladder
        self.engine = engine
        self.di = DeviceIndex.load(os.path.join(index_dir, "index.npz"))
        with open(os.path.join(index_dir, "meta.json")) as fh:
            m = json.load(fh)
        self.meta = RefMeta.from_dict(m["ref"])
        with open(os.path.join(index_dir, "text.pac"), "rb") as fh:
            n = np.frombuffer(fh.read(8), np.int64)[0]
            packed = np.frombuffer(fh.read(), np.uint8)
        self.text = refpack.unpack_2bit(packed, int(n)).astype(np.int8)
        self.dev = to_device(self.di, device)
        self.device = self.dev.device

    @classmethod
    def from_arrays(cls, di, text, meta: RefMeta | None = None,
                    opt: AlnOpt | None = None, ladder=None,
                    engine: str = "beam", device="cuda"):
        """Construct from in-memory arrays: DeviceIndex + int8 text (+
        optional RefMeta; a single-sequence meta is synthesized when
        omitted)."""
        _check_route(engine, ladder)
        refpack.ensure_refpack()
        self = cls.__new__(cls)
        self.index_dir = None
        self.opt = opt or AlnOpt()
        self.ladder = ladder
        self.engine = engine
        self.di = di
        self.meta = meta or RefMeta(
            names=["seq0"], starts=np.zeros(1, np.int64),
            lengths=np.asarray([len(text)], np.int64), total=len(text))
        self.text = np.asarray(text, np.int8)
        self.dev = to_device(di, device)
        self.device = self.dev.device
        return self

    # -- search ------------------------------------------------------------
    def search_batch_device(self, reads, beam_width=None, max_hits=32,
                            ladder=None):
        """Phase A: both-strand beam search, results left on the device.

        Returns an opaque handle for :meth:`hits_from_device`.
        """
        rc = [alphabet.revcomp(r) for r in reads]
        fwd, lens = pack_read_batch(list(reads) + rc)
        res = search_device(self.dev, fwd, lens, self.opt,
                            beam_width=beam_width, max_hits=max_hits,
                            ladder=ladder or self.ladder)
        return (res, len(reads))

    def hits_from_device(self, handle):
        """Phase B: read a search handle back -> (hits_fwd, hits_rc)."""
        raw, B = handle
        res = finalize_any(raw, self.opt.s_mm)
        hits_all = result_to_hits(res)
        self.last_overflow = (np.asarray(res.n_live_dropped),
                              np.asarray(res.n_hits_dropped))
        return hits_all[:B], hits_all[B:]

    def search_batch(self, reads, beam_width=None, max_hits=32, ladder=None):
        """Both-strand beam search: returns (hits_fwd, hits_rc) per read."""
        return self.hits_from_device(self.search_batch_device(
            reads, beam_width=beam_width, max_hits=max_hits, ladder=ladder))

    def locate_fn(self, ranks: np.ndarray) -> np.ndarray:
        """Text positions (uint32) of SA ranks, located on the device."""
        if len(ranks) == 0:
            return np.zeros(0, np.uint32)
        r = torch.from_numpy(np.asarray(ranks).astype(np.int64)).to(self.device)
        return fm.locate(self.dev, r).cpu().numpy().astype(np.uint32)

    # -- full pipeline -----------------------------------------------------
    def align(self, reads, names=None, quals=None, *, read_offset: int = 0,
              beam_width=None, max_hits=32, sopt: SamseOpt | None = None):
        """reads: ReadBatch or list of int8 code arrays -> list of AlnRecord."""
        h = self._align_device(reads, beam_width=beam_width,
                               max_hits=max_hits)
        return self._align_finish(h, names, quals, read_offset=read_offset,
                                  sopt=sopt)

    def _align_device(self, reads, *, beam_width=None, max_hits=32):
        """Phase A: pack + device search for one batch."""
        rb = ReadBatch.from_reads(reads)
        h = self.search_batch_device(rb, beam_width=beam_width,
                                     max_hits=max_hits)
        return ("beam", rb, h)

    def _align_occ(self, handle):
        """Search-phase finalization: handle -> (occ dict, truncated[B],
        c2_extra[B]); ``occ["rid"]`` is batch-local."""
        _, rb, h = handle
        B = len(rb)
        hf, hr = self.hits_from_device(h)
        occs, tr = collect_occurrences(hf, hr, self.locate_fn)
        return occ_lists_to_arrays(occs), list(tr), np.zeros(B, np.int64)

    def _align_finish(self, handle, names, quals, *, read_offset: int = 0,
                      sopt=None, emit: str = "records"):
        """Phase B: finalize + record resolution.  ``emit="sam"`` returns
        (sam_lines, flags) formatted directly."""
        occ, truncated, c2_extra = self._align_occ(handle)
        return self._resolve_occ(handle[1], names, quals, occ, truncated,
                                 c2_extra, read_offset=read_offset,
                                 sopt=sopt, emit=emit)

    def _resolve_occ(self, rb, names, quals, occ, truncated, c2_extra, *,
                     read_offset: int = 0, sopt=None, emit: str = "records"):
        B = len(rb)
        names = names or [f"read{read_offset + i}" for i in range(B)]
        return resolve_from_occ_arrays(self.text, self.meta, rb, names,
                                       quals, occ, truncated, self.opt,
                                       sopt, read_offset=read_offset,
                                       emit=emit, c2_extra=c2_extra)

    def align_stream(self, batches, *, beam_width=None, max_hits=32,
                     sopt: SamseOpt | None = None, emit: str = "records"):
        """Pipelined alignment over (start, names, reads, quals) batches.

        Up to ``STREAM_DEPTH`` batches are packed and searched ahead on
        worker threads while the main thread reads back, locates and
        resolves the oldest one; yields (start, payload) in input order.
        On the beam route no read falls back or retries, so each batch is
        yielded as soon as it is resolved: the JAX stream's fallback
        pooling has nothing to pool here.
        """
        def search(b):
            return self._align_device(b[2], beam_width=beam_width,
                                      max_hits=max_hits)

        def finish(b, handle):
            return b[0], self._align_finish(handle, b[1], b[3],
                                            read_offset=b[0], sopt=sopt,
                                            emit=emit)
        return _pipelined(batches, search, finish)

    # -- paired ends ---------------------------------------------------------
    def align_pe(self, reads1, reads2, names=None, quals1=None, quals2=None, *,
                 read_offset: int = 0, beam_width=None, max_hits=32,
                 peopt: PEOpt | None = None, emit: str = "records"):
        """Paired ends -> interleaved [rec1, rec2, ...] records, or
        (lines, flags) with ``emit="sam"``; ``hsa_tpu``'s ``align_pe`` on
        the beam route."""
        h = self._align_pe_device(reads1, reads2, beam_width=beam_width,
                                  max_hits=max_hits)
        return self._align_pe_finish(h, reads1, reads2, names, quals1, quals2,
                                     read_offset=read_offset, peopt=peopt,
                                     emit=emit)

    def _align_pe_device(self, reads1, reads2, *, beam_width=None,
                         max_hits=32):
        """Phase A of the paired flow: both ends, end 1 then end 2, in one
        both-strand beam search of 2B reads."""
        return ("beam", len(reads1), self.search_batch_device(
            list(reads1) + list(reads2), beam_width=beam_width,
            max_hits=max_hits))

    def _align_pe_occ(self, handle, peopt: PEOpt | None = None):
        """Handle -> (occ dict in the [0, 2B) read space, trunc[2B],
        c2x[2B]), the beam branch of ``hsa_tpu``'s ``_align_pe_occ``."""
        B = handle[1]
        cap = min((peopt or PEOpt()).max_occ, 256)
        hf, hr = self.hits_from_device(handle[2])
        occs, trunc = collect_occurrences(hf, hr, self.locate_fn, cap)
        return (occ_lists_to_arrays(occs), np.asarray(trunc, bool),
                np.zeros(2 * B, np.int64))

    def _align_pe_finish(self, handle, reads1, reads2, names=None,
                         quals1=None, quals2=None, *, read_offset: int = 0,
                         peopt: PEOpt | None = None, emit: str = "records"):
        """Phase B of the paired flow: readback, locate, pairing and mate
        rescue (on this aligner's device), records."""
        occ, trunc, c2x = self._align_pe_occ(handle, peopt)
        return self._resolve_pe(reads1, reads2, names, quals1, quals2, occ,
                                trunc, c2x, read_offset=read_offset,
                                peopt=peopt, emit=emit)

    def _resolve_pe(self, reads1, reads2, names, quals1, quals2, occ, trunc,
                    c2x, *, read_offset: int = 0, peopt: PEOpt | None = None,
                    emit: str = "records"):
        """``resolve_pe_from_occ_arrays`` with the mate rescue on this
        aligner's device (:meth:`_rescue`)."""
        names = names or [f"pair{read_offset + i}" for i in range(len(reads1))]
        self.last_rescue_jobs = 0
        return resolve_pe_from_occ_arrays(
            self.text, self.meta, reads1, reads2, names, quals1, quals2, occ,
            self.opt, peopt, read_offset=read_offset, trunc=trunc, c2x=c2x,
            emit=emit, rescue=self._rescue)

    def _rescue(self, text, meta, jobs, rlim, opt):
        """The resolver's ``_rescue_batch`` on this device; notes the
        batch's job count in ``last_rescue_jobs``."""
        self.last_rescue_jobs = len(jobs)
        return _rescue_batch(text, meta, jobs, rlim, opt, self.device)

    def align_pe_stream(self, batches, *, beam_width=None, max_hits=32,
                        peopt: PEOpt | None = None, emit: str = "records"):
        """Pipelined paired alignment over (start, names, reads1, quals1,
        reads2, quals2) batches, depth ``STREAM_DEPTH`` as in
        :meth:`align_stream`; yields (start, payload) in input order.  On
        the beam route nothing falls back, so nothing is staged: each batch
        is yielded once it is resolved."""
        def search(b):
            return self._align_pe_device(b[2], b[4], beam_width=beam_width,
                                         max_hits=max_hits)

        def finish(b, handle):
            s, n1, r1, q1, r2, q2 = b
            return s, self._align_pe_finish(handle, r1, r2, n1, q1, q2,
                                            read_offset=s, peopt=peopt,
                                            emit=emit)
        return _pipelined(batches, search, finish)


def _pipelined(batches, search, finish):
    """Up to ``STREAM_DEPTH`` batches go through ``search`` ahead on worker
    threads while the main thread runs ``finish(batch, handle)`` on the
    oldest; yields its results in input order."""
    ex = ThreadPoolExecutor(max_workers=STREAM_DEPTH)
    try:
        pending = deque()
        it = iter(batches)
        while True:
            while len(pending) < STREAM_DEPTH:
                b = next(it, None)
                if b is None:
                    break
                pending.append((b, ex.submit(search, b)))
            if not pending:
                break
            b, fut = pending.popleft()
            yield finish(b, fut.result())
    finally:
        ex.shutdown(wait=True)
