"""Single-end alignment pipeline on a torch device: index to SAM.

Counterpart of ``hsa_tpu/pipeline.py``'s beam route: the host streams read
batches, the device runs the both-strand width pass and beam search, the
host reads the hits back, locates them on the device and resolves records.
The index directory format and the host layer (``ReadBatch``,
``collect_occurrences``, ``resolve_from_occ_arrays``) are
``hsa_tpu``'s own, imported as they are.

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

from hsa_tpu import alphabet, refpack
from hsa_tpu.config import AlnOpt, SamseOpt
from hsa_tpu.index.layout import DeviceIndex
from hsa_tpu.io.fastx import RefMeta
from hsa_tpu.pipeline import ReadBatch
from hsa_tpu.resolve.samse import collect_occurrences, resolve_from_occ_arrays

from .index.layout import to_device
from .search import fm
from .search.adaptive import finalize_any
from .search.beam import (LADDER_TODO, pack_read_batch, result_to_hits,
                          search_device)
from .search.pigeon import occ_lists_to_arrays

ENGINE_TODO = ("engine={!r}: the pigeonhole engine and auto routing are not "
               "ported yet (ROADMAP.md Queue A item 1); use engine='beam'")

# batches in flight on worker threads ahead of the one being resolved
STREAM_DEPTH = 2


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
        ex = ThreadPoolExecutor(max_workers=STREAM_DEPTH)
        try:
            pending = deque()
            it = iter(batches)
            exhausted = False
            while True:
                while not exhausted and len(pending) < STREAM_DEPTH:
                    nxt = next(it, None)
                    if nxt is None:
                        exhausted = True
                        break
                    s, bn, br, bq = nxt
                    pending.append((s, bn, bq, ex.submit(
                        self._align_device, br, beam_width=beam_width,
                        max_hits=max_hits)))
                if not pending:
                    break
                ps, pn, pq, pfut = pending.popleft()
                handle = pfut.result()
                occ, trunc, c2x = self._align_occ(handle)
                yield ps, self._resolve_occ(handle[1], pn, pq, occ, trunc,
                                            c2x, read_offset=ps, sopt=sopt,
                                            emit=emit)
        finally:
            ex.shutdown(wait=True)
