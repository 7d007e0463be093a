"""Single- and paired-end alignment pipeline on a torch device: index to SAM.

Counterpart of ``hsa_tpu/pipeline.py``: the host streams read batches, the
device searches them, the host reads the results back and resolves records.
Single ends route per read (``engine="auto"``): reads that fit the
pigeonhole seed-and-verify engine (:mod:`hsa_tpu_torch.search.pigeon`) take
it, the rest and the engine's fallbacks run on the exhaustive beam
(both-strand width pass and beam search, hits located on the device), and
the two occurrence sources merge into one resolution pass;
``engine="beam"`` forces the beam, ``"pigeon"`` the fast path.  Paired ends
route the same way over both ends as one batch of 2B reads (end 1 then
end 2) and resolve through the paired resolver, whose mate rescue screens
on the device (:mod:`hsa_tpu_torch.resolve.sampe`); their stream pools the
alternate-partition retries and the beam fallbacks across batches.  With
``ladder`` the beam is the adaptive one of
:mod:`hsa_tpu_torch.search.adaptive`.  The index directory format is
``hsa_tpu``'s, the K-mer seed table cache (``kmer{K}.npz``) included; the
host layer (``ReadBatch``, ``build_index``, the resolvers) is the port's own
copy of it, and nothing of ``hsa_tpu`` is imported.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from . import alphabet, metrics, refpack
from .config import AlnOpt, PEOpt, SamseOpt
from .fmcore import FMIndex
from .index.layout import (DeviceIndex, build_device_index, to_device,
                           words_to_device)
from .io.fastx import RefMeta, load_reference
from .oracle.bnb import align_read
from .resolve.sampe import (_rescue_batch, resolve_batch_pe,
                            resolve_pe_from_occ_arrays)
from .resolve.samse import (collect_occurrences, resolve_batch_se,
                            resolve_from_occ_arrays)
from .search import fm
from .search import pigeon as pg
from .search.adaptive import finalize_any
from .search.beam import pack_read_batch, result_to_hits, search_device
from .search.exact import as_wide, kmer_table
from .search.pigeon import occ_lists_to_arrays

ENGINES = ("auto", "pigeon", "beam")

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


def _beam_pad(n: int) -> int:
    """Beam fallback batch padding target.

    Small sets (tests, trickle fallbacks) pad to the next power of two;
    pooled stream flushes (> 64) quantize to powers of FOUR from 512: the
    beam's cost is mostly per run, not per lane, so two or three size
    classes cover a whole stream.
    """
    if n <= 64:
        return 1 << max(n - 1, 0).bit_length()
    tgt = 512
    while tgt < n:
        tgt *= 4
    return tgt


def _occ_merge(occ, socc, fmap):
    """Merge a fallback occ dict (rid local to ``fmap`` order) into a
    batch occ dict and restore canonical (rid, score, strand, pos)
    order."""
    socc = dict(socc)
    socc["rid"] = fmap[socc["rid"]] if socc["rid"].size else socc["rid"]
    occ = {k: np.concatenate([occ[k], socc[k]]) for k in occ}
    order = np.lexsort((occ["pos"], occ["strand"], occ["score"],
                        occ["rid"]))
    return {k: v[order] for k, v in occ.items()}


def _save_kmer_tables(path, tk, tl):
    """Write the K-mer table cache, whole or not at all; a read-only index
    directory is tolerated (the tables are rebuilt by the next process)."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, tk=tk.cpu().numpy().astype(np.uint32),
                 tl=tl.cpu().numpy().astype(np.uint32))
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


_FLUSHES = itertools.count(1)


def _flush_span(batches, retry_reads, beam_reads):
    """The span ``stream.flush`` of one pooled flush: its id (inherited by
    the spans inside it), the first read ordinals of its staged batches and
    the reads they staged for the retry and for the beam (the retry's
    failures join the beam's)."""
    sp = metrics.span("stream.flush")
    if sp:
        sp.set(flush=next(_FLUSHES), batches=batches, retry_reads=retry_reads,
               beam_reads=beam_reads)
    return sp


def _check_engine(engine):
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def _pe_reads(reads1, reads2):
    """Both ends as one batch of 2B reads, end 1 then end 2, in a matrix as
    wide as the longest read."""
    if isinstance(reads1, ReadBatch) and isinstance(reads2, ReadBatch):
        lens = np.concatenate([reads1.lens, reads2.lens])
        W = max(int(lens.max()) if len(lens) else 1, 1)
        mat = np.full((len(lens), W), 5, np.uint8)
        for rb, at in ((reads1, 0), (reads2, len(reads1))):
            w = min(rb.mat.shape[1], W)
            mat[at:at + len(rb), :w] = rb.mat[:, :w]
        return ReadBatch(mat, lens)
    return ReadBatch.from_reads(list(reads1) + list(reads2))


class Aligner:
    """Loads index artifacts onto ``device`` and aligns read batches.

    ``engine``: "auto" routes eligible reads (short reads, modest diff
    budgets) through the pigeonhole seed-and-verify engine with the beam
    as exact fallback; "beam" forces the exhaustive beam; "pigeon" forces
    the pigeon path (ineligible batches raise).  ``ladder``: the widths of
    the adaptive beam (see :mod:`hsa_tpu_torch.search.adaptive`); fallback
    reads go straight to its widest rung.
    """

    def __init__(self, index_dir: str, opt: AlnOpt | None = None,
                 ladder=None, engine: str = "auto", device="cuda"):
        _check_engine(engine)
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
        self._to_device(device)

    @classmethod
    def from_arrays(cls, di, text, meta: RefMeta | None = None,
                    opt: AlnOpt | None = None, ladder=None,
                    engine: str = "auto", device="cuda",
                    index_dir: str | None = None):
        """Construct from in-memory arrays: DeviceIndex + int8 text (+
        optional RefMeta; a single-sequence meta is synthesized when
        omitted).  ``index_dir`` (optional) enables the on-disk K-mer
        table cache."""
        _check_engine(engine)
        refpack.ensure_refpack()
        self = cls.__new__(cls)
        self.index_dir = index_dir
        self.opt = opt or AlnOpt()
        self.ladder = ladder
        self.engine = engine
        self.di = di
        self.meta = meta or RefMeta(
            names=["seq0"], starts=np.zeros(1, np.int64),
            lengths=np.asarray([len(text)], np.int64), total=len(text))
        self.text = np.asarray(text, np.int8)
        self._to_device(device)
        return self

    def _to_device(self, device):
        self.dev = to_device(self.di, device)
        self.device = self.dev.device
        # guards the lazy text-row and K-mer table builds against
        # align_stream's worker threads (a duplicate table build wastes
        # device memory)
        self._lock = threading.RLock()
        self._text_rows = None
        self._ktabs = None
        self.kmer_table_s = None      # (seconds, "built" | "loaded")

    # -- pigeon fast path --------------------------------------------------
    # capacity constants (class attributes: a tuning run or a test sets them
    # on a subclass or an instance; the reference's HSA_* environment
    # variables are not read): candidate slots
    # per read-strand lane, and the max anchor interval width before a
    # segment counts as repetitive (wider -> fewer beam fallbacks on
    # repeat-dense genomes at more verify work per batch).
    # CC=48: moderately repetitive reads carry ~40-70 real candidates
    # after wide-anchor extension; the pool-form readback makes CC
    # readback-free, so enumerate them instead of sampling 16.
    _PIGEON_CAND_CAP = 48
    _PIGEON_SEG_CAP = 32
    _PIGEON_POOL_MULT = 4
    _PIGEON_MIN_SEG = 12
    # repeat profile: when a batch's fallback + truncation fraction
    # exceeds the threshold, later batches run with these caps, wide
    # enough to enumerate typical repeat families (~48-96 copies) so beam
    # fallback drops at a higher device cost per batch; i.i.d.-like inputs
    # never trigger it, so the common path keeps the lean caps.  The
    # switch is sticky (streams are homogeneous).  Lineage analog:
    # bwtgap.c's max_entries work cap, which is likewise a
    # repeat-capacity knob (SURVEY.md §2 inexact core).
    _PIGEON_REPEAT_CAPS = (96, 160, 16)
    _PIGEON_REPEAT_THRESH = 0.10
    _pigeon_profile = "base"          # instance attr once switched
    # the alternate-partition retry pass (seg_phase) absorbs most
    # would-be beam fallbacks: a read whose pass-1 enumeration was
    # capacity-truncated with NO verified candidate re-runs as one lane
    # of a SMALL second pigeon pass over the half-shifted partition at
    # the wide repeat caps (about ten gathers a read) instead of a
    # widest-rung beam lane; only dual failures hit the beam.  A retry
    # pass that is COMPLETE (no truncation) and still empty proves the
    # read unmapped (pigeonhole completeness holds for any partition).
    _PIGEON_RETRY = True
    # retry capacity profile: wider than the repeat profile (the retry
    # batch is a small fraction, so wide caps cost little there)
    _PIGEON_RETRY_CAPS = (96, 160, 16)
    # hysteresis: the sticky repeat-profile upshift DOWNSHIFTS after this
    # many consecutive batches whose fallback+trunc fraction stayed under
    # threshold/2, so a transient repeat region does not tax the rest of
    # a clean stream.
    _PIGEON_DOWNSHIFT_N = 4
    _profile_clean = 0                # consecutive clean batches
    last_fallback_frac = 0.0          # per-batch engine stats
    last_ineligible_frac = 0.0
    last_trunc_frac = 0.0
    last_retry_frac = 0.0             # seg_phase retries / batch

    def _pigeon_caps(self, prof: str):
        """(seg_cap, cand_cap, pool_mult) for a capacity profile."""
        if prof == "repeat":
            return self._PIGEON_REPEAT_CAPS
        if prof == "retry":
            return self._PIGEON_RETRY_CAPS
        return (self._PIGEON_SEG_CAP, self._PIGEON_CAND_CAP,
                self._PIGEON_POOL_MULT)

    @property
    def _kmer_k(self):
        """K-mer seeding depth: 12 for genomes where 12-mers are selective
        (table build cost is amortized); 0 disables (tiny genomes/tests)."""
        return 12 if self.di.n >= (1 << 24) else 0

    def _kmer_tables(self):
        """(tk, tl) int64 on the device: loaded from the index directory's
        ``kmer{K}.npz`` (keys ``tk``, ``tl``, uint32: the file either
        package writes and reads) or built and cached there."""
        with self._lock:
            if self._ktabs is None:
                t0 = time.perf_counter()
                K = self._kmer_k
                path = (os.path.join(self.index_dir, f"kmer{K}.npz")
                        if self.index_dir else None)
                if path and os.path.exists(path):
                    with np.load(path) as z:
                        tabs = (as_wide(z["tk"], self.device),
                                as_wide(z["tl"], self.device))
                    how = "loaded"
                else:
                    tabs = kmer_table(self.dev, K)
                    how = "built"
                    if path:
                        _save_kmer_tables(path, *tabs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.kmer_table_s = (time.perf_counter() - t0, how)
                self._ktabs = tabs
            return self._ktabs

    def warm_pigeon(self):
        """Set-up of the pigeon route ahead of the first batch (the text
        rows and, for K > 0, the K-mer tables, on the device), so that a
        caller can count it as index load; changes no result."""
        if self.engine != "beam" and self.opt.max_gapo <= 1:
            self._text_rows_dev()
            if self._kmer_k > 0:
                self._kmer_tables()

    def _text_rows_dev(self):
        """The packed text rows for window fetches, on the device."""
        with self._lock:
            if self._text_rows is None:
                self._text_rows = words_to_device(
                    pg.pack_text_rows(self.text), self.device)
            return self._text_rows

    def _pigeon_device(self, buf, shape, n_seg, prof="base", seg_phase=False):
        """One fused upload buffer -> device pigeon search at the caps of
        ``prof`` -> PigeonResult of tensors.  vmask/seedmask are derived
        on the device.  Traced as the stage ``search.upload`` and then
        ``pigeon_search``'s stages."""
        metrics.stage("search.upload")
        seg_cap, CC, pool_mult = self._pigeon_caps(prof)
        trows = self._text_rows_dev()
        tabs = self._kmer_tables() if self._kmer_k > 0 else None
        (segs_rev, seg_lens, seg_off, kmer, kmer_ok, seg_short, rw, nmask,
         lens, md) = pg.unpack_pigeon_upload(
            words_to_device(buf, self.device), shape)
        seed = (tabs[0], tabs[1], kmer, kmer_ok, seg_short) if tabs else None
        B2 = shape[2]
        return pg.pigeon_search(self.dev, trows, segs_rev, seg_lens, seg_off,
                                rw, nmask, None, None, lens, md, self.opt,
                                n_seg=n_seg, cand_cap=CC, gpool=B2,
                                pool=pool_mult * B2, seg_cap=seg_cap,
                                kmer_seed=seed, seg_phase=seg_phase)

    def _pigeon_pack(self, reads, n_seg, seg_phase=False):
        """Both strands of ``reads`` -> (fused uint32 upload buffer, shape).

        The batch pack (revcomp lanes, anchors, packed words) runs in the
        native library; ``seg_phase=True`` packs the half-shifted
        alternate partition with numpy (the retry batches that use it are
        small).  Both produce the same layout.
        """
        rb = ReadBatch.from_reads(reads)
        lens = rb.lens
        budg = {int(L): self.opt.diff_budget(int(L))
                for L in np.unique(lens).tolist()}
        md_fwd = np.fromiter((budg[int(L)] for L in lens), np.int32,
                             len(lens))
        K = self._kmer_k
        tail = pg.auto_anchor_tail(int(self.di.n), K)
        if not seg_phase:
            return refpack.pigeon_pack(rb.mat, lens, md_fwd, n_seg, K, tail)
        Rf, lens = rb.padded()
        Lmax = Rf.shape[1]
        # vectorized reverse-complement lanes (comp of 0..3; N/PAD carried)
        t = np.arange(Lmax)[None, :]
        cols = np.clip(lens[:, None] - 1 - t, 0, max(Lmax - 1, 0))
        Rr = np.take_along_axis(Rf, cols, axis=1)
        Rr = np.where(Rr <= 3, 3 - Rr, Rr).astype(np.uint8)
        Rr = np.where(t < lens[:, None], Rr, 5).astype(np.uint8)
        both = (np.vstack([Rf, Rr]), np.concatenate([lens, lens]))
        batch = pg.pack_pigeon_batch(both, n_seg=n_seg,
                                     seed_len=self.opt.seed_len,
                                     kmer_k=K, anchor_tail=tail,
                                     device_masks=True, seg_phase=seg_phase)
        return pg.pack_pigeon_upload(batch, np.concatenate([md_fwd, md_fwd]))

    def _pigeon_raw(self, reads, n_seg, prof="base", seg_phase=False):
        """Pack both strands, run the device pigeon search -> PigeonResult
        of host arrays."""
        with metrics.span("search.pack"):
            buf, shape = self._pigeon_pack(reads, n_seg, seg_phase)
        res = self._pigeon_device(buf, shape, n_seg, prof, seg_phase)
        with metrics.span("search.fetch"):
            return pg.fetch_result(res)

    def pigeon_occurrences(self, reads, n_seg):
        """Pigeon search of reads (both strands):
        (occs[B], fallback[B], missed[B])."""
        res = self._pigeon_raw(reads, n_seg)
        return pg.pigeon_occurrences(res, len(reads), self.opt,
                                     self._PIGEON_CAND_CAP)

    def pigeon_occ_arrays(self, reads, n_seg):
        """Vectorized twin of :meth:`pigeon_occurrences`:
        (occ dict, fb, missed)."""
        res = self._pigeon_raw(reads, n_seg)
        return pg.pigeon_occ_arrays(res, len(reads), self.opt,
                                    self._PIGEON_CAND_CAP)

    def _pigeon_split(self, reads):
        """Per-read router: (n_seg, eligible read indices).

        A read takes the pigeon path iff it fits the engine shape (length
        <= MAX_READ_LEN, segments >= _PIGEON_MIN_SEG for its own diff
        budget); the rest of the batch runs on the beam, so one long read
        does not demote the whole batch.
        """
        if self.engine == "beam" or not len(reads):
            return None, []
        if self.opt.max_gapo > 1:
            if self.engine == "pigeon":
                raise ValueError("pigeon engine requires max_gapo <= 1 "
                                 f"(got {self.opt.max_gapo})")
            return None, []
        lens = (reads.lens.tolist() if isinstance(reads, ReadBatch)
                else [len(r) for r in reads])
        budg = {L: self.opt.diff_budget(L) for L in set(lens)}
        elig = [i for i, L in enumerate(lens)
                if L <= pg.MAX_READ_LEN
                and L // (budg[L] + 1) >= self._PIGEON_MIN_SEG]
        if self.engine == "pigeon" and len(elig) < len(reads):
            raise ValueError("batch contains pigeon-ineligible reads "
                             "(engine='pigeon' forces the fast path)")
        if not elig:
            return None, []
        n_seg = max(budg[lens[i]] for i in elig) + 1
        return n_seg, elig

    @metrics.traced("fallback.retry")
    def _pigeon_retry(self, sub, ridx, n_seg):
        """Alternate-partition (seg_phase) pigeon pass over the capacity-
        fallback subset: reads truncated with no verified candidate.

        Runs at the WIDE retry caps (the subset is small, so wide caps
        cost little) on the half-shifted partition: a read missed by
        pass 1's capped enumeration usually anchors on a narrower
        segment of the shifted partition.  Returns (occ dict with rid
        local to ridx order, fb bool[n], missed int64[n]); pads per
        :func:`_beam_pad`, as the reference does (the padding reads take
        part in the pool's overflow accounting).
        """
        reads = [sub[int(j)] for j in ridx]
        n = len(reads)
        tgt = _beam_pad(n)
        reads = reads + [reads[0]] * (tgt - n)
        cc = self._PIGEON_RETRY_CAPS[1]
        res = self._pigeon_raw(reads, n_seg, prof="retry", seg_phase=True)
        occ, fb, missed = pg.pigeon_occ_arrays(res, tgt, self.opt, cc)
        keep = occ["rid"] < n
        if not keep.all():
            occ = {k: v[keep] for k, v in occ.items()}
        return occ, fb[:n], missed[:n]

    def _retry_merge(self, sub, occ, fb, missed, has_occ, n_seg):
        """Run the seg_phase retry for capacity-fallback reads and merge.

        Mutates nothing; returns updated (occ, fb, missed, has_occ,
        retry_frac).  ``fb`` on entry must be the ENGINE (structural)
        fallback only.
        """
        if not self._PIGEON_RETRY:
            # no retry load when the pass is disabled (the candidates
            # fall straight to the beam and count as fallback)
            return occ, fb, missed, has_occ, 0.0
        retry = (missed > 0) & ~has_occ & ~fb
        rfrac = float(retry.mean()) if len(retry) else 0.0
        if not retry.any():
            return occ, fb, missed, has_occ, rfrac
        ridx = np.nonzero(retry)[0]
        occ2, fb2, missed2 = self._pigeon_retry(sub, ridx, n_seg)
        if occ2["rid"].size:
            occ = _occ_merge(occ, occ2, ridx)
            has_occ = has_occ.copy()
            has_occ[ridx[np.unique(occ2["rid"])]] = True
        # a COMPLETE (untruncated, non-structural) retry enumerated every
        # alignment of the shifted partition: its result set is exact,
        # so clear the truncation; otherwise keep the larger shortfall
        complete2 = (missed2 == 0) & ~fb2
        missed = missed.copy()
        missed[ridx] = np.where(complete2, 0,
                                np.maximum(missed[ridx], missed2))
        fb = fb.copy()
        fb[ridx[fb2]] = True
        return occ, fb, missed, has_occ, rfrac

    def _profile_update(self, load_frac):
        """Sticky repeat-profile upshift + downshift hysteresis.

        ``load_frac``: this batch's fallback + truncation fraction.
        Upshift when it exceeds the threshold; downshift back to the
        lean base caps after ``_PIGEON_DOWNSHIFT_N`` consecutive batches
        under threshold/2 (a transient repeat region should not tax the
        rest of a clean stream with the wider repeat-profile step).
        """
        if self._pigeon_profile == "base":
            if load_frac > self._PIGEON_REPEAT_THRESH:
                self._pigeon_profile = "repeat"
                self._profile_clean = 0
        else:
            if load_frac < self._PIGEON_REPEAT_THRESH / 2:
                self._profile_clean += 1
                if self._profile_clean >= self._PIGEON_DOWNSHIFT_N:
                    self._pigeon_profile = "base"
                    self._profile_clean = 0
            else:
                self._profile_clean = 0

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

    def resolve_handle(self, handle, reads, names=None, quals=None, *,
                       read_offset: int = 0, sopt: SamseOpt | None = None):
        """Phase B of the two-phase flow: a handle of
        :meth:`search_batch_device` -> list of AlnRecord, through the list
        resolver with hits located on the device (``pipeline.py:987-994``)."""
        names = names or [f"read{read_offset + i}" for i in range(len(reads))]
        hf, hr = self.hits_from_device(handle)
        return resolve_batch_se(self.text, self.meta, reads, names, quals,
                                hf, hr, self.locate_fn, self.opt, sopt,
                                read_offset=read_offset)

    def search_batch(self, reads, beam_width=None, max_hits=32, ladder=None):
        """Both-strand beam search: returns (hits_fwd, hits_rc) per read."""
        return self.hits_from_device(self.search_batch_device(
            reads, beam_width=beam_width, max_hits=max_hits, ladder=ladder))

    def locate_fn(self, ranks: np.ndarray) -> np.ndarray:
        """Text positions (uint32) of SA ranks, located on the device."""
        metrics.note(located=len(ranks))
        if len(ranks) == 0:
            return np.zeros(0, np.uint32)
        r = torch.from_numpy(np.asarray(ranks).astype(np.int64)).to(self.device)
        return fm.locate(self.dev, r).cpu().numpy().astype(np.uint32)

    # -- full pipeline -----------------------------------------------------
    def align(self, reads, names=None, quals=None, *, read_offset: int = 0,
              beam_width=None, max_hits=32, sopt: SamseOpt | None = None):
        """reads: ReadBatch or list of int8 code arrays -> list of AlnRecord.

        Per-read engine routing (engine="auto"): pigeon-eligible reads
        take the seed-and-verify fast path; ineligible reads and pigeon
        fallbacks re-run on the beam, and the two hit sources merge into
        one flat occurrence-array resolution pass.
        """
        h = self._align_device(reads, beam_width=beam_width,
                               max_hits=max_hits)
        return self._align_finish(h, names, quals, read_offset=read_offset,
                                  sopt=sopt, beam_width=beam_width,
                                  max_hits=max_hits)

    def _align_device(self, reads, *, beam_width=None, max_hits=32):
        """Phase A: pack + device search (+ result fetch) for one batch."""
        rb = ReadBatch.from_reads(reads)
        n_seg, elig = self._pigeon_split(rb)
        if n_seg is None:
            h = self.search_batch_device(rb, beam_width=beam_width,
                                         max_hits=max_hits)
            return ("beam", rb, h)
        sub = rb
        if len(elig) < len(rb):
            # the packed-word count follows the matrix width: cut the
            # eligible subset's matrix to its own longest read
            sub = rb.subset(elig)
            sub = ReadBatch(sub.mat[:, :max(int(sub.lens.max()), 1)],
                            sub.lens)
        prof = self._pigeon_profile
        res = self._pigeon_raw(sub, n_seg, prof)
        return ("pigeon", rb, elig, sub, res, self._pigeon_caps(prof)[1],
                n_seg)

    @metrics.traced("finish.occ")
    def _align_occ(self, handle, *, beam_width=None, max_hits=32,
                   defer_fb=False, defer_retry=False):
        """Search-phase finalization: handle -> (occ dict, truncated[B],
        c2_extra[B]).

        Everything record resolution needs except reads/names/quals.
        Includes the rare beam re-run of fallback reads; ``occ["rid"]`` is
        batch-local.  Traced as ``finish.occ``.

        ``defer_fb=True`` skips the beam re-run and returns
        (occ, truncated, c2_extra, fb_ids) so a streaming caller can
        pool fallback reads ACROSS batches into one wide beam run: the
        beam's cost is dominated by its fixed per-run cost (a step's
        kernel launches do not depend on the lane count), so grouping is
        cheaper on repeat-dense inputs than per-batch re-runs.
        ``defer_retry=True`` (requires defer_fb) ALSO skips the in-batch
        seg_phase retry and appends a fifth element ``retry_list`` of
        (read_id, missed1): a per-batch retry is a device call that
        queues behind the stream's prefetched searches, so the stream
        pools retries across batches too.
        """
        if handle[0] == "beam":
            _, rb, h = handle
            B = len(rb)
            hf, hr = self.hits_from_device(h)
            occs, tr = collect_occurrences(hf, hr, self.locate_fn)
            self.last_fallback_frac = 0.0
            self.last_ineligible_frac = 1.0
            self.last_trunc_frac = 0.0
            self.last_retry_frac = 0.0
            out = (occ_lists_to_arrays(occs), list(tr),
                   np.zeros(B, np.int64))
            if defer_fb:
                return out + ([], []) if defer_retry else out + ([],)
            return out
        _, rb, elig, sub, res, cc, n_seg = handle
        B = len(rb)
        occ, fb, missed = pg.pigeon_occ_arrays(res, len(sub), self.opt, cc)
        # truncated reads (capped repeat enumeration) keep their verified
        # subset; a truncated read with NO surviving occurrence first
        # retries on the seg_phase alternate partition, and only a dual
        # failure re-runs on the beam
        has_occ = np.zeros(len(sub), bool)
        if occ["rid"].size:
            has_occ[np.unique(occ["rid"])] = True
        emap = np.asarray(elig, np.int64)
        retry_list = []
        if defer_retry and self._PIGEON_RETRY:
            retry_cand = (missed > 0) & ~has_occ & ~fb
            self.last_retry_frac = (float(retry_cand.mean())
                                    if len(retry_cand) else 0.0)
            ridx = np.nonzero(retry_cand)[0]
            retry_list = list(zip(emap[ridx].tolist(),
                                  missed[ridx].tolist()))
            # deferred reads leave the batch as placeholders: no
            # occurrences, no trunc; the flush patches their records
            missed = missed.copy()
            missed[ridx] = 0
        else:
            occ, fb, missed, has_occ, self.last_retry_frac = \
                self._retry_merge(sub, occ, fb, missed, has_occ, n_seg)
        fb = fb | ((missed > 0) & ~has_occ)   # such reads have no entries
        occ["rid"] = emap[occ["rid"]]
        inelig = sorted(set(range(B)) - set(elig))
        fb_ids = sorted([elig[i] for i in np.nonzero(fb)[0]] + inelig)
        self.last_fallback_frac = float(fb.mean()) if len(fb) else 0.0
        self.last_ineligible_frac = len(inelig) / B
        keep_trunc = (missed > 0) & ~fb & has_occ
        self.last_trunc_frac = float(keep_trunc.mean()) if len(fb) else 0.0
        self._profile_update(self.last_fallback_frac + self.last_trunc_frac
                             + self.last_retry_frac)
        c2_extra = np.zeros(B, np.int64)
        c2_extra[emap[np.nonzero(keep_trunc)[0]]] = missed[keep_trunc]
        truncated = np.zeros(B, bool)
        truncated[emap[np.nonzero(keep_trunc)[0]]] = True
        truncated = truncated.tolist()
        if defer_fb:
            self.last_overflow = (np.zeros(B, np.int32), np.zeros(B, np.int32))
            if defer_retry:
                return occ, truncated, c2_extra, fb_ids, retry_list
            return occ, truncated, c2_extra, fb_ids
        ld = np.zeros(B, np.int32)
        hd = np.zeros(B, np.int32)
        if fb_ids:
            sub_occs, sub_trunc, sld, shd = self._beam_rerun(
                [rb[j] for j in fb_ids], beam_width, max_hits)
            occ, truncated = self._merge_fb_batch(
                occ, truncated, ld, hd, fb_ids, sub_occs, sub_trunc,
                sld, shd)
        self.last_overflow = (ld, hd)
        return occ, truncated, c2_extra

    # occurrence budget per fallback read in the beam re-run: fallback
    # reads are high-copy repeats; locating all 512 (the default collect
    # cap) costs more than the beam itself at pooled-flush sizes.  256
    # keeps c1/c2 saturated (MAPQ pins at 0 far earlier) and halves the
    # locate bill; the truncation flag and capped MAPQ apply as for any
    # capacity miss.
    _FB_MAX_OCC = 256

    @metrics.traced("fallback.beam")
    def _beam_rerun(self, bsub, beam_width=None, max_hits=32):
        """Widest-rung beam over a fallback read list (padded per
        :func:`_beam_pad`).

        Fallback reads are here BECAUSE the screen found them hard
        (repeat-dense or structural): the narrow ladder rungs almost
        always escalate, so go straight to the widest rung (without a
        ladder, the plain beam).  Returns (occs, trunc, low_drops,
        high_drops) trimmed to ``len(bsub)``.  Traced as ``fallback.beam``:
        the search (pack, steps, readback) and the locate as its children.
        """
        n = len(bsub)
        bsub = list(bsub) + [bsub[0]] * (_beam_pad(n) - n)
        with metrics.span("fallback.beam.search", reads=n, padded=len(bsub)):
            hf, hr = self.search_batch(bsub, beam_width=beam_width,
                                       max_hits=max_hits,
                                       ladder=self.ladder[-1:] if self.ladder
                                       else None)
        with metrics.span("fallback.beam.locate"):
            sub_occs, sub_trunc = collect_occurrences(hf, hr, self.locate_fn,
                                                      self._FB_MAX_OCC)
        sld, shd = self.last_overflow
        half = len(bsub)
        ld = np.asarray([max(sld[i], sld[half + i] if len(sld) > half else 0)
                         for i in range(n)], np.int32)
        hd = np.asarray([max(shd[i], shd[half + i] if len(shd) > half else 0)
                         for i in range(n)], np.int32)
        return sub_occs[:n], list(sub_trunc[:n]), ld, hd

    @staticmethod
    def _merge_fb_batch(occ, truncated, ld, hd, fb_ids, sub_occs, sub_trunc,
                        sld, shd):
        """Merge a batch's beam-fallback results into its pigeon occ dict
        (occ["rid"] batch-local; sub_* indexed like fb_ids)."""
        for i, j in enumerate(fb_ids):
            truncated[j] = sub_trunc[i]
            ld[j] = sld[i]
            hd[j] = shd[i]
        return _occ_merge(occ, occ_lists_to_arrays(sub_occs),
                          np.asarray(fb_ids, np.int64)), truncated

    def _align_finish(self, handle, names, quals, *, read_offset: int = 0,
                      sopt=None, beam_width=None, max_hits=32,
                      emit: str = "records"):
        """Phase B: finalize + (rare) beam fallback + record resolution.
        ``emit="sam"`` returns (sam_lines, flags) formatted directly."""
        occ, truncated, c2_extra = self._align_occ(
            handle, beam_width=beam_width, max_hits=max_hits)
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

    # fallback pooling: fb_flush bounds the pooled beam size, fb_group
    # bounds reader lag (staged batches).  On clean streams batches never
    # stage, so the knobs cost nothing there.
    _FB_FLUSH = 4096
    _FB_GROUP = 16

    def align_stream(self, batches, *, beam_width=None, max_hits=32,
                     sopt: SamseOpt | None = None, emit: str = "records",
                     fb_flush: int | None = None, fb_group: int | None = None):
        """Pipelined alignment over (start, names, reads, quals) batches.

        Up to ``STREAM_DEPTH`` batches are packed and searched ahead on
        worker threads while the main thread finalizes and resolves the
        oldest one; yields (start, payload) in input order.

        Beam fallbacks are POOLED across batches: a batch with fallback
        reads is staged (pigeon results kept) until ``fb_flush`` pending
        fallback reads or ``fb_group`` staged batches, then ONE wide
        beam run covers them all (the beam's cost is mostly per run, so
        per-batch re-runs on repeat-dense input waste most of it).
        Batches with no fallbacks flush immediately; yields stay in input
        order (a reader lags at most fb_group batches on repeat-dense
        input, zero otherwise).
        """
        fb_flush = self._FB_FLUSH if fb_flush is None else fb_flush
        fb_group = self._FB_GROUP if fb_group is None else fb_group
        # resolve-at-stage, patch-at-flush: a batch with fallback reads is
        # resolved IMMEDIATELY with those reads as unmapped placeholders
        # (they have no occurrences yet), so the expensive per-batch
        # resolution keeps overlapping the next batch's device step; the
        # flush runs ONE pooled seg_phase retry and ONE pooled beam over
        # the group's fallback reads, resolves just those in one patch
        # pass, and splices the records in place.  Record content is
        # identical to per-batch re-runs: the patch pass hashes
        # tie-breaks by GLOBAL read id.
        staged = []  # (start, payload, rb, names, quals, fb_ids,
        #               retry_list, n_seg, stats)

        def search(b):
            with metrics.batch(b[0]):
                return self._align_device(b[2], beam_width=beam_width,
                                          max_hits=max_hits)

        def finish(b, handle):
            ps, pn, _br, pq = b
            with metrics.batch(ps):
                occ, trunc, c2x, fb_ids, retry_list = self._align_occ(
                    handle, beam_width=beam_width, max_hits=max_hits,
                    defer_fb=True, defer_retry=True)
                stats = (self.last_fallback_frac, self.last_ineligible_frac,
                         self.last_trunc_frac, self.last_retry_frac,
                         self.last_overflow)
                payload = self._resolve_occ(handle[1], pn, pq, occ, trunc,
                                            c2x, read_offset=ps, sopt=sopt,
                                            emit=emit)
            n_seg_b = handle[6] if handle[0] == "pigeon" else None
            staged.append((ps, payload, handle[1], pn, pq, fb_ids,
                           retry_list, n_seg_b, stats))

        for _ in _pipelined(batches, search, finish):
            fb_pending = sum(len(e[5]) + len(e[6]) for e in staged)
            if (fb_pending == 0 or fb_pending >= fb_flush
                    or len(staged) >= fb_group):
                yield from self._flush_staged(staged, beam_width, max_hits,
                                              sopt, emit)
        yield from self._flush_staged(staged, beam_width, max_hits, sopt,
                                      emit)

    def _flush_staged(self, staged, beam_width, max_hits, sopt, emit):
        """Pooled retry + pooled beam + one patch resolve over the staged
        batches' fallback reads (traced as ``stream.flush``, where there
        are any); yields every staged (start, payload) in input order
        (``stream.splice``, ``stream.yield``) and empties ``staged``."""
        if not staged:
            return
        patch_items, beam_items, patch, sld, shd = [], [], None, None, None
        if any(ent[5] or ent[6] for ent in staged):
            with _flush_span([e[0] for e in staged],
                             sum(len(e[6]) for e in staged),
                             sum(len(e[5]) for e in staged)):
                patch_items, beam_items, patch, sld, shd = \
                    self._pool_staged_se(staged, beam_width, max_hits, sopt,
                                         emit)
        # ---- 4. splice + yield in input order --------------------------
        slot_of = {sj: o for o, sj in enumerate(patch_items)}
        beam_of = {sj: o for o, sj in enumerate(beam_items)}
        for si, ent in enumerate(staged):
            s, payload, rb, bn, bq, fb_ids, retry_list, _ns, st = ent
            with metrics.span("stream.splice", batch=s):
                # device-search counters (beam-routed batches carry real
                # drops); the pooled re-run overwrites its reads
                ld, hd = (np.asarray(st[4][0], np.int32).copy(),
                          np.asarray(st[4][1], np.int32).copy())
                for j in list(fb_ids) + [j for j, _m in retry_list]:
                    o = slot_of.get((si, j))
                    if o is None:       # proven-unmapped retry read
                        continue
                    if emit == "sam":
                        payload[0][j] = patch[0][o]
                        payload[1][j] = patch[1][o]
                    else:
                        payload[j] = patch[o]
                    bo = beam_of.get((si, j))
                    if bo is not None:
                        ld[j] = sld[bo]
                        hd[j] = shd[bo]
                (self.last_fallback_frac, self.last_ineligible_frac,
                 self.last_trunc_frac, self.last_retry_frac) = st[:4]
                self.last_overflow = (ld, hd)
            with metrics.span("stream.yield", batch=s):
                yield s, payload
        staged.clear()

    def _pool_staged_se(self, staged, beam_width, max_hits, sopt, emit):
        """Steps 1-3 of :meth:`_flush_staged`: (patch_items, beam_items,
        patch records, beam low drops, beam high drops)."""
        # ---- 1. pooled seg_phase retry (grouped by n_seg) --------------
        retry_groups: dict = {}
        for si, ent in enumerate(staged):
            for j, m1 in ent[6]:
                retry_groups.setdefault(ent[7], []).append((si, j, m1))
        patch_items = []     # (si, j) in patch-slot order
        occ_parts = []       # occ dicts, rid already = patch slot
        trunc_p: list = []
        c2x_p: list = []
        beam_items = []      # (si, j) needing the beam
        for n_seg_g, items in retry_groups.items():
            reads_r = [staged[si][2][j] for si, j, _m in items]
            occ2, fb2, missed2 = self._pigeon_retry(
                reads_r, np.arange(len(reads_r)), n_seg_g)
            has2 = np.zeros(len(items), bool)
            if occ2["rid"].size:
                has2[np.unique(occ2["rid"])] = True
            rmap = np.full(len(items), -1, np.int64)
            for i, (si, j, m1) in enumerate(items):
                if fb2[i] or (missed2[i] > 0 and not has2[i]):
                    beam_items.append((si, j))
                elif has2[i]:
                    rmap[i] = len(patch_items)
                    patch_items.append((si, j))
                    mfin = (0 if (missed2[i] == 0 and not fb2[i])
                            else max(m1, int(missed2[i])))
                    trunc_p.append(mfin > 0)
                    c2x_p.append(mfin)
                # else: complete-and-empty, proven unmapped: the
                # stage-time placeholder record is already correct
            if occ2["rid"].size:
                keep = rmap[occ2["rid"]] >= 0
                occ2 = {k: v[keep] for k, v in occ2.items()}
                occ2["rid"] = rmap[occ2["rid"]]
                occ_parts.append(occ2)
        # ---- 2. pooled beam (structural + dual fails) ------------------
        for si, ent in enumerate(staged):
            beam_items.extend((si, j) for j in ent[5])
        sld = shd = None
        if beam_items:
            reads_fb = [staged[si][2][j] for si, j in beam_items]
            sub_occs, sub_trunc, sld, shd = self._beam_rerun(
                reads_fb, beam_width, max_hits)
            base = len(patch_items)
            patch_items.extend(beam_items)
            trunc_p.extend(bool(t) for t in sub_trunc)
            c2x_p.extend(0 for _ in beam_items)
            socc = occ_lists_to_arrays(sub_occs)
            socc["rid"] = socc["rid"] + base
            occ_parts.append(socc)
        # ---- 3. one patch resolve over every pooled read ---------------
        patch = None
        if patch_items:
            occ_all = (occ_parts[0] if len(occ_parts) == 1 else
                       {k: np.concatenate([p[k] for p in occ_parts])
                        for k in occ_parts[0]})
            order = np.lexsort((occ_all["pos"], occ_all["strand"],
                                occ_all["score"], occ_all["rid"]))
            occ_all = {k: v[order] for k, v in occ_all.items()}
            reads_p, names_p, quals_p, gids = [], [], [], []
            for si, j in patch_items:
                s, _pl, rb, bn, bq = staged[si][:5]
                reads_p.append(rb[j])
                names_p.append(bn[j] if bn else f"read{s + j}")
                quals_p.append(bq[j] if bq else "*")
                gids.append(s + j)
            patch = resolve_from_occ_arrays(
                self.text, self.meta, reads_p, names_p, quals_p,
                occ_all, trunc_p, self.opt, sopt, emit=emit,
                c2_extra=np.asarray(c2x_p, np.int64),
                hash_ids=np.asarray(gids, np.int64))
        return patch_items, beam_items, patch, sld, shd

    # -- paired ends ---------------------------------------------------------
    def align_pe(self, reads1, reads2, names=None, quals1=None, quals2=None, *,
                 read_offset: int = 0, beam_width=None, max_hits=32,
                 peopt: PEOpt | None = None, emit: str = "records"):
        """Paired ends -> interleaved [rec1, rec2, ...] records.

        Routes through the pigeon engine when eligible, exactly like
        :meth:`align`; fallback ends re-run on the beam.  ``emit="sam"``
        returns (lines, flags) formatted directly.
        """
        h = self._align_pe_device(reads1, reads2, beam_width=beam_width,
                                  max_hits=max_hits)
        return self._align_pe_finish(h, reads1, reads2, names, quals1, quals2,
                                     read_offset=read_offset,
                                     beam_width=beam_width, max_hits=max_hits,
                                     peopt=peopt, emit=emit)

    def _align_pe_device(self, reads1, reads2, *, beam_width=None,
                         max_hits=32):
        """Phase A of the paired flow: both ends' pigeon search (or, where
        the router finds no eligible read, one both-strand beam search of
        the 2B reads)."""
        return self._pe_search(_pe_reads(reads1, reads2),
                               beam_width=beam_width, max_hits=max_hits)

    def _pe_search(self, all_reads, *, beam_width=None, max_hits=32):
        """:meth:`_align_pe_device` over the 2B reads of :func:`_pe_reads`.
        The handle's layout is the reference's."""
        B = len(all_reads) // 2
        n_seg, elig = self._pigeon_split(all_reads)
        if n_seg is None:
            return ("beam", B, self.search_batch_device(
                all_reads, beam_width=beam_width, max_hits=max_hits))
        psub = list(elig)
        # the packed-word count follows the matrix width: cut the eligible
        # subset's matrix to its own longest read
        sub = all_reads if len(psub) == len(all_reads) else \
            all_reads.subset(psub)
        sub = ReadBatch(sub.mat[:, :max(int(sub.lens.max()), 1)], sub.lens)
        prof = self._pigeon_profile
        res = self._pigeon_raw(sub, n_seg, prof)
        return ("pigeon", B, n_seg, elig, psub, res,
                self._pigeon_caps(prof)[1])

    @metrics.traced("finish.occ")
    def _align_pe_occ(self, handle, all_reads, *, beam_width=None,
                      max_hits=32, defer: bool = False,
                      peopt: PEOpt | None = None):
        """PE search-phase finalization: handle -> (occ dict in [0, 2B)
        read space, trunc[2B], c2x[2B], fb_ids, retry_list).

        With ``defer=False`` the seg_phase retry and the widest-rung
        beam run in-batch and fb_ids/retry_list come back empty; with
        ``defer=True`` both escalations are left to the caller
        (``align_pe_stream`` pools them across batches exactly like the
        single-end stream: a per-batch escalation is a device call
        queued behind the prefetched searches).

        ``last_overflow`` is the batch's: on the beam route the search's
        own counters (both strands of the 2B reads), on the pigeon route
        [2B] counters that are zero except for the ends that the beam
        re-ran (there the larger of the two strands' drops).
        """
        all_reads = ReadBatch.from_reads(all_reads)
        B = len(all_reads) // 2
        if handle[0] == "beam":
            cap = min((peopt or PEOpt()).max_occ, 256)
            hf, hr = self.hits_from_device(handle[2])
            occs_all, trunc_all = collect_occurrences(hf, hr,
                                                      self.locate_fn, cap)
            self.last_fallback_frac = 0.0
            self.last_ineligible_frac = 1.0
            self.last_retry_frac = 0.0
            return (occ_lists_to_arrays(occs_all),
                    np.asarray(trunc_all, bool),
                    np.zeros(2 * B, np.int64), [], [])
        _, _, n_seg, elig, psub, res, pe_cc = handle
        trunc = np.zeros(2 * B, bool)
        c2x = np.zeros(2 * B, np.int64)
        retry_list = []
        occ, fb, missed = pg.pigeon_occ_arrays(res, len(psub), self.opt,
                                               pe_cc)
        has_occ = np.zeros(len(psub), bool)
        if occ["rid"].size:
            has_occ[np.unique(occ["rid"])] = True
        psub_arr = np.asarray(psub, np.int64)
        if defer and self._PIGEON_RETRY:
            retry_cand = (missed > 0) & ~has_occ & ~fb
            self.last_retry_frac = (float(retry_cand.mean())
                                    if len(retry_cand) else 0.0)
            ridx = np.nonzero(retry_cand)[0]
            retry_list = list(zip(psub_arr[ridx].tolist(),
                                  missed[ridx].tolist()))
            missed = missed.copy()
            missed[ridx] = 0
        else:
            sub = (all_reads if len(psub) == len(all_reads)
                   else all_reads.subset(psub))
            occ, fb, missed, has_occ, self.last_retry_frac = \
                self._retry_merge(sub, occ, fb, missed, has_occ, n_seg)
        fb = fb | ((missed > 0) & ~has_occ)
        occ["rid"] = psub_arr[occ["rid"]]
        keep_trunc = (missed > 0) & ~fb & has_occ
        trunc[psub_arr[keep_trunc]] = True
        c2x[psub_arr[keep_trunc]] = missed[keep_trunc]
        fb_set = set(psub_arr[fb].tolist())
        fb_ids = sorted(fb_set | (set(range(2 * B)) - set(elig)))
        self.last_fallback_frac = (float(fb.mean()) if len(fb) else 0.0)
        self.last_ineligible_frac = (2 * B - len(elig)) / (2 * B)
        self._profile_update(self.last_fallback_frac + float(trunc.mean())
                             + self.last_retry_frac)
        ld = np.zeros(2 * B, np.int32)
        hd = np.zeros(2 * B, np.int32)
        self.last_overflow = (ld, hd)
        if defer:
            return occ, trunc, c2x, fb_ids, retry_list
        if fb_ids:
            sub_occs, sub_trunc, sld, shd = self._beam_rerun(
                [all_reads[j] for j in fb_ids], beam_width, max_hits)
            occ = _occ_merge(occ, occ_lists_to_arrays(sub_occs),
                             np.asarray(fb_ids, np.int64))
            trunc[fb_ids] = np.asarray(sub_trunc, bool)
            ld[fb_ids], hd[fb_ids] = sld, shd
            self.last_overflow = (ld, hd)
        return occ, trunc, c2x, [], []

    def _align_pe_finish(self, handle, reads1, reads2, names=None,
                         quals1=None, quals2=None, *, read_offset: int = 0,
                         beam_width=None, max_hits=32,
                         peopt: PEOpt | None = None, emit: str = "records"):
        """Phase B of the paired flow: finalize + fallback + pairing and
        mate rescue (on this aligner's device) -> records."""
        occ, trunc, c2x, _fb, _rt = self._align_pe_occ(
            handle, _pe_reads(reads1, reads2), beam_width=beam_width,
            max_hits=max_hits, peopt=peopt)
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
                        peopt: PEOpt | None = None, emit: str = "records",
                        fb_flush: int | None = None,
                        fb_group: int | None = None):
        """Pipelined paired alignment over
        (start, names, reads1, quals1, reads2, quals2) batches, depth
        ``STREAM_DEPTH`` as in :meth:`align_stream`.  Yields (start, records)
        (or (start, (lines, flags)) with ``emit="sam"``) in input order.

        Escalations POOL across batches: a batch with seg_phase-retry or
        beam-fallback reads is STAGED (unresolved: pairing needs the
        complete per-batch occurrence set, so unlike the single-end
        stream the whole batch resolution waits for the flush); the flush
        runs one pooled retry pass and one pooled widest-rung beam,
        merges each batch's results, and resolves the staged batches.
        Record content is identical to per-batch escalation; only the
        grouping differs.  Clean batches resolve and yield immediately.
        Every batch is resolved right before its own yield, so the
        per-batch attributes (``last_*_frac``, ``last_overflow``,
        ``last_rescue_jobs``) read after a yield are that batch's.  Traced
        as :meth:`align_stream` is; a flush's resolves are per batch, after
        ``stream.flush``.
        """
        fb_flush = self._FB_FLUSH if fb_flush is None else fb_flush
        fb_group = self._FB_GROUP if fb_group is None else fb_group
        # staged: (s, names, r1, q1, r2, q2, all_reads, occ, trunc, c2x,
        #          fb_ids, retry_list, n_seg, stats, overflow)
        staged = []

        def search(b):
            with metrics.batch(b[0]):
                all_reads = _pe_reads(b[2], b[4])
                return all_reads, self._pe_search(
                    all_reads, beam_width=beam_width, max_hits=max_hits)

        def finish(b, found):
            all_reads, handle = found
            with metrics.batch(b[0]):
                occ, trunc, c2x, fb_ids, retry_list = self._align_pe_occ(
                    handle, all_reads, beam_width=beam_width,
                    max_hits=max_hits, defer=True, peopt=peopt)
            stats = (self.last_fallback_frac, self.last_ineligible_frac,
                     self.last_retry_frac)
            n_seg_b = handle[2] if handle[0] == "pigeon" else None
            return tuple(b) + (all_reads, occ, trunc, c2x, fb_ids,
                               retry_list, n_seg_b, stats,
                               self.last_overflow)

        def resolve_one(ent):
            (s, n1, r1, q1, r2, q2, _ar, occ, trunc, c2x, _fb, _rt,
             _ns, st, self.last_overflow) = ent
            (self.last_fallback_frac, self.last_ineligible_frac,
             self.last_retry_frac) = st
            with metrics.batch(s):
                out = self._resolve_pe(r1, r2, n1, q1, q2, occ, trunc, c2x,
                                       read_offset=s, peopt=peopt, emit=emit)
            with metrics.span("stream.yield", batch=s):
                yield s, out

        def flush():
            if staged:
                with _flush_span([e[0] for e in staged],
                                 sum(len(e[11]) for e in staged),
                                 sum(len(e[10]) for e in staged)):
                    self._pool_staged_pe(staged, beam_width, max_hits)
            for ent in staged:
                yield from resolve_one(ent)
            staged.clear()

        for ent in _pipelined(batches, search, finish):
            if not ent[10] and not ent[11]:
                yield from flush()          # keep output in input order
                yield from resolve_one(ent)
                continue
            staged.append(ent)
            fb_pending = sum(len(e[10]) + len(e[11]) for e in staged)
            if fb_pending >= fb_flush or len(staged) >= fb_group:
                yield from flush()
        yield from flush()

    def _pool_staged_pe(self, staged, beam_width, max_hits):
        """One pooled seg_phase retry per ``n_seg`` group and one pooled
        beam over the staged paired batches' escalations; merges each
        batch's parts into its entry (occ replaced, trunc/c2x/overflow
        arrays written in place)."""
        retry_groups: dict = {}
        for si, ent in enumerate(staged):
            for j, m1 in ent[11]:
                retry_groups.setdefault(ent[12], []).append((si, j, m1))
        beam_items = [(si, j) for si, ent in enumerate(staged)
                      for j in ent[10]]
        merged: dict = {}      # si -> list of occ parts, rid batch-local
        for n_seg_g, items in retry_groups.items():
            reads_r = [staged[si][6][j] for si, j, _m in items]
            occ2, fb2, missed2 = self._pigeon_retry(
                reads_r, np.arange(len(reads_r)), n_seg_g)
            has2 = np.zeros(len(items), bool)
            if occ2["rid"].size:
                has2[np.unique(occ2["rid"])] = True
            for i, (si, j, m1) in enumerate(items):
                ent = staged[si]
                if fb2[i] or (missed2[i] > 0 and not has2[i]):
                    beam_items.append((si, j))
                elif has2[i]:
                    mfin = (0 if (missed2[i] == 0 and not fb2[i])
                            else max(m1, int(missed2[i])))
                    ent[8][j] = mfin > 0        # trunc
                    ent[9][j] = mfin            # c2x
            if occ2["rid"].size:
                # scatter retry occurrences back per staged batch
                item_si = np.asarray([si for si, _j, _m in items])
                item_j = np.asarray([j for _si, j, _m in items])
                osi = item_si[occ2["rid"]]
                oj = item_j[occ2["rid"]]
                for si in np.unique(osi):
                    sel = osi == si
                    part = {k: v[sel] for k, v in occ2.items()}
                    part["rid"] = oj[sel]
                    merged.setdefault(int(si), []).append(part)
        if beam_items:
            sub_occs, sub_trunc, sld, shd = self._beam_rerun(
                [staged[si][6][j] for si, j in beam_items],
                beam_width, max_hits)
            for i, (si, j) in enumerate(beam_items):
                socc = occ_lists_to_arrays([sub_occs[i]])
                socc["rid"] = np.full(socc["rid"].size, j, np.int64)
                merged.setdefault(si, []).append(socc)
                ent = staged[si]
                ent[8][j] = bool(sub_trunc[i])
                ent[14][0][j], ent[14][1][j] = sld[i], shd[i]
        for si, parts in merged.items():
            ent = staged[si]
            allp = [ent[7]] + parts
            occ = {k: np.concatenate([p[k] for p in allp]) for k in ent[7]}
            order = np.lexsort((occ["pos"], occ["strand"], occ["score"],
                                occ["rid"]))
            staged[si] = ent[:7] + ({k: v[order] for k, v in occ.items()},) \
                + ent[8:]


def _pipelined(batches, search, finish):
    """Up to ``STREAM_DEPTH`` batches go through ``search`` ahead on worker
    threads while the main thread runs ``finish(batch, handle)`` on the
    oldest; yields its results in input order.  The main thread's waits
    are the spans ``stream.wait_input`` and ``stream.wait_search``."""
    ex = ThreadPoolExecutor(max_workers=STREAM_DEPTH)
    try:
        pending = deque()
        it = iter(batches)
        while True:
            while len(pending) < STREAM_DEPTH:
                with metrics.span("stream.wait_input"):
                    b = next(it, None)
                if b is None:
                    break
                pending.append((b, ex.submit(search, b)))
            if not pending:
                break
            b, fut = pending.popleft()
            with metrics.span("stream.wait_search", batch=b[0]):
                found = fut.result()
            yield finish(b, found)
    finally:
        ex.shutdown(wait=True)


def _oracle_search(text, opt, *read_sets, indexes=None):
    """The oracle's search: ``text``'s forward and reverse FM indexes
    (:class:`~hsa_tpu_torch.fmcore.FMIndex`; ``indexes`` when the caller
    built them), then both strands of every read of each set by
    :func:`~hsa_tpu_torch.oracle.bnb.align_read`.  Returns the
    ``(hits_fwd, hits_rc)`` of each set and a ``locate_fn``."""
    fm_f, fm_r = indexes or (
        FMIndex.build(np.asarray(text, np.int8)),
        FMIndex.build(np.asarray(text, np.int8)[::-1].copy()))

    def side(reads):
        hf, hr = [], []
        for r in reads:
            hf.append(align_read(fm_f, fm_r, np.asarray(r, np.int8), opt))
            hr.append(align_read(fm_f, fm_r,
                                 alphabet.revcomp(np.asarray(r, np.int8)), opt))
        return hf, hr

    def locate_fn(ranks):
        return np.array([fm_f.locate(int(r)) for r in ranks], dtype=np.int64)

    return [side(reads) for reads in read_sets], locate_fn


def oracle_align_pe(text, meta, reads1, reads2, names, quals1, quals2, opt,
                    peopt=None, read_offset=0, device="cuda"):
    """Reference-path paired alignment: oracle search + shared resolution.

    Ground truth for end-to-end PE record parity (SURVEY.md §4.1): the
    branch-and-bound search on the host, then the list resolver, whose mate
    rescue screens on ``device`` (:func:`_rescue_batch`; ``"cpu"`` runs the
    screen's plain version).
    """
    (h1, h2), locate_fn = _oracle_search(text, opt, reads1, reads2)
    return resolve_batch_pe(text, meta, reads1, reads2, names, quals1,
                            quals2, h1, h2, locate_fn, opt, peopt,
                            read_offset=read_offset,
                            rescue=partial(_rescue_batch, device=device))


def oracle_align(text, meta, reads, names, quals, opt, sopt=None, read_offset=0,
                 *, indexes=None):
    """Reference-path alignment: oracle search + the same resolution layer.

    Ground truth for end-to-end record parity (SURVEY.md §4.1); host work
    only.  ``indexes``: the (forward, reverse) FMIndex of ``text``, for a
    genome beyond ``FMIndex.build``'s prefix doubling (built once by the
    caller from the native suffix array); built here when None.
    """
    ((hf, hr),), locate_fn = _oracle_search(text, opt, reads, indexes=indexes)
    return resolve_batch_se(text, meta, reads, names, quals, hf, hr,
                            locate_fn, opt, sopt, read_offset=read_offset)
