"""Index sharding over a ``(data, shard)`` mesh of torch.distributed ranks.

Counterpart of ``hsa_tpu/dist/mesh.py`` (BASELINE config 5).  Each process
is one coordinate of the mesh, rank ``d * n_shard + s``:

  ``data``  -- reads are data-parallel: every rank holds the whole host
               batch and searches the lanes of its data slice ``d``;
  ``shard`` -- the occ, reverse-occ, sample and direct-SA tables are split
               by rows over ``shard``: rank ``(d, s)`` keeps row range ``s``
               on its device; ``C`` and the scalars are replicated.

Inside the search every FM primitive gathers its local rows, gates what it
derives from them with the owner mask and merges with one ``all_reduce``
over the shard group (:mod:`hsa_tpu_torch.search.fm`): the per-query form
of the all-gather interval merge.  The entry points return the WHOLE
result on every rank, gathered over ``data`` in slice order.

The backend is the caller's choice: ``nccl`` for one rank per card,
``gloo`` on the CPU or for several ranks sharing one card (its
``all_reduce`` takes CUDA tensors and stages them through host memory).
Every process group has a finite timeout, so a rank that dies fails the
others instead of hanging them.
"""

from __future__ import annotations

import datetime
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..index.layout import (DeviceIndex, TorchIndex, resolve_device,
                            words_to_device)
from ..search import fm as _fm
from ..search import pigeon as pg
from ..search.beam import RawBeamResult, beam_search
from ..search.exact import as_wide, exact_search
from ..search.widths import cal_width_device

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 60.0
_timeout = None          # the world's, set by init_multihost


class Collectives:
    """Counts the shard merges: all-reduces and the bytes each rank
    contributes (the payload of the call), with the device they ran on.

    ``calls`` is one entry per entry-point call, ``(name, all_reduces,
    bytes)``, filled by :meth:`ShardedIndex` entry points; ``devices``
    counts the merges by tensor device type.  Config 5's own measures
    (``benchmarks/config5_multishard.py:36-67`` counts them from the
    jaxpr), read here at run time."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.all_reduces = 0
        self.bytes = 0
        self.devices = Counter()
        self.calls = []

    def record(self, t: torch.Tensor):
        self.all_reduces += 1
        self.bytes += t.numel() * t.element_size()
        self.devices[t.device.type] += 1

    @contextmanager
    def call(self, name: str):
        n0, b0 = self.all_reduces, self.bytes
        yield
        self.calls.append((name, self.all_reduces - n0, self.bytes - b0))


COLLECTIVES = Collectives()


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str, timeout: float = TIMEOUT_S):
    """``init_process_group`` over ``tcp://coordinator`` (``host:port``).

    ``backend`` is required (``gloo`` or ``nccl``); ``timeout`` (seconds)
    bounds every collective of the default group and of the groups that
    :func:`make_mesh` makes from it."""
    global _timeout
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=td)
    _timeout = td


@dataclass
class Mesh:
    """This rank's place in the ``(data, shard)`` mesh and its two groups."""

    n_data: int
    n_shard: int
    data_index: int
    shard_index: int
    data_group: object       # ranks of this rank's shard index, by data
    shard_group: object      # ranks of this rank's data slice, by shard
    backend: str


def make_mesh(n_data: int, n_shard: int) -> Mesh:
    """The ``("data", "shard")`` mesh over the default group's ranks.

    The world, started by :func:`init_multihost`, must have exactly
    ``n_data * n_shard`` ranks; rank ``r`` is ``(r // n_shard, r %
    n_shard)``, the reference's device order.  Every rank creates every
    group, in the same order, with the world's timeout."""
    if _timeout is None:
        raise RuntimeError("make_mesh needs a world started by init_multihost")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_shard:
        raise ValueError(f"mesh ({n_data}, {n_shard}) needs "
                         f"{n_data * n_shard} ranks, the world has {world}")
    d, s = divmod(rank, n_shard)
    shard_groups = [dist.new_group([i * n_shard + j for j in range(n_shard)],
                                   timeout=_timeout) for i in range(n_data)]
    data_groups = [dist.new_group([i * n_shard + j for i in range(n_data)],
                                  timeout=_timeout) for j in range(n_shard)]
    return Mesh(n_data, n_shard, d, s, data_groups[s], shard_groups[d],
                dist.get_backend())


def _local_rows(a: np.ndarray, n_shard: int, s: int):
    """Row range ``s`` of ``a`` split into ``n_shard`` equal parts, the
    last zero-padded (``mesh.py:50-56``) -> (part, rows a part)."""
    rows = -(-a.shape[0] // n_shard)
    part = a[s * rows:(s + 1) * rows]
    if part.shape[0] < rows:
        pad = np.zeros((rows - part.shape[0],) + a.shape[1:], a.dtype)
        part = np.concatenate([part, pad])
    return part, rows


@dataclass
class ShardIndex(TorchIndex):
    """One rank's local tables (``mesh.py:108-124``): the fields of
    :class:`TorchIndex` hold row range ``s``; the FM primitives read the
    shard fields below."""

    shard_group: object = None
    row_offset: int = 0
    rev_row_offset: int = 0
    sample_offset: int = 0
    sa_offset: int = 0
    global_rows: dict = None          # table name -> unpadded global rows
    collectives: Collectives = None


class ShardedIndex:
    """A DeviceIndex's tables split over the mesh's ``shard`` axis, on this
    rank's ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, di: DeviceIndex, mesh: Mesh, device="cuda"):
        self.mesh = mesh
        dev = self.device = resolve_device(device)
        ns, s = mesh.n_shard, mesh.shard_index

        def wide(a):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)

        occ, rows = _local_rows(di.occ_blocks, ns, s)
        samples, n_samples = _local_rows(di.samples, ns, s)
        global_rows = {"occ_blocks": di.occ_blocks.shape[0],
                       "samples": di.samples.shape[0]}
        rev = sad = None
        n_sa = 0
        if di.rev_occ_blocks is not None:
            rev = words_to_device(_local_rows(di.rev_occ_blocks, ns, s)[0],
                                  dev)
            global_rows["rev_occ_blocks"] = di.rev_occ_blocks.shape[0]
        if di.sa_direct is not None:
            part, n_sa = _local_rows(di.sa_direct, ns, s)
            sad = wide(part)
            global_rows["sa_direct"] = di.sa_direct.shape[0]
        self.idx = ShardIndex(
            n=int(di.n), primary=int(di.primary), sa_intv=int(di.sa_intv),
            C=wide(di.C), occ_blocks=words_to_device(occ, dev),
            samples=wide(samples),
            rev_primary=int(di.rev_primary) & 0xFFFFFFFF,
            rev_occ_blocks=rev, sa_direct=sad, device=dev,
            shard_group=mesh.shard_group, row_offset=s * rows,
            rev_row_offset=s * rows, sample_offset=s * n_samples,
            sa_offset=s * n_sa, global_rows=global_rows,
            collectives=COLLECTIVES)

    # -- the data axis ------------------------------------------------------
    def _slice(self, x, axis=0):
        """This rank's data slice of a whole-batch array, on its device."""
        n = x.shape[axis]
        nd = self.mesh.n_data
        if n % nd:
            raise ValueError(f"{n} lanes do not divide the data axis {nd}")
        m = n // nd
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(self.mesh.data_index * m,
                         (self.mesh.data_index + 1) * m)
        return as_wide(x[tuple(sl)], self.device)

    def _gather(self, xs, axis=0):
        """Every data slice's ``xs`` (tensors), concatenated on ``axis`` in
        slice order, on this rank's device.  gloo gathers through host
        memory, nccl on the device."""
        if self.mesh.n_data == 1:
            return list(xs)
        on = self.device if self.mesh.backend == "nccl" else "cpu"
        out = []
        for x in xs:
            dt = x.dtype
            y = x.to(on, torch.uint8 if dt == torch.bool else dt).contiguous()
            parts = [torch.empty_like(y) for _ in range(self.mesh.n_data)]
            dist.all_gather(parts, y, group=self.mesh.data_group)
            out.append(torch.cat(parts, dim=axis).to(self.device, dt))
        return out

    # -- entry points -------------------------------------------------------
    def exact_fn(self):
        """fn(reads_rev [B, L], lens [B]) -> (k, l, matched)."""
        def run(reads_rev, lens):
            with COLLECTIVES.call("exact_fn"):
                out = exact_search(self.idx, self._slice(reads_rev),
                                   self._slice(lens))
                return tuple(self._gather(out))
        return run

    def beam_fn(self, opt, beam_width=None, max_hits=32):
        """fn(reads_fwd, lens, D, max_diff) -> RawBeamResult ([H, B]: reads
        on the last axis, gathered there); finalize on the host."""
        def run(reads_fwd, lens, D, max_diff):
            with COLLECTIVES.call("beam_fn"):
                raw = beam_search(self.idx, self._slice(reads_fwd),
                                  self._slice(lens), self._slice(D),
                                  self._slice(max_diff), opt,
                                  beam_width=beam_width, max_hits=max_hits)
                hits = self._gather(raw[:4], axis=1)
                return RawBeamResult(*hits, *self._gather(raw[4:]))
        return run

    def width_fn(self):
        """fn(reads_fwd, lens) -> D [B, L] (needs the reverse table)."""
        if self.idx.rev_occ_blocks is None:
            raise ValueError("width_fn needs the reverse occ table")

        def run(reads_fwd, lens):
            with COLLECTIVES.call("width_fn"):
                D = cal_width_device(self.idx, self._slice(reads_fwd),
                                     self._slice(lens))
                return self._gather([D])[0]
        return run

    def locate_fn(self):
        """fn(ranks [R]) -> text positions [R] (int64)."""
        def run(ranks):
            with COLLECTIVES.call("locate_fn"):
                return self._gather([_fm.locate(self.idx,
                                                self._slice(ranks))])[0]
        return run

    def pigeon_fn(self, opt, n_seg, text_rows, cand_cap=16, with_kmer=False,
                  seg_cap=32, pool_mult=4):
        """fn(batch dict, md, [tk, tl]) -> PigeonResult (``mesh.py:200-289``).

        ``batch``: :func:`pack_pigeon_batch`'s dict for the whole batch
        (lanes must divide the data axis).  Each rank packs its slice into
        one upload buffer and searches it with pools of ``pool_mult *
        B2_l`` and ``B2_l`` entries; the packed text rows and the K-mer
        table (``tk``, ``tl``) are replicated.  ``g_read`` and ``cidx``
        are made batch-global and ``n_gate`` is one entry a slice, as in
        the reference (``mesh.py:242-248``)."""
        nd, d = self.mesh.n_data, self.mesh.data_index
        trows = (text_rows if isinstance(text_rows, torch.Tensor)
                 else words_to_device(text_rows, self.device))

        def run(batch, md, tk=None, tl=None):
            B2 = batch["lens"].shape[0]
            if B2 % nd:
                raise ValueError(f"lanes {B2} must divide the data axis {nd}")
            B2_l = B2 // nd
            sl = slice(d * B2_l, (d + 1) * B2_l)

            def lane_slice(v):
                # seg-major [n_seg * B2, ...] rows -> the slice's lanes of
                # every segment block; per-lane [B2, ...] arrays slice flat
                if v.shape[0] == n_seg * B2:
                    return (v.reshape((n_seg, B2) + v.shape[1:])[:, sl]
                            .reshape((n_seg * B2_l,) + v.shape[1:]))
                return v[sl]

            with COLLECTIVES.call("pigeon_fn"):
                sub = {k: lane_slice(v) for k, v in batch.items()}
                buf, shape = pg.pack_pigeon_upload(
                    sub, np.asarray(md, np.int32)[sl])
                (segs_rev, seg_lens, seg_off, kmer, kmer_ok, seg_short, rw,
                 nmask, lens, md_l) = pg.unpack_pigeon_upload(
                    words_to_device(buf, self.device), shape)
                seed = None
                if with_kmer:
                    seed = (as_wide(tk, self.device), as_wide(tl, self.device),
                            kmer, kmer_ok, seg_short)
                res = pg.pigeon_search(
                    self.idx, trows, segs_rev, seg_lens, seg_off, rw, nmask,
                    None, None, lens, md_l, opt, n_seg=n_seg,
                    cand_cap=cand_cap, seg_cap=seg_cap,
                    pool=pool_mult * B2_l, gpool=B2_l, kmer_seed=seed)
                off = d * B2_l
                g_read = torch.where(res.g_read < B2_l, res.g_read + off,
                                     nd * B2_l)
                res = res._replace(g_read=g_read,
                                   cidx=res.cidx + off * cand_cap,
                                   n_gate=res.n_gate.reshape(1))
                return pg.PigeonResult(*self._gather(res))
        return run
