"""Adaptive beam escalation: narrow beams first, escalate flagged reads
(the counterpart of ``hsa_tpu/search/adaptive.py``).

The overflow counters make beam truncation *observable* per read, which
turns beam width into a ladder instead of a global knob: run everything at
a cheap width, then re-run only the reads whose beam or hit buffer
overflowed at the next width.  A read that never overflows has the exact
(oracle-equal) hit set regardless of the width that produced it, so a
ladder's output quality equals running every read at the highest width it
reached.

The whole ladder queues device work and never waits on it: flagged reads
are selected with a fixed-size nonzero (capacity = ``esc_frac`` of the batch
per rung) and re-searched at the next width.  Reads flagged beyond a rung's
capacity keep their current results and stay flagged, so truncation remains
observable.  The escalated sub-batch is padded to the full capacity (its
spare lanes run as zero-length reads), so ``esc_frac`` trades rung cost
against the flagged-read fraction it can absorb.

The device function returns the RAW per-rung results plus the escalation
index maps; merging the [H, B] hit buffers happens on the host at readback
(:func:`finalize_ladder`).  Only the flat [B] overflow flags are carried
from rung to rung on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.select import SENT
from .beam import (M32, BeamResult, RawBeamResult, beam_search,
                   finalize_result)
from .pigeon import _nonzero_sized, _set_at


class LadderRawResult(NamedTuple):
    raws: tuple            # per-rung RawBeamResult (rung 0 = full batch)
    esc_idx: tuple         # per-escalation int64[ESC] read ids (fill = B)
    esc_valid: tuple       # per-escalation bool[ESC]


def ladder_core(dev, fwd, lens, D, md, opt, ladder, H: int, ESC: int,
                B: int) -> LadderRawResult:
    """The ladder body, on ``dev.device``; all arguments after ``dev`` are
    tensors there.

    ``ESC`` = escalation sub-batch capacity; ``B`` = batch size (used as
    the out-of-range nonzero fill).
    """
    raw = beam_search(dev, fwd, lens, D, md, opt,
                      beam_width=ladder[0], max_hits=H)
    raws = [raw]
    esc_idx, esc_valid = [], []
    # flat [B] flag state, updated by flat scatters
    ldrop = raw.n_live_dropped
    hdrop = raw.n_hits_dropped
    for W in ladder[1:]:
        flag = (ldrop > 0) | (hdrop > 0)
        n_flag = flag.sum()
        # the fill is an OUT-OF-RANGE index: gathers clamp it (harmless,
        # masked by `valid`) and the flag scatter drops those rows
        idx = _nonzero_sized(flag, ESC, B)
        valid = torch.arange(ESC, device=idx.device) < n_flag
        g = idx.clamp(max=B - 1)
        sub = beam_search(
            dev, fwd[g], torch.where(valid, lens[g], 0),
            D[g], md[g], opt, beam_width=W, max_hits=H)
        raws.append(sub)
        esc_idx.append(idx)
        esc_valid.append(valid)
        ldrop = _set_at(ldrop, idx,
                        torch.where(valid, sub.n_live_dropped, ldrop[g]))
        hdrop = _set_at(hdrop, idx,
                        torch.where(valid, sub.n_hits_dropped, hdrop[g]))
    return LadderRawResult(tuple(raws), tuple(esc_idx), tuple(esc_valid))


class AdaptiveBeam:
    """The ladder of one index, option set and width sequence; a call runs
    it over one packed batch (numpy arrays or tensors)."""

    def __init__(self, dev_idx, opt, *, ladder=(8, 64), max_hits: int = 16,
                 esc_frac: float = 1 / 8):
        self.dev = dev_idx
        self.opt = opt
        self.ladder = tuple(ladder)
        self.max_hits = max_hits
        self.esc_frac = esc_frac

    def __call__(self, fwd, lens, D, md) -> LadderRawResult:
        fwd, lens, D, md = (torch.as_tensor(x, device=self.dev.device).long()
                            for x in (fwd, lens, D, md))
        B = fwd.shape[0]
        ESC = max(int(B * self.esc_frac), 1)
        return ladder_core(self.dev, fwd, lens, D, md, self.opt, self.ladder,
                           self.max_hits, ESC, B)


def primary_ranks(res, n) -> torch.Tensor:
    """Device-side [B] ranks (int64 holding 32-bit values) of each read's
    first hit-buffer slot (rank 0 when the slot is invalid), for
    benchmark-style primary locates."""

    def one(raw):
        v = raw.hkey[0] < SENT
        return torch.where(v, raw.hit_k[0].long() & M32, 0)

    if isinstance(res, RawBeamResult):
        return one(res)
    ranks = one(res.raws[0])
    B = ranks.shape[0]
    for raw, idx, valid in zip(res.raws[1:], res.esc_idx, res.esc_valid):
        ranks = _set_at(ranks, idx, torch.where(
            valid, one(raw), ranks[idx.clamp(max=B - 1)]))
    return ranks


def finalize_ladder(res: LadderRawResult, s_mm: int) -> BeamResult:
    """Host merge (READS BACK): per-rung finalize + numpy scatter merge."""
    out = finalize_result(res.raws[0], s_mm)
    fields = [np.array(f) for f in out]
    for raw, idx, valid in zip(res.raws[1:], res.esc_idx, res.esc_valid):
        sub = finalize_result(raw, s_mm)
        idx = idx.cpu().numpy()
        valid = valid.cpu().numpy()
        sel = idx[valid]
        subsel = np.nonzero(valid)[0]
        for f, s in zip(fields, sub):
            f[sel] = np.asarray(s)[subsel]
    return BeamResult(*fields)


def finalize_any(res, s_mm: int) -> BeamResult:
    if isinstance(res, LadderRawResult):
        return finalize_ladder(res, s_mm)
    if isinstance(res, RawBeamResult):
        return finalize_result(res, s_mm)
    return res
