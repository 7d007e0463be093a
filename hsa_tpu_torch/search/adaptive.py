"""Beam result finalization (the counterpart of ``hsa_tpu/search/adaptive.py``).

Only the raw-beam branch of ``finalize_any`` (``adaptive.py:175-180``) is
ported: the escalation ladder (``AdaptiveBeam``, ``ladder_core``,
``finalize_ladder``) is still to come, and a ladder result cannot reach
this module yet because :func:`hsa_tpu_torch.search.beam.search_device`
refuses ``ladder``.
"""

from __future__ import annotations

from .beam import LADDER_TODO, BeamResult, RawBeamResult, finalize_result


def finalize_any(res, s_mm: int) -> BeamResult:
    if isinstance(res, RawBeamResult):
        return finalize_result(res, s_mm)
    if isinstance(res, BeamResult):
        return res
    raise NotImplementedError(LADDER_TODO)
