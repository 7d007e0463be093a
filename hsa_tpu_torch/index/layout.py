"""The fused rank-indexed index tables as torch tensors on one device.

Counterpart of ``hsa_tpu/index/layout.py``: the numpy container
(:class:`hsa_tpu.index.layout.DeviceIndex`, its v4 row layout and its
``index.npz`` format) is shared as it is; :func:`to_device` takes the place
of ``DeviceIndex.as_jax``.

Types: torch has no unsigned 32-bit arithmetic, so ranks, positions and the
``C`` array are ``int64``.  The fused occ rows stay 32-bit words, stored as
``int32`` bit patterns (half the gather bytes of ``int64``); the FM
primitives widen each gathered row to ``int64`` and mask it to its 32-bit
pattern before any shift or comparison (:func:`hsa_tpu_torch.search.fm._gather_rows`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but no CUDA "
                               "device is available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@dataclass
class TorchIndex:
    """Index tables on one device (the ``as_jax`` namespace's fields)."""

    n: int                   # text length
    primary: int             # rank of the sentinel row
    sa_intv: int
    C: torch.Tensor          # int64[5]
    occ_blocks: torch.Tensor  # int32[nb, 8] fused rows (32-bit patterns)
    samples: torch.Tensor    # int64[n_marked]
    rev_primary: int
    rev_occ_blocks: torch.Tensor | None  # int32[nb, 8] or None
    sa_direct: torch.Tensor | None       # int64[n + 1] or None
    device: torch.device


def _words(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint32 rows -> int32 bit-pattern tensor on ``dev``."""
    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(dev)


def _wide(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)


def to_device(di, device) -> TorchIndex:
    """``DeviceIndex`` (numpy) -> :class:`TorchIndex` on ``device``.

    Mirrors ``DeviceIndex.as_jax`` (``hsa_tpu/index/layout.py:76-90``),
    including ``rev_primary`` taken modulo 2^32 (-1 when absent).
    """
    dev = resolve_device(device)
    return TorchIndex(
        n=int(di.n), primary=int(di.primary), sa_intv=int(di.sa_intv),
        C=_wide(di.C, dev),
        occ_blocks=_words(di.occ_blocks, dev),
        samples=_wide(di.samples, dev),
        rev_primary=int(di.rev_primary) & 0xFFFFFFFF,
        rev_occ_blocks=(_words(di.rev_occ_blocks, dev)
                        if di.rev_occ_blocks is not None else None),
        sa_direct=(_wide(di.sa_direct, dev)
                   if di.sa_direct is not None else None),
        device=dev)
