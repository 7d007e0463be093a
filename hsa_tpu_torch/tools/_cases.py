"""One launch of a probe's kernel at the probe's own inputs: what a TPU
probe handed to one ``pallas_call``, and which of the card's three gather
kernels takes its place.  The probe modules print them; ``chip_smoke.py``
holds each against its plain version and times it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..index.layout import words_to_device
from ..kernels import gather


@dataclass(frozen=True)
class Case:
    label: str            # the TPU probe's printed label for this launch
    replaces: str         # file:line of the pallas_call
    kernel: str           # "gather_rows", "table_take" or "onehot_gather"
    make: Callable        # () -> (tab uint32 [NB, W], q int32 [NQ]), numpy
    pipe: int = 8         # gather_rows only
    chunk: int | None = None

    def tensors(self, dev):
        """The inputs: (tab, q) in numpy, then as int32 tensors on ``dev``."""
        tab, q = self.make()
        return tab, q, words_to_device(tab, dev), torch.from_numpy(q).to(dev)

    def run(self, tab, q, plain=False):
        """The kernel (or its plain version) on int32 tensors."""
        if self.kernel == "gather_rows":
            return (gather.rows_plain(tab, q) if plain else
                    gather.gather_rows(tab, q, self.pipe, self.chunk))
        if self.kernel == "table_take":
            return (gather.rows_plain(tab, q) if plain else
                    gather.table_take(tab, q))
        return (gather.onehot_gather_plain(q, tab) if plain else
                gather.onehot_gather(q, tab))

    def expected(self, tab: np.ndarray, q: np.ndarray) -> np.ndarray:
        """The probe's own check on the host: ``tab[q]`` (for the one-hot
        product, rounded through float32 as its body does)."""
        if self.kernel == "onehot_gather":
            return onehot_expected(tab, q)
        return tab.astype(np.uint32)[np.clip(q, 0, tab.shape[0] - 1)]


def onehot_expected(tab: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``tab[clamp(q)]`` rounded through float32 and back, saturating at
    2^32 - 1 (numpy's own cast of a float32 of 2^32 to uint32 is
    undefined)."""
    f = tab.astype(np.uint32)[np.clip(q, 0, tab.shape[0] - 1)].astype(
        np.float32).astype(np.float64)
    return np.minimum(f, 2.0 ** 32 - 1).astype(np.uint32)


def random_table(nb: int, w: int) -> np.ndarray:
    """The probes' table: ``RandomState(1)`` words in [0, 2^30)."""
    return np.random.RandomState(1).randint(0, 1 << 30, (nb, w)).astype(
        np.uint32)


def random_queries(nb: int, nq: int) -> np.ndarray:
    """The probes' queries: ``RandomState(2)`` rows in [0, nb)."""
    return np.random.RandomState(2).randint(0, nb, nq).astype(np.int32)
