"""Probes of the FM row gather on the card: the counterparts of the TPU
probes under the repository's ``tools/`` (``gather_probe.py``,
``gather_probe2.py``, ``gather_probe3.py``, ``sync_probe.py``,
``occ_probe5.py``), with their test names, shapes, seeds and printed labels.

Each runs as ``python -m hsa_tpu_torch.tools.<name> [--device cuda|cpu]
[test ...]``; the device defaults to ``cuda`` and raises without a card.
The Pallas kernels of the TPU probes are the three kernels of
``hsa_tpu_torch.kernels.gather``; the probes' library calls are the same
calls in torch.
"""
