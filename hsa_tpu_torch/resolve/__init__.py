"""Hit resolution and output layer (counterpart of :mod:`hsa_tpu.resolve`):
per-read hit lists or occurrence arrays -> SAM records, single and paired
ends, with the paired mate rescue screened on a torch device."""

from .samse import resolve_batch_se, AlnRecord  # noqa: F401
