"""Index tables on a torch device (the counterpart of :mod:`hsa_tpu.index`)."""
