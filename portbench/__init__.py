"""The benchmark of hsa_tpu_torch (see ``run.py``)."""
