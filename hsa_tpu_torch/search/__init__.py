"""Device search engines (the counterpart of :mod:`hsa_tpu.search`)."""
