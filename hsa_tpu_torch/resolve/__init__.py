"""Paired-end resolution with the port's mate rescue (the counterpart of
:mod:`hsa_tpu.resolve`)."""
