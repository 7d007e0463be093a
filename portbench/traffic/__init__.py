"""Traffic mixes: data files read by ``generator.py``."""
