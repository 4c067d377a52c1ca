"""The benchmark of orc_tpu_torch (see run.py and PERF.md)."""
