"""Part of the benchmark of nbodysim_tpu_torch (see benchmark/run.py)."""
