"""The benchmark of peclr_tpu_torch on the H100 (see run.py)."""
