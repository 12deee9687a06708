"""The benchmark of ceracoder_tpu_torch (see benchmark/run.py)."""
