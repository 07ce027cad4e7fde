"""The H100 benchmark of `f9tpu_torch` (``python3 bench_h100/run.py``)."""
