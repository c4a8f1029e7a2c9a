"""The benchmark of qoc_tpu_torch on one NVIDIA H100 (``run.py``)."""
