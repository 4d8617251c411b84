"""The benchmark of the PyTorch and CUDA port (``libsdr_tpu_torch``): see
``run.py`` and ``BENCHMARK.json``."""
