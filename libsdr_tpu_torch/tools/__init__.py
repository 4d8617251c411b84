"""Measurement scripts of the port, run on a CUDA card (``python -m
libsdr_tpu_torch.tools.<name>``)."""
