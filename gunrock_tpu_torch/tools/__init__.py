"""Measurement scripts for the port, run as ``python -m
gunrock_tpu_torch.tools.<name>``."""
