"""Measurement tools of the port, run as ``python -m
microimagelib_tpu_torch.tools.<name>``."""
