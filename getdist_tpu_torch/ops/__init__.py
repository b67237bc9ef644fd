"""Tensor operations of the port; module names mirror ``getdist_tpu/ops``."""
