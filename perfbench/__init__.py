"""The benchmark of the PyTorch and CUDA port (``getdist_tpu_torch``); see ``run.py``."""
