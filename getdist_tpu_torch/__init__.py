"""PyTorch + CUDA port of getdist_tpu's fused triangle-densities path.

``getdist_tpu_torch.ops.batched.triangle_densities`` computes all 1D and
all-pairs 2D marginalized densities of a weighted chain on a torch device.
Plain tensor code is PyTorch; the TPU's Pallas kernels on that path are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use.
The package never imports JAX: ``getdist_tpu`` stays the reference.
"""

__version__ = "0.1.0"
