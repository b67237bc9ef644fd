"""PyTorch + CUDA port of getdist_tpu.

Two paths so far, each on a torch device (the card unless the caller names
the CPU):

* ``getdist_tpu_torch.ops.batched.triangle_densities``: all 1D and
  all-pairs 2D marginalized densities of a weighted chain, the fused path;
* ``getdist_tpu_torch.mcsamples.MCSamples(...).fastParityDensities(device=True)``:
  reference-exact densities (device parity mode), with the port's own
  jax-free host layer (``chains``, ``mcsamples``, ``kde_bandwidth``, ...).

Plain tensor code is PyTorch; the TPU's Pallas kernels on those paths are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use.
The package never imports JAX or ``getdist_tpu``, which stays the reference.
"""

__version__ = "0.2.0"
