"""PyTorch + CUDA port of getdist_tpu.

Its paths, each on a torch device (the card unless the caller names the
CPU):

* ``getdist_tpu_torch.ops.batched.triangle_densities``: all 1D and
  all-pairs 2D marginalized densities of a weighted chain, the fused path
  (hard limits, periodic parameters, mean-likelihood grids);
* ``getdist_tpu_torch.mcsamples.MCSamples(...).fastTriangleDensities()``:
  the public fused entry with its host rescues, on one device or sharded
  over a ``torch.distributed`` process group (``mesh=``);
* ``MCSamples(...).fastParityDensities(device=True / False)``:
  reference-exact densities (device parity mode, and the host variant for
  any weights), with the port's own jax-free host layer (``chains``,
  ``mcsamples``, ``kde_bandwidth``, ...);
* ``getdist_tpu_torch.parallel``: the sharded sample reductions and the
  fused program over a process group.

Plain tensor code is PyTorch; the TPU's Pallas kernels on those paths are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use,
and the host variant's pair histograms a C++ pass (``_native/``), built
with ``g++`` at first use. The package never imports JAX or
``getdist_tpu``, which stays the reference.
"""

__version__ = "0.2.0"
