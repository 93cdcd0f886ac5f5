"""HECTR on PyTorch: the port of ``hectr_tpu`` to PyTorch and CUDA.

The JAX package ``hectr_tpu`` is the reference; each module here is the
counterpart of the module at the same path there, and the tests hold
the two against each other.  This package imports torch and numpy and
never jax.  Every Pallas kernel of the JAX package has a hand-written
CUDA kernel for Hopper here (``hectr_tpu_torch.ops``): the NTT pair, on
every CKKS path, and the modular-multiply ceiling probe
(``hectr_tpu_torch.bench.vpu_ceiling``).  CUDA tensors go to the
kernels, CPU tensors to their plain PyTorch versions.  A ciphertext's
coefficient axis can be sharded over a mesh, on one device or over
``torch.distributed`` ranks (``hectr_tpu_torch.parallel``).
"""

__version__ = "0.1.0"
