"""HECTR on PyTorch: the port of ``hectr_tpu`` to PyTorch and CUDA.

The JAX package ``hectr_tpu`` is the reference; each module here is the
counterpart of the module at the same path there, and the tests hold
the two against each other.  This package imports torch and numpy and
never jax.  The NTT, on every CKKS path, runs as hand-written CUDA
kernels for Hopper (``hectr_tpu_torch.ops.ntt_cuda``) on CUDA tensors
and as plain PyTorch on CPU tensors.
"""

__version__ = "0.1.0"
