"""wsss_tpu_torch — the PyTorch/CUDA port of wsss_tpu for NVIDIA Hopper.

A second package beside the JAX reference: plain tensor code is PyTorch,
and the bilateral-grid kernels that the JAX package wrote in Pallas for
the TPU are CUDA C++ kernels for sm_90a (``kernels/csrc``), built with
nvcc at first use and bound with ctypes.  Public entry points take
``device=`` and default to ``'cuda'``; the CPU runs only when asked for.
This package imports neither jax nor anything of ``wsss_tpu``.
"""

__version__ = '0.1.0'
