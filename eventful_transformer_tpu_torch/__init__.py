"""eventful_transformer_tpu_torch — the PyTorch/CUDA port of
``eventful_transformer_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's name and path. Plain tensor code is PyTorch. Every Pallas
kernel of the reference's eventful main path is a CUDA C++ kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``). Each kernel wrapper keeps a plain PyTorch
version beside it, which it runs only for tensors that lie on the CPU.

This package imports ``torch`` and ``numpy`` and never ``jax``.
"""

__version__ = "0.1.0"
