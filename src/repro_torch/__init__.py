"""PyTorch + CUDA port of the InCRS SpMM system for NVIDIA Hopper (H100).

A package of its own beside ``repro`` (the JAX reference). It imports
``torch`` and numpy and nothing of ``repro``: the numpy modules it needs
(``core``, ``data``, ``configs``) are its own copies. Entry points take
``device=`` and default to ``"cuda"``; the CUDA kernels live in
``kernels/csrc`` and are built with ``nvcc`` at first use.
"""
