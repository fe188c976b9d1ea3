"""PyTorch/CUDA port of the DISLAND distance index.

Mirrors the layout of the JAX package ``repro`` module for module and
imports nothing of it: numpy-only modules are kept here as copies, and
the two Pallas kernels of the main path are CUDA C++ under ``csrc/``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
