"""PyTorch + CUDA port of :mod:`repro` for NVIDIA Hopper.

Mirrors the reference package's module paths; the aggregation kernels
are hand-written CUDA under ``kernels/csrc``.  Imports ``torch`` and
numpy only, never ``jax`` or :mod:`repro`.
"""
