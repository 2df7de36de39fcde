"""PyTorch/CUDA port of the R-Storm reproduction.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.  Module
paths mirror the reference (``repro_torch/core/search/objective.py`` is the
counterpart of ``repro/core/search/objective.py``).  Hand-written CUDA
sources live in ``csrc/`` and are built at first use by :mod:`.build`.
"""
