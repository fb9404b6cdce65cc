"""PyTorch/CUDA port of the DualPath serving system.

A second package beside ``repro`` (the JAX reference).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
nothing of ``repro`` — and mirrors the reference's module names, so each
module here has a counterpart of the same path under ``src/repro/``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; the CPU path exists for the tests, where every kernel
wrapper computes its plain PyTorch version.
"""
