"""PyTorch / CUDA port of the Weaver reproduction (``src/repro``).

Module paths mirror the reference package, so each port module has one
reference module it is held against.  The port imports ``torch`` and
never ``jax`` or anything of ``repro``.  Batched stamp compares run on
``WeaverConfig.device`` ("cuda" by default) through hand-written CUDA
kernels (``csrc/``), or their plain PyTorch versions on the CPU.
"""
