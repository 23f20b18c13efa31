"""PyTorch/CUDA port of the ``repro`` package.

Same layout and names as ``repro``; every TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``sm_90a``) under ``csrc/``, built at
first use.  Imports ``torch`` and never ``jax`` or ``repro``.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor
every kernel wrapper runs its plain PyTorch version.
"""
