"""hdrtv_tpu_torch — the PyTorch / CUDA port of ``hdrtv_tpu`` for one NVIDIA H100.

The JAX package ``hdrtv_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``runtime/``) so every function has a
counterpart of the same name. Tensors keep the JAX layouts at the public
functions: NHWC activations, HWIO weights and the s2d block-major channel
order. The Pallas kernels of the path this package covers are rewritten by
hand as CUDA C++ for ``sm_90a`` under ``csrc/``; everything the JAX package
leaves to XLA stays plain torch.

Covered: every module of ``hdrtv_tpu`` has its counterpart here
(``runtime/processor.py`` says which program runs a frame), and all 14
Pallas kernels have theirs under ``csrc/``. Importing this package imports
neither ``jax`` nor ``hdrtv_tpu``.
"""

__version__ = "0.1.0"
