"""csl_gan_tpu_torch — the PyTorch / CUDA port of csl_gan_tpu for one NVIDIA
H100.

The JAX package ``csl_gan_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Each TPU kernel of a ported path has a hand-written
CUDA counterpart under ``ops/csrc`` with a plain PyTorch version beside it:
CPU tensors take the plain version, CUDA tensors launch the kernel or raise.
"""
