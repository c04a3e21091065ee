"""PyTorch/CUDA port of atomo_tpu for one NVIDIA H100 (Hopper, sm_90a).

Mirrors the module layout of ``atomo_tpu``; the JAX package is the reference
that the tests hold every ported module against. Imports torch, numpy and the
standard library only.
"""
