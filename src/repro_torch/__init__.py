"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the module paths of the JAX package so each counterpart is
easy to find.  It imports torch, numpy and the standard library only —
never ``jax`` and nothing of ``repro`` (tests/test_torch_package.py
enforces that); host-side modules it needs are kept here as copies.
"""
