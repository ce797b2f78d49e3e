"""Squeeze on PyTorch and CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100.

The block-level Squeeze main path -- NBB fractals, the lambda/nu maps, the
block layout, the stencil workloads, the engines, the batched runner and
the hand-written Hopper kernels v3, v4 and v5 -- with the reference's
layout: ``core/``, ``workloads/``, ``kernels/``, ``tuning/``, the
service and its runtime (``serving/``, ``checkpoint/``, ``runtime/``,
``obs/``), and the language-model serving path (``configs/``,
``models/``, ``launch/``). It imports torch and numpy, never jax or the
reference package.
"""
