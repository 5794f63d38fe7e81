"""PyTorch/CUDA port of HetSeq's serving path and single-device training
step, for NVIDIA Hopper.

Mirrors the module layout of the JAX package ``repro`` so each module
has a named counterpart there, but imports neither ``jax`` nor
``repro``: what it needs of the JAX package's jax-free modules is
copied here. Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``; the attention and cross-entropy kernels under
``csrc/`` are hand-written CUDA C++ for ``sm_90a`` and their plain
PyTorch versions run only for CPU tensors.
"""
