"""How a CUDA kernel is held against its plain PyTorch version on the card.

The measure is the relative L2 error ``||got - want|| / ||want||`` of
each output, with no floor on ``||want||``: gradients, dlogits and losses
are far from O(1), and a limit taken relative to max(1, max |want|)
turns into an absolute one that a wrong kernel passes. A kernel's error
is the largest over its outputs.

``RTOL`` holds the limits, per kernel and dtype, used by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``. Each is about 10x the largest error
``chip_smoke.py`` read on an H100 (PERF.md lists the readings): in fp32
(TF32 off) the kernel and its plain version differ only in summation
order; in bf16 both take the same bf16 inputs and round their outputs
to bf16, so most of what is left is a 1-ulp rounding of some outputs.
"""
from __future__ import annotations

import torch

RTOL = {            # largest reading, chip_smoke.py or the cuda tests
    ("flash_attention_cuda", torch.float32): 5e-6,         # 5.5e-7
    ("flash_attention_cuda", torch.bfloat16): 5e-4,        # 4.5e-5
    ("flash_attention_bwd_cuda", torch.float32): 2e-5,     # 1.7e-6
    ("flash_attention_bwd_cuda", torch.bfloat16): 1e-3,    # 9.9e-5
    ("cross_entropy_cuda", torch.float32): 1e-6,           # 9.8e-8
    ("cross_entropy_cuda", torch.bfloat16): 2e-6,          # 2.1e-7
    ("ce_dlogits_cuda", torch.float32): 5e-7,              # 5.2e-8
    ("ce_dlogits_cuda", torch.bfloat16): 1e-6,             # 8.1e-8
}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``||got - want|| / ||want||`` in fp64; the absolute norm of the
    difference where ``want`` is all zeros."""
    g, w = got.double(), want.double()
    den = torch.linalg.vector_norm(w).item()
    num = torch.linalg.vector_norm(g - w).item()
    return num / den if den > 0 else num
