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
The SSD scan's error is the larger of y's and the final state's; the
mLSTM scan's the largest over h, C, n and m; the SSD backward's the
largest over its six gradients (dA, a sum over every row of a head, is
the largest in fp32; dB and dC, rounded to bf16, in bf16). Kernel 1b at
head dim 80 (zamba2's shared block) has its own limits beside the
backward's at 64, 128 and 192, from its own readings. The mLSTM
backward's error is the largest over its five gradients (dq, rounded to
bf16, in bf16); at large gates (i~ up to +-30, f~ down to -10, chunk
256) b reaches ~1e3 over a chunk, denominators cancel, and every fp32
evaluation of the function, the reference's own autograd included,
reads ~1e-3 to ~3e-2 against its fp64 self (the plain version on five
draws); so the kernel and its plain version, two such evaluations, are
held to a limit of their own there (``chip_smoke.py`` prints both
against the fp64 reference).
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
    ("ssd_scan_cuda", torch.float32): 4e-5,                # 3.5e-6
    ("ssd_scan_cuda", torch.bfloat16): 4e-4,               # 5.1e-5
    ("mlstm_scan_cuda", torch.float32): 2e-5,              # 1.4e-6
    ("mlstm_scan_cuda", torch.bfloat16): 6e-4,             # 7.0e-5
    ("ssd_scan_bwd_cuda", torch.float32): 8e-5,            # 7.7e-6
    ("ssd_scan_bwd_cuda", torch.bfloat16): 8e-4,           # 7.9e-5
    ("flash_attention_bwd_d80", torch.float32): 6e-6,      # 5.6e-7
    ("flash_attention_bwd_d80", torch.bfloat16): 1.5e-3,   # 1.3e-4
    ("mlstm_scan_bwd_cuda", torch.float32): 5e-5,          # 4.6e-6
    ("mlstm_scan_bwd_cuda", torch.bfloat16): 2e-3,         # 2.1e-4
    ("mlstm_scan_bwd_large_gates", torch.float32): 0.15,   # 3.5e-3
    ("mlstm_scan_bwd_large_gates", torch.bfloat16): 0.15,  # 1.4e-2
}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``||got - want|| / ||want||`` in fp64; the absolute norm of the
    difference where ``want`` is all zeros."""
    g, w = got.double(), want.double()
    den = torch.linalg.vector_norm(w).item()
    num = torch.linalg.vector_norm(g - w).item()
    return num / den if den > 0 else num
