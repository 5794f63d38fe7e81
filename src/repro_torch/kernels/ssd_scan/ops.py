"""Mamba2 SSD scan op with implementation dispatch
(port of ``repro/kernels/ssd_scan/ops.py``; see ``ref.py`` for the
layouts).

``impl``:
  * "sequential" — the direct recurrence (``ref.ssd_sequential``);
  * "reference"  — the chunked SSD algorithm (``ref.ssd_chunked``);
  * "kernel"     — the hand-written CUDA kernels (``ssd_scan.py``) for
                   CUDA tensors, their plain versions for CPU tensors. It
                   stands for the JAX package's "pallas" and, like it,
                   starts from zero state (prefill and training); decode
                   uses :func:`ssd_decode_step`. When a gradient is
                   wanted it runs as ``SSDScanFn``, the forward kernel
                   with the backward kernel (``csrc/ssd_scan_bwd.cu``) as
                   its gradient, which takes the final state's cotangent
                   as 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import SSDScanFn, ssd_scan_cuda


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, D: Optional[torch.Tensor] = None,
    *,
    chunk_size: int = 256,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, final_state)."""
    if impl == "sequential":
        return ref.ssd_sequential(x, dt, A, Bm, Cm, D,
                                  initial_state=initial_state)
    if impl == "reference":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk_size=chunk_size,
                               initial_state=initial_state)
    if impl == "kernel":
        if initial_state is not None:
            raise NotImplementedError(
                "the ssd kernel starts from zero state (prefill); decode "
                "uses ssd_decode_step")
        args = (x.contiguous(), dt.contiguous(), A.contiguous(),
                Bm.contiguous(), Cm.contiguous(),
                D.contiguous() if D is not None else None)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in args):
            return SSDScanFn.apply(*args, chunk_size)
        return ssd_scan_cuda(*args, chunk_size=chunk_size)
    raise ValueError(f"unknown ssd impl '{impl}'")


def ssd_decode_step(state, x, dt, A, Bm, Cm, D=None):
    return ref.ssd_decode_step(state, x, dt, A, Bm, Cm, D)
