"""mLSTM scan op with implementation dispatch
(port of ``repro/kernels/mlstm_scan/ops.py``; see ``ref.py`` for the
layouts).

``impl``:
  * "sequential" — the direct recurrence (``ref.mlstm_sequential``);
  * "reference"  — the chunkwise-parallel form (``ref.mlstm_chunked``);
  * "kernel"     — the hand-written CUDA kernel (``mlstm_scan.py``) for
                   CUDA tensors, its plain version for CPU tensors. It
                   stands for the JAX package's "pallas" and, like it,
                   starts from zero state (prefill and training);
                   decode uses :func:`mlstm_decode_step`. When a
                   gradient is wanted it runs as ``MLSTMScanFn``, the
                   forward kernel with the backward kernel
                   (``csrc/mlstm_scan_bwd.cu``) as its gradient, which
                   takes the final state's cotangent as 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mlstm_scan import ref
from repro_torch.kernels.mlstm_scan.mlstm_scan import (MLSTMScanFn,
                                                       mlstm_scan_cuda)


def mlstm_scan(q, k, v, i_pre, f_pre, *, chunk_size: int = 256,
               initial_state: Optional[ref.State] = None,
               impl: str = "reference") -> Tuple[torch.Tensor, ref.State]:
    """Returns (h (B, S, H, dv), final_state)."""
    if impl == "sequential":
        return ref.mlstm_sequential(q, k, v, i_pre, f_pre,
                                    initial_state=initial_state)
    if impl == "reference":
        return ref.mlstm_chunked(q, k, v, i_pre, f_pre,
                                 chunk_size=chunk_size,
                                 initial_state=initial_state)
    if impl == "kernel":
        if initial_state is not None:
            raise NotImplementedError(
                "the mlstm kernel starts from zero state (prefill); "
                "decode uses mlstm_decode_step")
        args = (q.contiguous(), k.contiguous(), v.contiguous(),
                i_pre.contiguous(), f_pre.contiguous())
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            hout, C, n, m = MLSTMScanFn.apply(*args, chunk_size)
            return hout, (C, n, m)
        return mlstm_scan_cuda(*args, chunk_size=chunk_size)
    raise ValueError(f"unknown mlstm impl '{impl}'")


def mlstm_decode_step(state: ref.State, qt, kt, vt, it, ft):
    return ref.mlstm_decode_step(state, qt, kt, vt, it, ft)
