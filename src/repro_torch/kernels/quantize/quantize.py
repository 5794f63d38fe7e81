"""Hand-written CUDA kernels of the int8 gradient exchange.

  * :func:`quantize_int8_cuda` — per-block absmax int8 quantization of a
    (rows, 256) fp32 stack (``csrc/quantize.cu::quantize_int8_fwd``),
    replacing the JAX package's ``quantize_int8_pallas``: the send side
    of the bucketed exchange and the re-quantize of the shard sum.
  * :func:`dequant_accum_cuda` — the fused dequantize and sum over
    ranks (``csrc/quantize.cu::dequant_accum_fwd``), replacing
    ``dequant_accum_pallas``: the receive side.

Both are bitwise equal to their plain versions in ``ref.py``
(``quantize_blocks``, ``dequant_accum``). Unlike the attention and
cross-entropy wrappers they take only CUDA tensors and raise for any
other: ``ops.py`` chooses the plain version for CPU tensors. Each counts
its launches in ``.launches``. A failed build or launch raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.flash_attention import _raise_on

BLOCK = 256          # the block size the kernels are built for
MAX_RANKS = 64       # ranks dequant_accum_cuda takes (a runtime loop)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors, got {t.device} (the "
                         f"plain version is kernels/quantize/ref.py)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def quantize_int8_cuda(x: torch.Tensor,
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, 256) fp32 [, noise (rows, 256) fp32 in [0, 1)] ->
    (q (rows, 256) int8, s (rows,) fp32)."""
    name = "quantize_int8_cuda"
    if x.dim() != 2 or x.shape[1] != BLOCK:
        raise ValueError(f"{name}: x must be (rows, {BLOCK}), got "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    _check(name, x, torch.float32, (rows, BLOCK))
    if noise is not None:
        _check(name, noise, torch.float32, (rows, BLOCK))
        if noise.device != x.device:
            raise ValueError(f"{name}: noise on {noise.device}, x on "
                             f"{x.device}")
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_int8_fwd(
            x.data_ptr(), noise.data_ptr() if noise is not None else None,
            q.data_ptr(), s.data_ptr(), rows, stream)
    _raise_on(name, err)
    quantize_int8_cuda.launches += 1
    return q, s


quantize_int8_cuda.launches = 0


def dequant_accum_cuda(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q (R, rows, 256) int8, s (R, rows) fp32 -> (rows, 256) fp32
    ``sum_r q[r] * s[r]``, ranks added in order."""
    name = "dequant_accum_cuda"
    if q.dim() != 3 or q.shape[2] != BLOCK:
        raise ValueError(f"{name}: q must be (R, rows, {BLOCK}), got "
                         f"{tuple(q.shape)}")
    ranks, rows, _ = q.shape
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"{name}: {ranks} ranks, takes 1..{MAX_RANKS}")
    _check(name, q, torch.int8, (ranks, rows, BLOCK))
    _check(name, s, torch.float32, (ranks, rows))
    if s.device != q.device:
        raise ValueError(f"{name}: s on {s.device}, q on {q.device}")
    out = torch.empty((rows, BLOCK), dtype=torch.float32, device=q.device)
    if rows == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequant_accum_fwd(q.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), ranks, rows, stream)
    _raise_on(name, err)
    dequant_accum_cuda.launches += 1
    return out


dequant_accum_cuda.launches = 0
