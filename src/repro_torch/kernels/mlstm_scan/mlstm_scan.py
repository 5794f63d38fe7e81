"""Hand-written CUDA mLSTM chunked scan and its plain PyTorch version.

:func:`mlstm_scan_cuda` — the xLSTM mLSTM chunkwise-parallel scan from
zero state (``csrc/mlstm_scan.cu``), replacing the JAX package's
``mlstm_scan_pallas``: returns ``h`` in q's dtype and the final (C, n,
m) in fp32. It runs its plain version (:func:`mlstm_scan_plain`,
``ref.mlstm_chunked``) when, and only when, its tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises. It counts its
launches in ``.launches``, a plain integer that a caller may reset. The
kernel launches on PyTorch's current stream and does not synchronise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mlstm_scan import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WIDTH_MULT = 64        # dk and dv must be multiples of this
MAX_DK = 512           # the (dk, 64) fp32 state slice lives in shared memory
MAX_CHUNK = 256        # largest chunk Q (one gate row per thread)


def mlstm_scan_plain(q, k, v, i_pre, f_pre, *, chunk_size: int = 256):
    """Plain version of the kernel: ``ref.mlstm_chunked`` from zero
    state."""
    return ref.mlstm_chunked(q, k, v, i_pre, f_pre, chunk_size=chunk_size)


def mlstm_scan_cuda(
    q: torch.Tensor,                     # (B, S, H, dk) fp32 or bf16
    k: torch.Tensor,                     # (B, S, H, dk) q's dtype
    v: torch.Tensor,                     # (B, S, H, dv) q's dtype
    i_pre: torch.Tensor,                 # (B, S, H) fp32
    f_pre: torch.Tensor,                 # (B, S, H) fp32
    *,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, ref.State]:
    """The mLSTM scan from zero state with chunks of ``min(chunk_size,
    S)`` rows; returns (h (B, S, H, dv) in q's dtype, (C (B, H, dk, dv),
    n (B, H, dk), m (B, H)) in fp32). The kernel takes dk and dv that
    are multiples of 64, dk <= 512 and a chunk of at most 256 rows."""
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i_pre, f_pre, chunk_size=chunk_size)
    name = "mlstm_scan_cuda"
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in (q, k, v, i_pre, f_pre):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k/v dtypes must be q's ({q.dtype})")
    if i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32:
        raise TypeError(f"{name}: i_pre and f_pre must be float32")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape != (b, s, h, dv)
            or i_pre.shape != (b, s, h) or f_pre.shape != (b, s, h)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} i {tuple(i_pre.shape)} f "
            f"{tuple(f_pre.shape)} disagree")
    chunk = min(int(chunk_size), s)
    if (dk % WIDTH_MULT or dv % WIDTH_MULT or not 0 < dk <= MAX_DK
            or dv <= 0 or (s > 0 and not 0 < chunk <= MAX_CHUNK)):
        raise ValueError(
            f"{name}: needs dk % {WIDTH_MULT} == 0, dv % {WIDTH_MULT} == 0, "
            f"dk <= {MAX_DK} and a chunk of 1..{MAX_CHUNK} rows, got "
            f"dk={dk} dv={dv} chunk={chunk}")
    out = torch.empty_like(v)
    C = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or s == 0:
        return out, (C.zero_(), n.zero_(), m.fill_(ref.NEG_BIG))
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mlstm_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), out.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), b, s, h, dk, dv, chunk, dk ** -0.5,
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    mlstm_scan_cuda.launches += 1
    return out, (C, n, m)


mlstm_scan_cuda.launches = 0
