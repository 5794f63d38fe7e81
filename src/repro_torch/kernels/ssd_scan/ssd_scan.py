"""Hand-written CUDA SSD scan and its plain PyTorch version.

:func:`ssd_scan_cuda` — the Mamba2 SSD chunked scan from zero state
(``csrc/ssd_scan.cu``), replacing the JAX package's ``ssd_scan_pallas``:
returns ``y`` in x's dtype and the final state in fp32. It runs its
plain version (:func:`ssd_scan_plain`, ``ref.ssd_chunked``) when, and
only when, its tensors lie on the CPU. For CUDA tensors it launches the
kernel or raises. It counts its launches in ``.launches``, a plain
integer that a caller may reset. The kernel launches on PyTorch's
current stream and does not synchronise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIM = 64         # the state dim N the kernel is built for
P_SLICE = 32           # head dim P must be a multiple of this
MAX_CHUNK = 256        # largest chunk Q (one chunk row per thread)


def ssd_scan_plain(x, dt, A, Bm, Cm, D=None, *, chunk_size: int = 256):
    """Plain version of the kernel: ``ref.ssd_chunked`` from zero state."""
    return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk_size=chunk_size)


def ssd_scan_cuda(
    x: torch.Tensor,                     # (B, S, H, P) fp32 or bf16
    dt: torch.Tensor,                    # (B, S, H) fp32
    A: torch.Tensor,                     # (H,) fp32
    Bm: torch.Tensor,                    # (B, S, G, N) x's dtype
    Cm: torch.Tensor,                    # (B, S, G, N)
    D: Optional[torch.Tensor] = None,    # (H,) fp32
    *,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from zero state with chunks of ``min(chunk_size,
    S)`` rows; returns (y (B, S, H, P) in x's dtype, final state (B, H,
    P, N) fp32). The kernel takes N == 64, P a multiple of 32, a chunk
    of at most 256 rows and G dividing H."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk_size=chunk_size)
    name = "ssd_scan_cuda"
    tensors = [x, dt, A, Bm, Cm] + ([D] if D is not None else [])
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{name}: B/C dtypes must be x's ({x.dtype})")
    if any(t.dtype != torch.float32 for t in (dt, A) + ((D,) if D is not None
                                                       else ())):
        raise TypeError(f"{name}: dt, A and D must be float32")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, g, n)
            or Cm.shape != Bm.shape or (D is not None and D.shape != (h,))):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)} "
            f"disagree")
    q = min(int(chunk_size), s)
    if (n != STATE_DIM or p % P_SLICE or g <= 0 or h % g or q <= 0
            or q > MAX_CHUNK):
        raise ValueError(
            f"{name}: needs N == {STATE_DIM}, P % {P_SLICE} == 0, H % G "
            f"== 0 and a chunk of 1..{MAX_CHUNK} rows, got N={n} P={p} "
            f"H={h} G={g} chunk={q}")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return y, final.zero_()
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr() if D is not None else None,
            y.data_ptr(), final.data_ptr(), b, s, h, p, g, n, q,
            _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    ssd_scan_cuda.launches += 1
    return y, final


ssd_scan_cuda.launches = 0
