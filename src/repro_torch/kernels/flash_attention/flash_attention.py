"""Hand-written CUDA attention kernels and their plain PyTorch versions.

  * :func:`flash_attention_cuda` — causal GQA flash-attention forward
    (``csrc/flash_attention.cu``), replacing the JAX package's
    ``flash_attention_pallas``; head dim 64 or 128, optionally with the
    row log-sum-exp. Used by prefill and by training.
  * :func:`flash_attention_bwd_cuda` — its recompute backward
    (``csrc/flash_attention_bwd.cu``), held against ``ref.py::_flash_bwd``
    (the Pallas kernel has no backward).
  * :class:`FlashAttentionFn` — the two as one ``torch.autograd.Function``.
  * :func:`flash_decode_paged_cuda` — single-query GQA decode over a
    paged pool with the block-table gather inside the kernel
    (``csrc/paged_decode.cu``), replacing ``flash_decode_paged_pallas``.

Each wrapper runs its plain PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`, :func:`flash_decode_paged_plain`) when,
and only when, its tensors lie on the CPU. For CUDA tensors it launches
the kernel or raises. Each wrapper counts its launches in ``.launches``,
a plain integer that a caller may reset, so a run can show that it went
through the kernel (the backward wrapper counts one per call, which is
two kernel launches: the dq pass, then the dk/dv pass). The kernels
launch on PyTorch's current stream and do not synchronise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PREFILL_HEAD_DIMS = (64, 128)   # head dims of the prefill kernels
HEAD_DIM = 64          # the head dim the decode kernel is built for
MAX_GROUP = 16         # most query heads per kv head the decode kernel takes


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0,
                          softmax_scale=None, return_lse=False):
    """Plain version of the prefill kernel: the dense oracle (with
    ``return_lse``, also its lse (B, Sq, H) fp32)."""
    return ref.mha_dense(q, k, v, causal=causal, q_offset=q_offset,
                         softmax_scale=softmax_scale, want_lse=return_lse)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              q_offset=0, softmax_scale=None):
    """Plain version of the backward kernel: ``ref.flash_bwd_ref``."""
    return ref.flash_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                             q_offset=q_offset, softmax_scale=softmax_scale)


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, kv_lens, *,
                             softmax_scale=None):
    """Plain version of the decode kernel: materialize-then-attend."""
    return ref.paged_decode_ref(q, k_pool, v_pool, block_tables, kv_lens,
                                softmax_scale=softmax_scale)


def _check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def flash_attention_cuda(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Causal GQA flash attention; returns (B, Sq, H, D) in q's dtype, and
    with ``return_lse`` also the row log-sum-exp (B, Sq, H) fp32.

    kv positions ``>= Skv`` do not exist; with ``causal`` q row ``i``
    (absolute position ``i + q_offset``) sees kv positions ``<= i +
    q_offset``. Every row must see at least one key (true for causal
    attention with ``q_offset >= 0``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     softmax_scale=softmax_scale,
                                     return_lse=return_lse)
    name = "flash_attention_cuda"
    b, sq, h, d, skv, hkv = _check_attention(name, q, k, v, q_offset)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, sq, skv, h, hkv, d, int(bool(causal)), int(q_offset),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def _check_attention(name, q, k, v, q_offset, *more):
    _check_cuda(name, q.dtype, q, k, v, *more)
    b, sq, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ")
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d not in PREFILL_HEAD_DIMS or hkv <= 0 or h % hkv:
        raise ValueError(f"{name}: needs D in {PREFILL_HEAD_DIMS} and "
                         f"H % Hkv == 0, got D={d} H={h} Hkv={hkv}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0")
    return b, sq, h, d, skv, hkv


def flash_attention_bwd_cuda(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Skv, Hkv, D)
    v: torch.Tensor,
    out: torch.Tensor,                   # (B, Sq, H, D) forward output
    lse: torch.Tensor,                   # (B, Sq, H) fp32 forward lse
    dout: torch.Tensor,                  # (B, Sq, H, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
):
    """Recompute backward of :func:`flash_attention_cuda`: returns (dq,
    dk, dv) in q's dtype. Deterministic: no float atomics (dq in one
    pass, dk/dv summed over each GQA group inside one block in a
    second)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, q_offset=q_offset,
                                         softmax_scale=softmax_scale)
    name = "flash_attention_bwd_cuda"
    b, sq, h, d, skv, hkv = _check_attention(name, q, k, v, q_offset, out,
                                             lse, dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} differ from q "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"{name}: out/dout dtypes differ from q")
    if lse.dtype != torch.float32 or lse.shape != (b, sq, h):
        raise ValueError(f"{name}: lse must be fp32 {(b, sq, h)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dvec = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, h, hkv, d, int(bool(causal)), int(q_offset),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with its lse,
    the backward kernel for the gradients (their plain versions for CPU
    tensors). Saves (q, k, v, out, lse) and nothing of size Sq x Skv.
    Under activation checkpointing the forward runs again in the
    recompute and the backward reads that run's lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, softmax_scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        q_offset=q_offset,
                                        softmax_scale=softmax_scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, softmax_scale = ctx.args
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            q_offset=q_offset, softmax_scale=softmax_scale)
        return dq, dk, dv, None, None, None


def flash_decode_paged_cuda(
    q: torch.Tensor,                     # (B, 1, H, D)
    k_pool: torch.Tensor,                # (N, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, MB) int32, NULL == N
    kv_lens: torch.Tensor,               # (B,) int32 effective lengths
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-query GQA decode over a paged pool; returns (B, 1, H, D).

    ``kv_lens`` are effective lengths (>= 1; positions ``>= kv_lens[b]``
    are masked) and the new token's K/V must already be in the pool.
    Table entries outside ``[0, N)`` act as blocks of zeros and are
    never read."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, block_tables,
                                        kv_lens,
                                        softmax_scale=softmax_scale)
    name = "flash_decode_paged_cuda"
    _check_cuda(name, q.dtype, q, k_pool, v_pool, block_tables, kv_lens)
    b, sq, h, d = q.shape
    n, bs, hkv, dk = k_pool.shape
    if sq != 1:
        raise ValueError(f"{name}: expects a single query, got {sq}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q/pool dtypes differ")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and kv_lens must be int32")
    if (v_pool.shape != k_pool.shape or dk != d or block_tables.ndim != 2
            or block_tables.shape[0] != b or kv_lens.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)}"
            f" tables {tuple(block_tables.shape)} lens "
            f"{tuple(kv_lens.shape)} disagree")
    if (d != HEAD_DIM or hkv <= 0 or h % hkv or h // hkv > MAX_GROUP
            or n <= 0 or bs <= 0 or block_tables.shape[1] <= 0):
        raise ValueError(
            f"{name}: needs D == {HEAD_DIM}, H % Hkv == 0, H/Hkv <= "
            f"{MAX_GROUP} and a non-empty pool, got D={d} H={h} Hkv={hkv} "
            f"N={n} bs={bs} MB={block_tables.shape[1]}")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            b, h, hkv, d, n, bs, block_tables.shape[1], float(scale),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_decode_paged_cuda.launches += 1
    return out


flash_decode_paged_cuda.launches = 0
