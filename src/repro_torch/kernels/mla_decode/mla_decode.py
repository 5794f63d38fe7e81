"""Hand-written CUDA absorbed-MLA decode kernels and their plain versions.

  * :func:`mla_decode_cuda` — decode over a contiguous latent cache
    (``csrc/mla_decode.cu::mla_decode_fwd``), replacing the JAX
    package's ``mla_decode_pallas``.
  * :func:`mla_decode_paged_cuda` — the same over a paged latent pool
    with the block-table gather inside the kernel
    (``csrc/mla_decode.cu::mla_decode_paged_fwd``), replacing
    ``mla_decode_paged_pallas``: the decode attention of MLA serving.

Both read each tile of latent positions once and use it for the scores
and for the values; no (B, H, S) tensor reaches device memory. Each
wrapper runs its plain version (``ref.mla_decode_online_plain``,
``ref.mla_decode_paged_online_plain``) when, and only when, its tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises. Each
counts its launches in ``.launches``. The kernels are built for the
latent rank and RoPE width of deepseek-v2 (``RANK``, ``ROPE_DIM``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    _DTYPE_CODES, _check_cuda, _raise_on)
from repro_torch.kernels.mla_decode import ref

RANK = 512          # latent rank r the kernels are built for
ROPE_DIM = 64       # RoPE width Dr the kernels are built for


def _check_mla(name, q_abs, q_r, ckv, kr, lens, *more):
    """Common checks; returns (B, H)."""
    _check_cuda(name, q_abs.dtype, q_abs, q_r, ckv, kr, lens, *more)
    if any(t.dtype != q_abs.dtype for t in (q_r, ckv, kr)):
        raise TypeError(f"{name}: q_abs, q_r and the caches must share a "
                        f"dtype")
    if any(t.dtype != torch.int32 for t in (lens, *more)):
        raise TypeError(f"{name}: lengths and block tables must be int32")
    if any(t.data_ptr() % 16 for t in (q_abs, q_r, ckv, kr)):
        raise ValueError(f"{name}: q and cache tensors must start on a "
                         f"16-byte boundary (vector loads)")
    b, h, r = q_abs.shape
    if (r != RANK or q_r.shape != (b, h, ROPE_DIM)
            or ckv.shape[-1] != RANK or kr.shape[-1] != ROPE_DIM
            or ckv.shape[:-1] != kr.shape[:-1] or lens.shape != (b,)):
        raise ValueError(
            f"{name}: built for r={RANK}, Dr={ROPE_DIM}; got q_abs "
            f"{tuple(q_abs.shape)} q_r {tuple(q_r.shape)} ckv "
            f"{tuple(ckv.shape)} kr {tuple(kr.shape)} lens "
            f"{tuple(lens.shape)}")
    return b, h


def mla_decode_cuda(q_abs: torch.Tensor, q_r: torch.Tensor,
                    ckv: torch.Tensor, kr: torch.Tensor,
                    kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q_abs (B, H, r), q_r (B, H, Dr), ckv (B, S, r), kr (B, S, Dr) in
    one dtype (fp32 or bf16); kv_len (B,) int32 >= 1 (positions >=
    kv_len[b] are masked). Returns (B, H, r) fp32."""
    if q_abs.device.type == "cpu":
        return ref.mla_decode_online_plain(q_abs, q_r, ckv, kr, kv_len,
                                           scale)
    name = "mla_decode_cuda"
    b, h = _check_mla(name, q_abs, q_r, ckv, kr, kv_len)
    s = ckv.shape[1]
    if ckv.shape[0] != b or s <= 0:
        raise ValueError(f"{name}: ckv {tuple(ckv.shape)} for B={b}")
    out = torch.empty((b, h, RANK), dtype=torch.float32,
                      device=q_abs.device)
    if b == 0 or h == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        err = lib.mla_decode_fwd(
            q_abs.data_ptr(), q_r.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), b, h, RANK, ROPE_DIM, s,
            float(scale), _DTYPE_CODES[q_abs.dtype], stream)
    _raise_on(name, err)
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0


def mla_decode_paged_cuda(q_abs: torch.Tensor, q_r: torch.Tensor,
                          ckv_pool: torch.Tensor, kr_pool: torch.Tensor,
                          block_tables: torch.Tensor, kv_lens: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q_abs (B, H, r), q_r (B, H, Dr), pools (N, bs, r) and (N, bs, Dr)
    in one dtype; block_tables (B, MB) int32 with NULL == N; kv_lens (B,)
    int32 effective lengths >= 1. Table entries outside [0, N) act as
    blocks of zeros and are never read. Returns (B, H, r) fp32."""
    if q_abs.device.type == "cpu":
        return ref.mla_decode_paged_online_plain(
            q_abs, q_r, ckv_pool, kr_pool, block_tables, kv_lens, scale)
    name = "mla_decode_paged_cuda"
    b, h = _check_mla(name, q_abs, q_r, ckv_pool, kr_pool, kv_lens,
                      block_tables)
    n, bs = ckv_pool.shape[:2]
    if (block_tables.ndim != 2 or block_tables.shape[0] != b
            or block_tables.shape[1] <= 0 or n <= 0 or bs <= 0):
        raise ValueError(f"{name}: tables {tuple(block_tables.shape)} and "
                         f"pool {tuple(ckv_pool.shape)} for B={b}")
    out = torch.empty((b, h, RANK), dtype=torch.float32,
                      device=q_abs.device)
    if b == 0 or h == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        err = lib.mla_decode_paged_fwd(
            q_abs.data_ptr(), q_r.data_ptr(), ckv_pool.data_ptr(),
            kr_pool.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), b, h, RANK, ROPE_DIM, n, bs,
            block_tables.shape[1], float(scale), _DTYPE_CODES[q_abs.dtype],
            stream)
    _raise_on(name, err)
    mla_decode_paged_cuda.launches += 1
    return out


mla_decode_paged_cuda.launches = 0
