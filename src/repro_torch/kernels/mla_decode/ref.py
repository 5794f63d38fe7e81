"""Plain PyTorch absorbed-MLA single-token decode attention
(port of ``repro/kernels/mla_decode/ref.py`` and the paged gather of
``repro/kernels/mla_decode/ops.py``).

Inputs (per layer):
  q_abs (B, H, r)   queries absorbed through W_uk into latent space
  q_r   (B, H, Dr)  decoupled RoPE queries
  ckv   (B, S, r)   compressed latent cache
  kr    (B, S, Dr)  shared RoPE key cache
  kv_len (B,)       valid cache length per sequence
Output: out_lat (B, H, r) fp32, the attention-weighted latent (the
caller applies W_uv and wo). A paged cache is a pool ``ckv_pool`` (N,
bs, r), ``kr_pool`` (N, bs, Dr) with block tables (B, MB) int32 whose
entries outside ``[0, N)`` (NULL == N) read as blocks of zeros.

  * :func:`mla_decode_dense` — fp32 throughout, the full score matrix.
  * :func:`mla_decode_paged_ref` — gathers each sequence's window, NULL
    blocks as zeros, then :func:`mla_decode_dense`.
  * :func:`mla_decode_online_plain` / :func:`mla_decode_paged_online_plain`
    — the Pallas kernels' arithmetic step by step (a tile of positions
    at a time, online softmax in fp32, ``p`` cast to the cache dtype
    before the value product). The plain versions the CUDA kernels are
    held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def mla_decode_dense(q_abs, q_r, ckv, kr, kv_len, scale: float
                     ) -> torch.Tensor:
    scores = (torch.einsum("bhr,bsr->bhs", q_abs.float(), ckv.float()) +
              torch.einsum("bhd,bsd->bhs", q_r.float(), kr.float())) * scale
    s = ckv.shape[1]
    mask = (torch.arange(s, device=ckv.device)[None, None, :]
            < kv_len[:, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, ckv.float())


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """pool (N, bs, F), tables (B, MB) -> (B, MB*bs, F); entries outside
    [0, N) give zeros (the JAX ``mode="fill"`` gather)."""
    n = pool.shape[0]
    ok = (block_tables >= 0) & (block_tables < n)
    idx = torch.where(ok, block_tables, 0).long()
    win = torch.where(ok[:, :, None, None], pool[idx], 0)
    return win.reshape(block_tables.shape[0], -1, pool.shape[-1])


def mla_decode_paged_ref(q_abs, q_r, ckv_pool, kr_pool, block_tables,
                         kv_lens, scale: float) -> torch.Tensor:
    """``ops.mla_decode_paged_attention(impl="reference")`` of the JAX
    package: materialize the window, then the dense oracle."""
    return mla_decode_dense(q_abs, q_r, gather_blocks(ckv_pool, block_tables),
                            gather_blocks(kr_pool, block_tables), kv_lens,
                            scale)


def _online_step(state, qa, qr, ckv, kr, kpos, kv_len, scale):
    """One tile of the Pallas kernel: ckv (B, T, r), kr (B, T, Dr) at
    positions ``kpos`` (T,)."""
    acc, m, l = state
    s = (torch.einsum("bhr,btr->bht", qa.float(), ckv.float()) +
         torch.einsum("bhd,btd->bht", qr.float(), kr.float())) * scale
    s = torch.where(kpos[None, None, :] < kv_len[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bht,btr->bhr", p.to(ckv.dtype).float(), ckv.float())
    return acc, m_new, l


def _online_init(q_abs):
    b, h, r = q_abs.shape
    dev = q_abs.device
    return (torch.zeros((b, h, r), dtype=torch.float32, device=dev),
            torch.full((b, h), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((b, h), dtype=torch.float32, device=dev))


def _online_finish(state):
    acc, _, l = state
    return acc / torch.clamp(l, min=1e-30)[..., None]


def mla_decode_online_plain(q_abs, q_r, ckv, kr, kv_len, scale: float,
                            chunk: int = 512) -> torch.Tensor:
    """``mla_decode_pallas`` step by step: S zero-padded to a multiple of
    ``chunk`` (at most S), one chunk of positions at a time."""
    s = ckv.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        kr = F.pad(kr, (0, 0, 0, pad))
    state = _online_init(q_abs)
    for lo in range(0, ckv.shape[1], chunk):
        kpos = torch.arange(lo, lo + chunk, device=ckv.device)
        state = _online_step(state, q_abs, q_r, ckv[:, lo:lo + chunk],
                             kr[:, lo:lo + chunk], kpos, kv_len, scale)
    return _online_finish(state)


def mla_decode_paged_online_plain(q_abs, q_r, ckv_pool, kr_pool,
                                  block_tables, kv_lens, scale: float
                                  ) -> torch.Tensor:
    """``mla_decode_paged_pallas`` step by step: one logical block j of
    every sequence at a time, read from pool block ``block_tables[b, j]``
    (zeros for an entry outside [0, N))."""
    n, bs, _ = ckv_pool.shape
    state = _online_init(q_abs)
    for j in range(block_tables.shape[1]):
        tbl = block_tables[:, j:j + 1]
        kpos = torch.arange(j * bs, (j + 1) * bs, device=ckv_pool.device)
        state = _online_step(state, q_abs, q_r,
                             gather_blocks(ckv_pool, tbl),
                             gather_blocks(kr_pool, tbl), kpos, kv_lens,
                             scale)
    return _online_finish(state)
