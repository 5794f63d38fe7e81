"""Plain PyTorch attention (port of ``repro/kernels/flash_attention/ref.py``).

  * ``mha_dense`` — materializes the full score matrix; the oracle the
    kernels are held against (with ``want_lse``, also the row
    log-sum-exp the backward needs).
  * ``mha_chunked`` — online-softmax loop over KV chunks, numerically
    the dense oracle with O(S * chunk) memory; ``want_lse`` returns the
    lse as ``_mha_chunked_fwd_only(want_lse=True)`` does.
  * ``flash_bwd_ref`` — the recompute backward, a line-for-line port of
    ``_flash_bwd``: rebuilds each (Sq, chunk) probability tile from the
    saved lse. The plain version of the backward kernel.
  * ``paged_decode_ref`` — materialize-then-attend paged decode
    (``repro/kernels/flash_attention/ops.py:74-81``): gather each
    sequence's blocks into a dense window, NULL entries as zeros, then
    ``mha_dense``.

Layouts: q (B, Sq, H, D); k/v (B, Skv, Hkv, D) with H % Hkv == 0 (GQA:
q head ``h`` reads kv head ``h // (H // Hkv)``). ``q_offset`` is the
absolute position of q[0].
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * q_per_kv, D); head h <- h // q_per_kv."""
    if q_per_kv == 1:
        return x
    return x.repeat_interleave(q_per_kv, dim=2)


def mha_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
    want_lse: bool = False,
):
    """Dense-softmax oracle. kv_len (B,) masks positions >= kv_len. With
    ``want_lse`` returns ``(out, lse)``, lse (B, Sq, H) fp32."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask = mask[None] & (kpos[None, None, :] < kv_len[:, None, None])
        mask = mask[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if want_lse:
        return out, torch.logsumexp(scores, dim=-1).transpose(1, 2)
    return out


def mha_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    chunk_size: int = 512,
    kv_len: Optional[torch.Tensor] = None,
    want_lse: bool = False,
):
    """Online-softmax (flash-style) loop over KV chunks, fp32 state.

    Like the JAX scan, the score product takes q and k in their own
    dtype with fp32 accumulation, and the probabilities are cast to
    q's dtype before the value product. With ``want_lse`` returns
    ``(out, lse)``, lse = m + log(max(l, 1e-30)) (B, Sq, H) fp32.
    """
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    q_per_kv = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    chunk = min(chunk_size, skv)
    n_chunks = -(-skv // chunk)
    if kv_len is None and skv % chunk:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    qpos = torch.arange(sq, device=q.device) + q_offset
    qf = q.float()
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        lo = c * chunk
        kb = k[:, lo:lo + chunk]
        vb = v[:, lo:lo + chunk]
        if kb.shape[1] < chunk:           # pad the ragged last chunk
            pad = chunk - kb.shape[1]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        kb = _repeat_kv(kb, q_per_kv)
        vb = _repeat_kv(vb, q_per_kv)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb.float()) * scale
        kpos = lo + torch.arange(chunk, device=q.device)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        if kv_len is not None:
            mask = mask[None] & (kpos[None, None, :] <
                                 kv_len[:, None, None])
            mask = mask[:, :, None, :]
        else:
            mask = mask[None, :, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    if want_lse:
        return out, m + torch.log(torch.clamp(l, min=1e-30))
    return out


def flash_bwd_ref(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Skv, Hkv, D)
    v: torch.Tensor,
    out: torch.Tensor,                   # (B, Sq, H, D) forward output
    lse: torch.Tensor,                   # (B, Sq, H) fp32
    dout: torch.Tensor,                  # (B, Sq, H, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    chunk_size: int = 512,
    kv_len: Optional[torch.Tensor] = None,
):
    """Recompute backward of causal GQA attention: returns (dq, dk, dv)
    in the dtypes of q, k, v. Port of ``ref.py::_flash_bwd``: products
    take their operands in the input dtype with fp32 accumulation, p is
    cast to q's dtype before the dv product and ds before the dq and dk
    products; GQA folds the repeated heads' dk/dv back by summing."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    q_per_kv = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    chunk = min(chunk_size, skv)
    n_chunks = -(-skv // chunk)
    Dv = torch.sum(dout.float() * out.float(), dim=-1)        # (B, Sq, H)
    qpos = torch.arange(sq, device=q.device) + q_offset
    qf, dof = q.float(), dout.float()
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c in range(n_chunks):
        lo = c * chunk
        kb = k[:, lo:lo + chunk]
        vb = v[:, lo:lo + chunk]
        if kb.shape[1] < chunk:           # pad the ragged last chunk
            pad = chunk - kb.shape[1]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        kbf = _repeat_kv(kb, q_per_kv).float()
        vbf = _repeat_kv(vb, q_per_kv).float()
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kbf) * scale
        kpos = lo + torch.arange(chunk, device=q.device)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        bmask = mask[None, :, :] & (kpos[None, None, :] <
                                    kv_len[:, None, None])
        p = torch.where(bmask[:, :, None, :], torch.exp(s - lse[..., None]),
                        torch.zeros((), device=q.device))
        pl = p.to(q.dtype).float()
        dvs.append(torch.einsum("bqhk,bqhd->bkhd", pl, dof))
        dp = torch.einsum("bqhd,bkhd->bqhk", dof, vbf)
        ds = (p * (dp - Dv[..., None]) * scale).to(q.dtype).float()
        dq = dq + torch.einsum("bqhk,bkhd->bqhd", ds, kbf)
        dks.append(torch.einsum("bqhk,bqhd->bkhd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :skv]
    dv = torch.cat(dvs, dim=1)[:, :skv]
    if q_per_kv > 1:                      # GQA: fold repeated heads back
        dk = dk.reshape(b, skv, hkv, q_per_kv, d).sum(dim=3)
        dv = dv.reshape(b, skv, hkv, q_per_kv, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_decode_ref(
    q: torch.Tensor,                     # (B, 1, H, D)
    k_pool: torch.Tensor,                # (N, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, MB) int32, NULL == N
    kv_lens: torch.Tensor,               # (B,) int32 effective lengths
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Materialize-then-attend paged decode.

    Table entries outside ``[0, N)`` (the NULL sentinel ``N``) gather a
    zero block, as the JAX reference's ``mode="fill"`` gather does; the
    index is masked before the gather, so no such entry is read.
    """
    b = q.shape[0]
    n = k_pool.shape[0]
    tables = block_tables.long()
    valid = (tables >= 0) & (tables < n)
    idx = torch.where(valid, tables, torch.zeros_like(tables))
    keep = valid[:, :, None, None, None]

    def gather(pool):
        g = pool[idx]                                   # (B, MB, bs, Hkv, D)
        g = torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
        return g.reshape(b, -1, *pool.shape[2:])

    return mha_dense(q, gather(k_pool), gather(v_pool), causal=False,
                     softmax_scale=softmax_scale, kv_len=kv_lens)
