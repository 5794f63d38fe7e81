"""Plain PyTorch xLSTM mLSTM (matrix-memory) scans
(port of ``repro/kernels/mlstm_scan/ref.py``).

The mLSTM cell (xLSTM paper, arXiv:2405.04517) per head:

    C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory, (dk, dv))
    n_t = f_t n_{t-1} + i_t k_t              (normalizer, (dk,))
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))

with exponential input gating stabilized in log space:
    lf_t = logsigmoid(f~_t);  m_t = max(lf_t + m_{t-1}, i~_t)
    f_t = exp(lf_t + m_{t-1} - m_t);  i_t = exp(i~_t - m_t)

``mlstm_sequential`` is the direct recurrence (ground truth).
``mlstm_chunked`` is the chunkwise-parallel form: quadratic within
chunks of length Q, the state carried across chunks, all in stabilized
log space; it is the plain version the CUDA kernel (``mlstm_scan.py``)
is held against. ``mlstm_decode_step`` is the one-token recurrence of
decode. All three compute in fp32; the scans return h in q's dtype,
the decode step h in fp32, and the state in fp32.

Layouts: q/k (B, S, H, dk), v (B, S, H, dv), i_pre/f_pre (B, S, H).
State: (C (B, H, dk, dv), n (B, H, dk), m (B, H)), the stabilized
memory, normalizer and running log-space max.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_BIG = -1e30       # the stabilizer's start, and the pad rows' i~
PAD_F = 30.0          # the pad rows' f~: f ~ 1, the state is kept

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def init_state(b: int, h: int, dk: int, dv: int, device=None) -> State:
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), NEG_BIG, dtype=torch.float32, device=device))


def mlstm_sequential(q, k, v, i_pre, f_pre,
                     initial_state: Optional[State] = None
                     ) -> Tuple[torch.Tensor, State]:
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    C, n, m = initial_state or init_state(b, h, dk, dv, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    it_all, ft_all = i_pre.float(), f_pre.float()
    ys = []
    for t in range(s):
        qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]
        it, ft = it_all[:, t], ft_all[:, t]
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(it - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fg[..., None] * n + ig[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C) * scale
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", qt, n)) * scale,
            torch.exp(-m_new))
        m = m_new
        ys.append(num / den[..., None])
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, h, dv), dtype=torch.float32,
                          device=q.device))
    return y.to(q.dtype), (C, n, m)


def mlstm_chunked(q, k, v, i_pre, f_pre, *, chunk_size: int = 256,
                  initial_state: Optional[State] = None,
                  acc_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, State]:
    """Chunks of ``min(chunk_size, S)`` rows; a ragged tail is padded
    with q = k = v = 0, i~ = -1e30 (no input) and f~ = 30 (the state
    kept), as the JAX package pads it. It computes in ``acc_dtype``:
    fp32, as the JAX package does, or fp64 for a reference of more
    digits (fp32 autograd through it is ~1e-4 off its fp64 self at
    xlstm-125m's widths); the state comes back in fp32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    orig_s = s
    cq = min(chunk_size, s)
    if s % cq != 0:
        pad = cq - s % cq
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_BIG)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=PAD_F)
        s += pad
    nc = s // cq

    def rs(x, feat):       # (B, S, H, F) -> (NC, B, H, CQ, F)
        return x.to(acc_dtype).reshape(b, nc, cq, h, feat).permute(
            1, 0, 3, 2, 4)

    qc, kc, vc = rs(q, dk), rs(k, dk), rs(v, dv)
    ic = i_pre.to(acc_dtype).reshape(b, nc, cq, h).permute(1, 0, 3, 2)
    fc = f_pre.to(acc_dtype).reshape(b, nc, cq, h).permute(1, 0, 3, 2)
    C, n, m = (t.to(acc_dtype) for t in (
        initial_state or init_state(b, h, dk, dv, q.device)))
    idx = torch.arange(cq, device=q.device)
    tri = idx[:, None] >= idx[None, :]            # causal within a chunk
    ys = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[c], kc[c], vc[c], ic[c], fc[c]
        lf = F.logsigmoid(fb)                     # (B, H, CQ)
        bcs = torch.cumsum(lf, dim=-1)            # inclusive log-decay
        g = bcs[..., -1]                          # the chunk's decay
        # intra-chunk log weights D_ij = b_i - b_j + i~_j (j <= i)
        Dm = bcs[..., :, None] - bcs[..., None, :] + ib[..., None, :]
        Dm = Dm.masked_fill(~tri, float("-inf"))
        m_intra = Dm.amax(dim=-1)
        # inter-chunk: row i sees the state with decay b_i, stabilizer m
        m_inter = bcs + m[..., None]
        m_i = torch.maximum(m_intra, m_inter)
        intra = torch.exp(Dm - m_i[..., None])    # (B, H, CQ, CQ)
        qk = torch.einsum("bhik,bhjk->bhij", qb, kb) * scale
        w_intra = intra * qk
        num = torch.einsum("bhij,bhjv->bhiv", w_intra, vb)
        den = w_intra.sum(dim=-1)
        inter_w = torch.exp(m_inter - m_i)
        num = num + inter_w[..., None] * torch.einsum(
            "bhik,bhkv->bhiv", qb, C) * scale
        den = den + inter_w * torch.einsum("bhik,bhk->bhi", qb, n) * scale
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_i))[..., None])
        # the state update, stabilized by the new max m'
        w_state = g[..., None] - bcs + ib         # log weight of k_j in C'
        m_new = torch.maximum(g + m, w_state.amax(dim=-1))
        carry_w = torch.exp(g + m - m_new)
        kw = torch.exp(w_state - m_new[..., None])
        C = carry_w[..., None, None] * C + torch.einsum(
            "bhj,bhjk,bhjv->bhkv", kw, kb, vb)
        n = carry_w[..., None] * n + torch.einsum("bhj,bhjk->bhk", kw, kb)
        m = m_new
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    return y[:, :orig_s].to(q.dtype), (C.float(), n.float(), m.float())


def mlstm_decode_step(state: State, qt, kt, vt, it, ft
                      ) -> Tuple[torch.Tensor, State]:
    """One token. qt/kt (B, H, dk), vt (B, H, dv), it/ft (B, H); returns
    (h (B, H, dv) fp32, the new state)."""
    C, n, m = state
    scale = qt.shape[-1] ** -0.5
    qt, kt, vt = qt.float(), kt.float(), vt.float()
    it = it.float()
    lf = F.logsigmoid(ft.float())
    m_new = torch.maximum(lf + m, it)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(it - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])
    n = fg[..., None] * n + ig[..., None] * kt
    num = torch.einsum("bhk,bhkv->bhv", qt, C) * scale
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)) * scale,
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)
