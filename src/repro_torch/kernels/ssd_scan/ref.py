"""Plain PyTorch Mamba2 SSD (state-space dual) scans
(port of ``repro/kernels/ssd_scan/ref.py``).

Layouts:
  x  (B, S, H, P)   channels grouped into H heads of dim P
  dt (B, S, H)      post-softplus step sizes
  A  (H,)           negative per-head decay (A < 0)
  Bm (B, S, G, N)   input->state projection, G groups broadcast over heads
  Cm (B, S, G, N)   state->output projection
  D  (H,) or None   skip connection
State: (B, H, P, N), fp32.

``ssd_sequential`` is the direct recurrence (ground truth for tests).
``ssd_chunked`` is the chunked SSD algorithm (Mamba2 paper, listing 1):
identical math in O(S/Q) sequential steps; it is the plain version the
CUDA kernel (``ssd_scan.py``) is held against. ``ssd_decode_step`` is
the one-token recurrence of decode. All three compute in fp32 and return
``y`` in x's dtype and the state in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _broadcast_groups(m: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N); head h reads group h // (H // G)."""
    b, s, g, n = m.shape
    rep = num_heads // g
    if rep == 1:
        return m
    return m[:, :, :, None, :].expand(b, s, g, rep, n).reshape(
        b, s, num_heads, n)


def ssd_sequential(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, D: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    Bf = _broadcast_groups(Bm, h).float()
    Cf = _broadcast_groups(Cm, h).float()
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, None, :])        # (B, S, H)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        dbx = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                           Bf[:, t])
        state = dA[:, t, :, None, None] * state + dbx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32,
                          device=x.device))
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[..., i, j] = sum(a[..., j+1 : i+1]) for i >= j, -inf otherwise."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                device=a.device))


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, D: Optional[torch.Tensor] = None,
    *,
    chunk_size: int = 256,
    initial_state: Optional[torch.Tensor] = None,
    acc_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan; a ragged tail is padded with zeros (dt = 0
    keeps the state and adds nothing). Returns (y in x's dtype, final
    state fp32). It computes in ``acc_dtype``: fp32, as the JAX package
    does, or fp64 for a reference of more digits (its gradient of A, a
    small sum of large terms, keeps ~5 digits in fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    orig_s = s
    q = min(chunk_size, s)
    if s % q != 0:
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    c = s // q

    Bf = _broadcast_groups(Bm, h).to(acc_dtype).reshape(b, c, q, h, n)
    Cf = _broadcast_groups(Cm, h).to(acc_dtype).reshape(b, c, q, h, n)
    xf = x.to(acc_dtype).reshape(b, c, q, h, p)
    dtf = dt.to(acc_dtype).reshape(b, c, q, h)
    dA_log = dtf * A.to(acc_dtype)[None, None, None, :]  # (B, C, Q, H)
    dA_log = dA_log.permute(0, 3, 1, 2)                  # (B, H, C, Q)
    A_cum = torch.cumsum(dA_log, dim=-1)                 # (B, H, C, Q)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA_log))                       # (B, H, C, Q, Q)
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp",
                          Cf, Bf, L, dtf[..., None] * xf)

    # 2) per-chunk final states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)    # (B, H, C, Q)
    chunk_states = torch.einsum("bcqhn,bhcq,bcqhp->bchpn",
                                Bf, decay_states, dtf[..., None] * xf)

    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(A_cum[..., -1])              # (B, H, C)
    state = (initial_state.to(acc_dtype) if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=acc_dtype,
                              device=x.device))
    prev = []
    for ci in range(c):
        prev.append(state)
        state = (chunk_decay[:, :, ci, None, None] * state
                 + chunk_states[:, ci])
    prev_states = torch.stack(prev, dim=1)               # (B, C, H, P, N)

    # 4) inter-chunk (off-diagonal) output contribution
    state_decay_out = torch.exp(A_cum)                   # (B, H, C, Q)
    Y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp",
                         Cf, prev_states, state_decay_out)

    y = (Y_diag + Y_off).reshape(b, s, h, p)[:, :orig_s]
    if D is not None:
        y = y + (x.to(acc_dtype)[:, :orig_s]
                 * D.to(acc_dtype)[None, None, :, None])
    return y.to(x.dtype), state.float()


def ssd_decode_step(
    state: torch.Tensor,       # (B, H, P, N)
    x: torch.Tensor,           # (B, H, P) one token
    dt: torch.Tensor,          # (B, H)
    A: torch.Tensor,           # (H,)
    Bm: torch.Tensor,          # (B, G, N)
    Cm: torch.Tensor,          # (B, G, N)
    D: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence; returns (y (B, H, P) in x's dtype,
    the new state fp32)."""
    hh = state.shape[1]
    rep = hh // Bm.shape[1]
    Bf = Bm.float().repeat_interleave(rep, dim=1)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])             # (B, H)
    dbx = torch.einsum("bh,bhp,bhn->bhpn", dtf, xf, Bf)
    state = dA[:, :, None, None] * state.float() + dbx
    y = torch.einsum("bhpn,bhn->bhp", state, Cf)
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), state
