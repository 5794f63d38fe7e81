"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(port of ``repro/models/xlstm.py``).

The xlstm-125m stack alternates mLSTM blocks (parallel over the sequence
through the chunkwise scan of ``kernels/mlstm_scan``) with sLSTM blocks
(a recurrence with block-diagonal per-head recurrent weights, serial in
time: a Python loop over the tokens here, as the JAX package scans over
time; under autograd its backward is autograd's, token by token). d_ff=0
in the config means there is no separate FFN sub-block: the mLSTM block
carries an internal 2x up-projection and the sLSTM block a gated (4/3x)
post-FFN, as in the paper.

Decode state:
  mLSTM: (conv tail (B, K-1, d_inner) in the compute dtype, (C (B, H,
         dk, dv), n (B, H, dk), m (B, H)) in fp32)
  sLSTM: (conv tail (B, K-1, d_model) in the compute dtype, (c, n, m,
         h) each (B, d_model) in fp32)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan.ref import NEG_BIG
from repro_torch.models.blocks import _cast, dense_init, dtype_of
from repro_torch.models.ssm import _causal_conv


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    h = cfg.xlstm.num_heads
    return d_inner, h, d_inner // h


def _randn(gen: torch.Generator, shape, scale: float, dt: torch.dtype
           ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dt)


def init_mlstm_block(cfg: ModelConfig, gen: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's shapes and init scales, drawn from ``gen``."""
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    d = cfg.d_model
    d_inner, h, _ = mlstm_dims(cfg)
    k = cfg.xlstm.conv_kernel
    return {
        "w_z": dense_init(gen, (d, d_inner), dt),
        "w_u": dense_init(gen, (d, d_inner), dt),
        "conv_w": _randn(gen, (k, d_inner), 0.1, dt),
        "conv_b": torch.zeros((d_inner,), dtype=dt, device=dev),
        "w_q": dense_init(gen, (d_inner, d_inner), dt),
        "w_k": dense_init(gen, (d_inner, d_inner), dt),
        "w_v": dense_init(gen, (d_inner, d_inner), dt),
        "w_if": dense_init(gen, (d_inner, 2 * h), dt),
        "b_if": torch.cat([
            torch.zeros((h,), device=dev),
            torch.linspace(3.0, 6.0, h, device=dev)]).to(dt),
        "skip": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_norm": torch.ones((d_inner,), dtype=dt, device=dev),
        "w_down": dense_init(gen, (d_inner, d), dt, fan_in=d_inner),
    }


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, H, dv); scale (H*dv,). Per-head RMS normalization in
    fp32, cast back to x's dtype."""
    b, s, h, dv = x.shape
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf.reshape(b, s, h * dv) * scale.float()).to(x.dtype)


def mlstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                initial_state: Optional[Tuple] = None,
                return_state: bool = False):
    """x (B, S, d) -> y (B, S, d) [, (conv_tail, (C, n, m))]. The
    residual is added by the caller.

    The scan runs with ``impl="kernel"`` when ``cfg.attention_impl ==
    "kernel"`` (the CUDA mLSTM kernels for CUDA tensors, their plain
    versions for CPU tensors) and ``impl="reference"`` otherwise. This
    is where the port differs from the JAX package, whose
    ``mlstm_block`` pins the scan to ``"reference"`` whatever the config
    says, in serving and in training alike: JAX differentiates
    ``ref.mlstm_chunked``, and here a gradient through the kernel path
    runs ``MLSTMScanFn``, whose backward is the mLSTM backward kernel.
    The block runs under autograd (training drops the final state, so
    the backward takes its cotangent as 0). The kernel starts from zero
    state, as prefill and training do; with an ``initial_state`` only
    the reference scan runs (``attention_impl="reference"``)."""
    b, s, _ = x.shape
    _, h, dk = mlstm_dims(cfg)
    cdt = cfg.compute_dtype

    z = x @ _cast(params["w_z"], cdt)
    u = x @ _cast(params["w_u"], cdt)
    conv_init = initial_state[0] if initial_state is not None else None
    c, conv_tail = _causal_conv(u, params["conv_w"], params["conv_b"],
                                conv_init)
    c = F.silu(c)
    q = (c @ _cast(params["w_q"], cdt)).reshape(b, s, h, dk)
    k = (c @ _cast(params["w_k"], cdt)).reshape(b, s, h, dk)
    v = (u @ _cast(params["w_v"], cdt)).reshape(b, s, h, dk)
    gates = c @ _cast(params["w_if"], cdt) + _cast(params["b_if"], cdt)
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    cell_init = initial_state[1] if initial_state is not None else None
    hseq, final = mlstm_ops.mlstm_scan(
        q, k, v, i_pre.float(), f_pre.float(), initial_state=cell_init,
        impl="kernel" if cfg.attention_impl == "kernel" else "reference")
    hn = _headwise_rmsnorm(hseq, params["out_norm"])
    hn = hn + _cast(params["skip"], cdt) * c
    hn = hn * F.silu(z)
    out = hn @ _cast(params["w_down"], cdt)
    if return_state:
        return out, (conv_tail, final)
    return out


def mlstm_block_decode(params, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token decode. x (B, 1, d); state (conv_tail, (C, n, m)).
    Returns (y (B, 1, d), the new state)."""
    b = x.shape[0]
    _, h, dk = mlstm_dims(cfg)
    cdt = cfg.compute_dtype
    conv_state, cell = state

    z = x[:, 0] @ _cast(params["w_z"], cdt)
    u = x[:, 0] @ _cast(params["w_u"], cdt)
    # the conv over the (K-1) carried inputs and this one, and the silu,
    # in fp32; then the cast to the compute dtype
    window = torch.cat([conv_state, u[:, None, :]], dim=1)
    new_conv = window[:, 1:, :]
    w = params["conv_w"].float()
    c = (window.float() * w[None]).sum(dim=1) + params["conv_b"].float()
    c = F.silu(c).to(dtype_of(cdt))
    q = (c @ _cast(params["w_q"], cdt)).reshape(b, h, dk)
    k = (c @ _cast(params["w_k"], cdt)).reshape(b, h, dk)
    v = (u @ _cast(params["w_v"], cdt)).reshape(b, h, dk)
    gates = c @ _cast(params["w_if"], cdt) + _cast(params["b_if"], cdt)
    i_pre, f_pre = gates[..., :h], gates[..., h:]
    hvec, new_cell = mlstm_ops.mlstm_decode_step(
        cell, q, k, v, i_pre.float(), f_pre.float())
    hn = _headwise_rmsnorm(hvec[:, None].to(dtype_of(cdt)),
                           params["out_norm"])[:, 0]
    hn = hn + _cast(params["skip"], cdt) * c
    hn = hn * F.silu(z)
    out = (hn @ _cast(params["w_down"], cdt))[:, None, :]
    return out, (new_conv, new_cell)


def init_mlstm_state(cfg: ModelConfig, batch: int, device):
    d_inner, h, dk = mlstm_dims(cfg)
    k = cfg.xlstm.conv_kernel
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, k - 1, d_inner),
                        dtype=dtype_of(cfg.compute_dtype), device=device),
            (torch.zeros((batch, h, dk, dk), **f32),
             torch.zeros((batch, h, dk), **f32),
             torch.full((batch, h), NEG_BIG, **f32)))


# --------------------------------------------------------------------------
# sLSTM block
# --------------------------------------------------------------------------


def slstm_ff(cfg: ModelConfig) -> int:
    return int(cfg.xlstm.proj_factor_slstm * cfg.d_model)


def init_slstm_block(cfg: ModelConfig, gen: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's shapes and init scales, drawn from ``gen``."""
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    d = cfg.d_model
    h = cfg.xlstm.num_heads
    dh = d // h
    k = cfg.xlstm.conv_kernel
    ff = slstm_ff(cfg)
    return {
        "conv_w": _randn(gen, (k, d), 0.1, dt),
        "conv_b": torch.zeros((d,), dtype=dt, device=dev),
        "w_ifzo": dense_init(gen, (d, 4 * d), dt),
        # block-diagonal per-head recurrent weights (H, dh, 4*dh)
        "r_ifzo": _randn(gen, (h, dh, 4 * dh), dh ** -0.5, dt),
        "b_ifzo": torch.cat([
            torch.zeros((d,), device=dev),
            torch.linspace(3.0, 6.0, d, device=dev),
            torch.zeros((2 * d,), device=dev)]).to(dt),
        "out_norm": torch.ones((d,), dtype=dt, device=dev),
        "ffn_gate": dense_init(gen, (d, ff), dt),
        "ffn_up": dense_init(gen, (d, ff), dt),
        "ffn_down": dense_init(gen, (ff, d), dt, fan_in=ff),
    }


def _slstm_cell(carry, gates_x: torch.Tensor, r_ifzo: torch.Tensor,
                floor: Optional[torch.Tensor] = None):
    """One sLSTM time step. gates_x (B, 4d) pre-activations from the
    input; carry (c, n, m, h) each (B, d); ``floor`` the normalizer's
    floor 1e-6 as a 0-dim tensor on the device (made here if not given).
    Returns (new carry, h)."""
    c, n, m, hprev = carry
    b, d = c.shape
    nh, dh = r_ifzo.shape[0], r_ifzo.shape[1]
    # the recurrent contribution, block-diagonal over heads
    rec = torch.einsum("bhd,hdf->bhf", hprev.reshape(b, nh, dh),
                       r_ifzo).reshape(b, 4 * d)
    it, ft, zt, ot = (gates_x + rec).chunk(4, dim=-1)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(lf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(zt)
    n_new = f_g * n + i_g
    # torch.maximum, as JAX's jnp.maximum, splits a tie's gradient
    # evenly (torch.clamp gives it all to n_new)
    if floor is None:
        floor = n_new.new_full((), 1e-6)
    h_new = torch.sigmoid(ot) * c_new / torch.maximum(n_new, floor)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_gates(params, xconv: torch.Tensor, x_raw: torch.Tensor,
                 d: int) -> torch.Tensor:
    """The input pre-activations in fp32: i and f see the conv path, z
    and o the raw path (xLSTM paper)."""
    wz = _cast(params["w_ifzo"], "float32")
    gx = torch.cat([xconv @ wz[:, :2 * d], x_raw @ wz[:, 2 * d:]], dim=-1)
    return gx + params["b_ifzo"].float()


def _slstm_scan(params, xconv: torch.Tensor, x_raw: torch.Tensor,
                cfg: ModelConfig, initial=None):
    """xconv/x_raw (B, S, d) fp32 -> h (B, S, d), the final carry: the
    recurrence token by token (a Python loop: no kernel, as the JAX
    package has none; on the card each step is ~20 small launches)."""
    b, s, d = xconv.shape
    gx = _slstm_gates(params, xconv, x_raw, d)
    r = params["r_ifzo"].float()
    if initial is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=xconv.device)
        initial = (zeros, zeros, torch.full_like(zeros, NEG_BIG), zeros)
    carry, hs = initial, []
    floor = gx.new_full((), 1e-6)       # one constant for the whole loop
    for t in range(s):
        carry, h_t = _slstm_cell(carry, gx[:, t], r, floor)
        hs.append(h_t)
    return torch.stack(hs, dim=1), carry


def _slstm_out(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS-normalize h in fp32, cast to the compute dtype, then the gated
    FFN (proj factor 4/3)."""
    cdt = cfg.compute_dtype
    hf = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-5)
    hn = (hf * params["out_norm"].float()).to(dtype_of(cdt))
    g = hn @ _cast(params["ffn_gate"], cdt)
    u = hn @ _cast(params["ffn_up"], cdt)
    return (F.silu(g) * u) @ _cast(params["ffn_down"], cdt)


def slstm_block(params, x: torch.Tensor, cfg: ModelConfig,
                initial_state: Optional[Tuple] = None,
                return_state: bool = False):
    """x (B, S, d) -> y (B, S, d) [, (conv_tail, (c, n, m, h))]. The
    residual is added by the caller."""
    conv_init = initial_state[0] if initial_state is not None else None
    xc, conv_tail = _causal_conv(x, params["conv_w"], params["conv_b"],
                                 conv_init)
    xc = F.silu(xc)
    cell_init = initial_state[1] if initial_state is not None else None
    hs, final = _slstm_scan(params, xc.float(), x.float(), cfg, cell_init)
    out = _slstm_out(params, hs, cfg)
    if return_state:
        return out, (conv_tail, final)
    return out


def slstm_block_decode(params, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token decode. x (B, 1, d); state (conv_tail, (c, n, m, h)).
    The conv and its silu run in fp32 (no cast, as in the JAX package)."""
    d = cfg.d_model
    conv_state, cell = state
    window = torch.cat([conv_state, x], dim=1)
    new_conv = window[:, 1:, :]
    w = params["conv_w"].float()
    xc = (window.float() * w[None]).sum(dim=1) + params["conv_b"].float()
    xc = F.silu(xc)
    gx = _slstm_gates(params, xc, x[:, 0].float(), d)
    new_cell, h_new = _slstm_cell(cell, gx, params["r_ifzo"].float())
    return _slstm_out(params, h_new, cfg)[:, None, :], (new_conv, new_cell)


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    d = cfg.d_model
    k = cfg.xlstm.conv_kernel
    zeros = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (torch.zeros((batch, k - 1, d), dtype=dtype_of(cfg.compute_dtype),
                        device=device),
            (zeros, zeros.clone(), torch.full_like(zeros, NEG_BIG),
             zeros.clone()))
