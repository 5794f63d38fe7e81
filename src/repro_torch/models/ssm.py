"""Mamba2 (SSD) block, used by zamba2 (port of ``repro/models/ssm.py``).

Structure follows the Mamba2 reference: fused in_proj producing [z, x,
B, C, dt], causal depthwise conv over [x, B, C], softplus dt with bias,
the SSD chunked scan (``kernels/ssd_scan``), gated RMSNorm, out_proj.

State for decode: (conv_state (B, K-1, conv_ch) in the compute dtype,
the pre-conv inputs; ssm_state (B, H, P, N) in the compute dtype, as
the JAX package stores it: decode upcasts it to fp32, updates it and
casts it back).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.blocks import (_cast, dense_init, dtype_of,
                                       rms_norm_gated)


def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + nheads
    return d_inner, nheads, conv_ch, d_in_proj


def init_mamba(cfg: ModelConfig, gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """The JAX package's shapes and init scales, drawn from ``gen``."""
    dt = dtype_of(cfg.param_dtype)
    s = cfg.ssm
    dev = gen.device
    d_inner, nheads, conv_ch, d_in_proj = mamba_dims(cfg)
    in_proj = dense_init(gen, (cfg.d_model, d_in_proj), dt)
    conv_w = (torch.randn((s.conv_kernel, conv_ch), generator=gen,
                          device=dev, dtype=torch.float32) * 0.1).to(dt)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 init)
    u = torch.rand((nheads,), generator=gen, device=dev,
                   dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inv softplus
    out_proj = dense_init(gen, (d_inner, cfg.d_model), dt, fan_in=d_inner)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=dev)).to(dt),
        "D": torch.ones((nheads,), dtype=dt, device=dev),
        "dt_bias": dt_bias.to(dt),
        "norm": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, C); w (K, C). Returns (y, tail).

    ``init`` is the (B, K-1, C) left context of an earlier segment; tail
    is the new left context, the last K-1 inputs (pre-conv, x's dtype).
    The JAX package's ``conv_general_dilated`` with a ``WIO`` kernel is a
    cross-correlation in fp32, y[t] = sum_k xp[t + k] w[k], plus the
    bias in fp32, then a cast; it is written here as that sum over the K
    taps in fp32, which on the card also keeps it off cuDNN's TF32
    convolution."""
    bsz, s, c = x.shape
    k = w.shape[0]
    if init is None:
        init = torch.zeros((bsz, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([init, x], dim=1)                   # (B, S+K-1, C)
    tail = (xp[:, -(k - 1):, :] if k > 1
            else torch.zeros((bsz, 0, c), dtype=x.dtype, device=x.device))
    wf = w.float()
    y = xp[:, 0:s].float() * wf[0]
    for j in range(1, k):
        y = y + xp[:, j:j + s].float() * wf[j]
    y = y + b.float()[None, None, :]
    return y.to(x.dtype), tail


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, _, conv_ch, _ = mamba_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt


def _split_xbc(xBC: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner = mamba_dims(cfg)[0]
    gn = s.ngroups * s.state_dim
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + gn]
    Cm = xBC[..., d_inner + gn:]
    return x, Bm, Cm


def _dt_and_A(params, dt: torch.Tensor):
    # torch's softplus returns x itself above threshold=20 where
    # jax.nn.softplus computes log1p(exp(x)); they differ by < 1e-8 there
    dtv = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return dtv, A


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig,
                initial_state: Optional[Tuple] = None,
                return_state: bool = False):
    """x (B, S, d_model) -> y (B, S, d_model) [, (conv_state, ssm_state)].

    The scan runs with ``impl="kernel"`` when ``cfg.attention_impl ==
    "kernel"`` (the CUDA SSD kernels for CUDA tensors, their plain
    versions for CPU tensors) and ``impl="reference"`` otherwise. This
    is where the port differs from the JAX package, whose
    ``mamba_block`` pins the scan to ``"reference"`` whatever the config
    says, in serving and in training alike: JAX differentiates
    ``ref.ssd_chunked``, and here a gradient through the kernel path
    runs ``SSDScanFn``, whose backward is the SSD backward kernel. The
    block runs under autograd (training drops the final state, so the
    backward takes its cotangent as 0). The kernel starts from zero
    state, as prefill and training do; with an ``initial_state`` only
    the reference scan runs (``attention_impl="reference"``)."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    d_inner, nheads, _, _ = mamba_dims(cfg)
    cdt = cfg.compute_dtype

    zxbcdt = x @ _cast(params["in_proj"], cdt)
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)
    conv_init = initial_state[0] if initial_state is not None else None
    xBC, conv_tail = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                  conv_init)
    xBC = F.silu(xBC)
    xs, Bm, Cm = _split_xbc(xBC, cfg)
    xs = xs.reshape(bsz, seq, nheads, s.head_dim)
    Bm = Bm.reshape(bsz, seq, s.ngroups, s.state_dim)
    Cm = Cm.reshape(bsz, seq, s.ngroups, s.state_dim)
    dtv, A = _dt_and_A(params, dt)
    ssm_init = initial_state[1] if initial_state is not None else None
    y, final = ssd_ops.ssd_scan(
        xs, dtv, A, Bm, Cm, params["D"].float(),
        chunk_size=s.chunk_size, initial_state=ssm_init,
        impl="kernel" if cfg.attention_impl == "kernel" else "reference")
    y = y.reshape(bsz, seq, d_inner)
    y = rms_norm_gated(y, z, params["norm"])
    out = y @ _cast(params["out_proj"], cdt)
    if return_state:
        return out, (conv_tail, final.to(dtype_of(cdt)))
    return out


def mamba_decode_step(params, x: torch.Tensor, cfg: ModelConfig,
                      state: Tuple[torch.Tensor, torch.Tensor]):
    """One-token decode. x (B, 1, d); state (conv (B, K-1, C), ssm (B, H,
    P, N)), both in the compute dtype. Returns (y (B, 1, d), new
    state)."""
    s = cfg.ssm
    bsz = x.shape[0]
    d_inner, nheads, _, _ = mamba_dims(cfg)
    cdt = cfg.compute_dtype
    conv_state, ssm_state = state

    zxbcdt = x[:, 0, :] @ _cast(params["in_proj"], cdt)      # (B, dproj)
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)
    # conv over the (K-1) carried inputs + the current one, in fp32;
    # silu, then the cast to the compute dtype before the split
    window = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B, K, C)
    new_conv = window[:, 1:, :]
    w = params["conv_w"].float()                               # (K, C)
    xBC = (window.float() * w[None]).sum(dim=1) + params["conv_b"].float()
    xBC = F.silu(xBC).to(dtype_of(cdt))
    xs, Bm, Cm = _split_xbc(xBC, cfg)
    xs = xs.reshape(bsz, nheads, s.head_dim)
    Bm = Bm.reshape(bsz, s.ngroups, s.state_dim)
    Cm = Cm.reshape(bsz, s.ngroups, s.state_dim)
    dtv, A = _dt_and_A(params, dt)
    y, ssm_new = ssd_ops.ssd_decode_step(
        ssm_state.float(), xs, dtv, A, Bm, Cm, params["D"].float())
    y = y.reshape(bsz, d_inner)
    y = rms_norm_gated(y, z, params["norm"])
    out = (y @ _cast(params["out_proj"], cdt))[:, None, :]
    return out, (new_conv, ssm_new.to(dtype_of(cdt)))
