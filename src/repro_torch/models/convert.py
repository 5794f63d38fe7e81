"""Carry JAX parameters over to the port.

The port keeps the JAX weight layout: every projection is ``(in, out)``
and is applied as ``x @ W`` (``wq`` (d, H*Dh), ``wo`` (H*Dh, d),
``w_down`` (d_ff, d), ``lm_head`` (d, V), ``embed`` (V, d)). So the
conversion copies each array as it is, with no transpose. The only
change of structure is the layer stack: the JAX package stacks every
``layers`` leaf along a leading (L, ...) axis for ``lax.scan``; the
port keeps a list of per-layer dicts. A tied model on the token
frontend has no ``lm_head``, an embedding-stub model (chameleon,
musicgen) no ``embed``, and a non-parametric norm is an empty dict on
both sides. The GQA ``attn`` dict carries ``q_norm``/``k_norm`` with
QK-norm, LayerNorm dicts their ``bias``, a GELU MLP has no ``w_gate``
and an Arctic MoE layer carries its ``dense`` MLP. Nested layer
dicts (the MLA projections under ``attn``, the MoE ``router``,
``w_gate``/``w_up``/``w_down`` of shape (E, ...) and ``shared`` under
``moe``) are carried over key for key, and so are the Mamba2 layers
(``ln`` and ``mamba``: ``in_proj`` (d, d_in_proj), ``conv_w`` (K, C),
``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm``, ``out_proj``) and
zamba's ``shared_attn`` (``ln1``, ``attn``, ``ln2``, ``mlp``), which is
one dict, not stacked, on both sides. An xLSTM tree has no ``layers``
but two stacks, ``mlstm_layers`` and ``slstm_layers`` (``ln`` and
``blk``), whose leading axis is the num_layers // 2 pairs.
:func:`params_to_numpy` is the inverse, for comparing a port tree with
a JAX tree leaf by leaf (bf16 leaves upcast to fp32);
:func:`params_to_host` is the inverse that keeps every leaf's dtype,
for checkpoints, copying each layer straight into its stacked host
array.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (check_supported, stack_plan,
                                            tied_head)


def _tensor(x, device) -> torch.Tensor:
    """A copy of ``x`` on ``device``: one host copy on the CPU, one
    host-to-device copy on a card."""
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device, copy=True)


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """Map the JAX ``init_params`` tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) to the port's parameters."""
    check_supported(cfg, serving=True)
    plan = stack_plan(cfg)
    stacks = ({"mlstm_layers": cfg.num_layers // 2,
               "slstm_layers": cfg.num_layers // 2} if plan == "xlstm"
              else {"layers": cfg.num_layers})
    expected = {"final_norm", *stacks}
    if cfg.frontend == "token":
        expected.add("embed")
    if not tied_head(cfg):
        expected.add("lm_head")
    if plan == "zamba":
        expected.add("shared_attn")
    if set(tree) != expected:
        raise ValueError(f"JAX params have keys {sorted(tree)}, expected "
                         f"{sorted(expected)}")
    out: Dict[str, Any] = {}
    if "embed" in tree:
        out["embed"] = _tensor(tree["embed"], device)
    out["final_norm"] = _tree(tree["final_norm"],
                              lambda a: _tensor(a, device))
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], device)

    def layer(a, i, n):
        a = np.asarray(a)
        if a.shape[0] != n:
            raise ValueError(f"stacked layer leaf of shape {a.shape} does "
                             f"not lead with {n} (num_layers="
                             f"{cfg.num_layers})")
        return _tensor(a[i], device)

    for name, n in stacks.items():
        out[name] = [_tree(tree[name], lambda a, i=i, n=n: layer(a, i, n))
                     for i in range(n)]
    if "shared_attn" in tree:
        out["shared_attn"] = _tree(tree["shared_attn"],
                                   lambda a: _tensor(a, device))
    return out


def part_from_jax(tree: Dict[str, Any], like: Dict[str, Any], device,
                  first_layer: int = 0) -> Dict[str, Any]:
    """The port's tree shaped like ``like``, a part of a parameter tree
    (some of its top-level keys, its ``layers`` list a run of layers
    from ``first_layer``, as a pipeline stage holds), taken from a whole
    tree in the JAX layout: one host or host-to-device copy of each leaf
    the part holds and of nothing else, each layer a row of its stacked
    leaf."""
    def take(node, ref, row=None):
        if isinstance(ref, dict):
            return {k: take(node[k], v, row) for k, v in ref.items()}
        return _tensor(node if row is None else np.asarray(node)[row],
                       device)

    return {key: ([take(tree[key], ref, first_layer + i)
                   for i, ref in enumerate(sub)]
                  if isinstance(sub, list) else take(tree[key], sub))
            for key, sub in like.items()}


def to_jax_layout(params: Dict[str, Any], host, stack) -> Dict[str, Any]:
    """The port's tree in the JAX layout: ``host(t)`` of each leaf
    outside the per-layer lists, ``stack(ts)`` of each leaf's L layer
    tensors inside them (dict keys as the port's)."""
    out = {k: _tree(v, host) for k, v in params.items()
           if not isinstance(v, list)}

    def zip_tree(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_tree([t[k] for t in trees]) for k in first}
        return stack(trees)

    for k, v in params.items():
        if isinstance(v, list):
            out[k] = zip_tree(v)
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree in the JAX layout, leaves as numpy arrays: each
    per-layer list (``layers``, or xLSTM's ``mlstm_layers`` and
    ``slstm_layers``) stacked back along a leading axis (an empty norm
    dict stays empty; ``shared_attn`` stays one dict)."""
    def host(t):
        return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()

    return to_jax_layout(params, host,
                          lambda ts: np.stack([host(t) for t in ts]))


def _host_dtype(t: torch.Tensor) -> torch.dtype:
    if t.dtype == torch.bfloat16:
        raise ValueError(
            "a bfloat16 leaf has no numpy dtype, and the npz format of "
            "checkpoints stores none: keep param_dtype, m_dtype and "
            "v_dtype float32 to checkpoint")
    return t.dtype


def params_to_host(params: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`params_to_numpy` for checkpoints: every leaf a fresh host
    copy in its own dtype (a bfloat16 leaf raises), each layer copied
    straight into its slice of the stacked array."""
    def host(t):
        return t.detach().to("cpu", dtype=_host_dtype(t),
                             copy=True).numpy()

    def stack(ts):
        out = torch.empty((len(ts), *ts[0].shape), dtype=_host_dtype(ts[0]))
        for i, t in enumerate(ts):
            out[i].copy_(t.detach())
        return out.numpy()

    return to_jax_layout(params, host, stack)
