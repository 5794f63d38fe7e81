"""Carry JAX parameters over to the port.

The port keeps the JAX weight layout: every projection is ``(in, out)``
and is applied as ``x @ W`` (``wq`` (d, H*Dh), ``wo`` (H*Dh, d),
``w_down`` (d_ff, d), ``lm_head`` (d, V), ``embed`` (V, d)). So the
conversion copies each array as it is, with no transpose. The only
change of structure is the layer stack: the JAX package stacks every
``layers`` leaf along a leading (L, ...) axis for ``lax.scan``; the
port keeps a list of per-layer dicts. A tied model has no ``lm_head``
and a non-parametric norm is an empty dict on both sides.
:func:`params_to_numpy` is the inverse, for comparing a port tree with
a JAX tree leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """Map the JAX ``init_params`` tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) to the port's parameters."""
    check_supported(cfg)
    expected = {"embed", "final_norm", "layers"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise ValueError(f"JAX params have keys {sorted(tree)}, expected "
                         f"{sorted(expected)}")
    out: Dict[str, Any] = {
        "embed": _tensor(tree["embed"], device),
        "final_norm": _tree(tree["final_norm"],
                            lambda a: _tensor(a, device)),
    }
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], device)
    def layer(a, i):
        a = np.asarray(a)
        if a.shape[0] != cfg.num_layers:
            raise ValueError(f"stacked layer leaf of shape {a.shape} does "
                             f"not lead with num_layers={cfg.num_layers}")
        return _tensor(a[i], device)

    out["layers"] = [_tree(tree["layers"], lambda a, i=i: layer(a, i))
                     for i in range(cfg.num_layers)]
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree in the JAX layout, leaves as numpy arrays: the
    per-layer list stacked back along a leading (L, ...) axis (an empty
    norm dict stays empty)."""
    def host(t):
        return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()

    out = {k: _tree(v, host) for k, v in params.items() if k != "layers"}
    layers = [_tree(lp, host) for lp in params["layers"]]

    def stack(*leaves):
        return np.stack(leaves)

    def zip_tree(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_tree([t[k] for t in trees]) for k in first}
        return stack(*trees)

    out["layers"] = zip_tree(layers)
    return out
