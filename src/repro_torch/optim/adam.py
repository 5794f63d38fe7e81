"""AdamW on parameter trees (port of ``repro/optim/adam.py``, pytree path).

Moment dtypes follow ``OptimizerConfig.m_dtype``/``v_dtype``; all math
is fp32 whatever the storage dtype. Weight decay applies to matrices
only (``ndim >= 2``), as in the JAX package; an empty norm dict has no
leaf, so it takes no part. Unlike the JAX package's pure function,
:func:`apply_update` writes the new parameters and moments into the
existing tensors (one copy of the model's state on the card instead of
two) and returns them. The flat-view path and LAMB come later.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.blocks import dtype_of
from repro_torch.models.transformer import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor             # () int32
    m: Any                         # tree like params
    v: Any


def init_state(params: Any, cfg: OptimizerConfig) -> AdamState:
    def zeros(dt):
        return lambda p: torch.zeros(p.shape, dtype=dtype_of(dt),
                                     device=p.device)

    device = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree_map(zeros(cfg.m_dtype), params),
                     v=tree_map(zeros(cfg.v_dtype), params))


def bias_corrections(cfg: OptimizerConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    b1, b2 = cfg.betas
    sf = step.float()
    return (1.0 - torch.pow(torch.tensor(b1, device=sf.device), sf),
            1.0 - torch.pow(torch.tensor(b2, device=sf.device), sf))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def apply_update(params: Any, grads: Any, state: AdamState,
                 cfg: OptimizerConfig, lr: torch.Tensor
                 ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state', metrics)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    b1, b2 = cfg.betas
    bc1, bc2 = bias_corrections(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        gf = g.float()
        mf = m.float() * b1 + gf * (1.0 - b1)
        vf = v.float() * b2 + gf * gf * (1.0 - b2)
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay > 0 and p.ndim >= 2:    # decay matrices only
            update = update + cfg.weight_decay * pf
        p.copy_(pf - lr * update)
        m.copy_(mf)
        v.copy_(vf)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(step=step, m=state.m, v=state.v), metrics
