"""AdamW on parameter trees and on the packed bucket stack
(port of ``repro/optim/adam.py``).

Moment dtypes follow ``OptimizerConfig.m_dtype``/``v_dtype``; all math
is fp32 whatever the storage dtype. Weight decay applies to matrices
only, judged by the JAX package's leaf: a leaf of the layer stack is the
stacked (L, ...) array, so a per-layer vector (a norm scale) is a
matrix there and decays; an empty norm dict has no leaf, so it takes no
part. Unlike the JAX package's pure function, :func:`apply_update`
writes the new parameters and moments into the existing tensors (one
copy of the model's state on the card instead of two) and returns them;
it runs the elementwise math a block of leading-dim rows at a time
(:data:`UPDATE_CHUNK` elements) with the clip factor applied there, so
its fp32 temporaries stay bounded whatever a leaf's size (a deepseek-v2
expert stack is 1.26 B elements) and the gradient tree is not copied.

Flat-view path (``HetConfig.overlap`` in {"buckets", "backward"}):
:func:`apply_update_flat` runs the same elementwise math on packed
(num_buckets, bucket_elems) views of the parameters and moments (one
bucket inside the fused exchange pipeline, or the whole stack behind
the clip barrier), the decay rule travelling as the packed int8
``decay_mask`` (``core/buckets.py::bucket_decay_mask``); :func:`init_state_flat` builds the moments packed. With
``grad_clip == 0`` in fp32 it is bitwise the tree update.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.buckets import stream_leaves
from repro_torch.models.blocks import dtype_of
from repro_torch.models.transformer import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor             # () int32
    m: Any                         # tree like params, or a packed stack
    v: Any


def init_state(params: Any, cfg: OptimizerConfig) -> AdamState:
    def zeros(dt):
        return lambda p: torch.zeros(p.shape, dtype=dtype_of(dt),
                                     device=p.device)

    device = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree_map(zeros(cfg.m_dtype), params),
                     v=tree_map(zeros(cfg.v_dtype), params))


def init_state_flat(num_buckets: int, bucket_elems: int,
                    cfg: OptimizerConfig,
                    device: torch.device | str = "cpu") -> AdamState:
    """Zero moments in the packed (num_buckets, bucket_elems) layout."""
    def zeros(dt):
        return torch.zeros((num_buckets, bucket_elems), dtype=dtype_of(dt),
                           device=device)

    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=zeros(cfg.m_dtype), v=zeros(cfg.v_dtype))


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
    return tree_map(lambda g: g * clip_scale(norm, max_norm).to(g.dtype),
                    grads), norm


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The global-norm clip factor, min(1, max_norm / norm)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def moments(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
            p: torch.Tensor, cfg: OptimizerConfig, bc1: torch.Tensor,
            bc2: torch.Tensor, decay: Any
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The elementwise AdamW math shared by every path: returns (pf,
    update, mf, vf) in fp32. ``decay``: True / False (a tree leaf) or
    the int8 mask of a packed view (multiplied in, as the JAX package's
    flat path does)."""
    b1, b2 = cfg.betas
    gf = g.float()
    mf = m.float() * b1 + gf * (1.0 - b1)
    vf = v.float() * b2 + gf * gf * (1.0 - b2)
    update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
    pf = p.float()
    if cfg.weight_decay > 0:
        if isinstance(decay, torch.Tensor):
            update = update + cfg.weight_decay * decay.float() * pf
        elif decay:                             # decay matrices only
            update = update + cfg.weight_decay * pf
    return pf, update, mf, vf


# elements a block of rows of :func:`apply_update`'s elementwise math
# holds at most (a leaf with longer rows takes one row a block): each fp32
# temporary stays at 512 MiB
UPDATE_CHUNK = 1 << 27


def row_blocks(t: torch.Tensor):
    """Indices of ``t``'s leading-dim blocks, each at most
    ``UPDATE_CHUNK`` elements (one row where a row is larger); a small
    or 0-d tensor is one block (``...``)."""
    if t.dim() == 0 or t.numel() <= UPDATE_CHUNK:
        yield ...
        return
    rows = max(1, UPDATE_CHUNK // (t.numel() // t.shape[0]))
    for r in range(0, t.shape[0], rows):
        yield slice(r, r + rows)


def leaf_groups(*trees: Any):
    """(stream shape, per-tree pieces) of every leaf of the JAX
    package's tree: the layer stack's leaves stacked, so a group's
    ``len(shape)`` is the JAX leaf's ``ndim``."""
    streams = [stream_leaves(t) for t in trees]
    for group in zip(*streams):
        yield group[0][0], [pieces for _, pieces in group]


@torch.no_grad()
def apply_update(params: Any, grads: Any, state: AdamState,
                 cfg: OptimizerConfig, lr: torch.Tensor
                 ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state', metrics). The
    values are those of clipping the tree (``clip_by_global_norm``) and
    then updating leaf by leaf; each leaf runs in :func:`row_blocks`."""
    gnorm = global_norm(grads)
    clip = (clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0
            else None)
    step = state.step + 1
    bc1, bc2 = bias_corrections(cfg, step)
    for shape, (ps, gs, ms, vs) in leaf_groups(params, grads, state.m,
                                               state.v):
        for p, g, m, v in zip(ps, gs, ms, vs):
            for r in row_blocks(p):
                gr = g[r] if clip is None else g[r] * clip.to(g.dtype)
                pf, update, mf, vf = moments(gr, m[r], v[r], p[r], cfg, bc1,
                                             bc2, len(shape) >= 2)
                p[r].copy_(pf - lr * update)
                m[r].copy_(mf)
                v[r].copy_(vf)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(step=step, m=state.m, v=state.v), metrics


def flat_adamw_terms(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, step: torch.Tensor,
                     cfg: OptimizerConfig, *, decay_mask: torch.Tensor,
                     clip_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The shared elementwise AdamW math on packed views: (pf, update,
    mf, vf) in fp32; the caller applies its own step rule (AdamW's
    ``pf - lr * update``, LAMB's trust-scaled one). ``step`` is the
    post-increment step; ``clip_scale`` the global-norm clip factor
    (None without clipping)."""
    bc1, bc2 = bias_corrections(cfg, step)
    if clip_scale is not None:
        g = g.float() * clip_scale
    return moments(g, m, v, p, cfg, bc1, bc2, decay_mask)


@torch.no_grad()
def apply_update_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, step: torch.Tensor,
                      cfg: OptimizerConfig, lr: torch.Tensor, *,
                      decay_mask: torch.Tensor,
                      clip_scale: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step on a packed view (any shape, elementwise): one
    bucket or the whole stack, ``decay_mask`` the matching rows of
    :func:`repro_torch.core.buckets.bucket_decay_mask`. Returns new (p', m',
    v') in the storage dtypes (padding stays zero: zero gradients,
    moments and mask)."""
    pf, update, mf, vf = flat_adamw_terms(p, g, m, v, step, cfg,
                                          decay_mask=decay_mask,
                                          clip_scale=clip_scale)
    pf = pf - lr * update
    return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)
