"""Delayed update (gradient accumulation) with exact weighting
(port of ``repro/core/accumulate.py``).

With per-microbatch objective sums O_i (differentiable) and weight sums
W_i, grad((sum O_i) / (sum W_i)) = (sum grad O_i) / (sum W_i), so
accumulating grad-of-sums and weights separately and dividing once is
exact (up to fp reassociation) for any capacity mix. The JAX package
scans over microbatches; here it is a Python loop with the same add
order and fp32 accumulators.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import weighting
from repro_torch.models.transformer import tree_leaves, tree_map


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict,
                   **loss_kwargs) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                           Any]:
    """``jax.value_and_grad(obj, has_aux=True)`` of ``obj = (objective_sum,
    weight_sum)``: returns ((o, w), grad tree of o w.r.t. params). The
    params are used through fresh detached leaves (no copy), so the
    caller's tensors are not marked as requiring grad."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        o, w, _ = loss_fn(leaves, batch, **loss_kwargs)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(o, flat)
    it = iter(grads)
    return (o.detach(), w.detach()), tree_map(lambda _: next(it), leaves)


def accumulate_sums(grad_fn: Callable, params: Any, microbatches: Dict
                    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """The shared accumulation core: UNSCALED sums. ``grad_fn(params, mb)
    -> ((obj_sum, weight_sum), grads)``; loops over the leading
    (accum) dim of ``microbatches`` and returns ``(grad_of_sums,
    obj_sum, weight_sum)`` without the final division. Accumulators are
    fp32, except for bf16 params (a bf16 carry, as the JAX step does);
    one microbatch returns its sums as they are, with no accumulator."""
    accum = next(iter(microbatches.values())).shape[0]
    if accum == 1:
        (o, w), g = grad_fn(params, {k: v[0] for k, v in
                                     microbatches.items()})
        return g, o, w
    g_acc = tree_map(
        lambda p: torch.zeros(p.shape, device=p.device,
                              dtype=p.dtype if p.dtype == torch.bfloat16
                              else torch.float32), params)
    o_acc = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    w_acc = torch.zeros_like(o_acc)
    for i in range(accum):
        mb = {k: v[i] for k, v in microbatches.items()}
        (o, w), g = grad_fn(params, mb)
        g_acc = tree_map(lambda a, b: a.add_(b.to(a.dtype)), g_acc, g)
        del g
        o_acc = o_acc + o
        w_acc = w_acc + w
    return g_acc, o_acc, w_acc


def accumulate_grads(loss_fn: Callable, params: Any, microbatches: Dict,
                     **loss_kwargs) -> Tuple[Any, torch.Tensor,
                                             torch.Tensor]:
    """Loop over stacked microbatches; returns (grads, loss, weight_sum)
    with grads of the weighted-mean loss over all real tokens, divided by
    the summed weight once (``weighting.finalize``/``scale_grads``, the
    train step's rule). The sums are divided in place: one gradient tree
    is held, not two."""
    def grad_fn(p, mb):
        return value_and_grad(loss_fn, p, mb, **loss_kwargs)

    g_sum, o_sum, w_sum = accumulate_sums(grad_fn, params, microbatches)
    inv = 1.0 / torch.clamp(w_sum, min=1e-9)
    return (tree_map(lambda g: g.mul_(inv.to(g.dtype)), g_sum),
            weighting.finalize(o_sum, w_sum), w_sum)


def split_microbatches(batch: Dict[str, torch.Tensor], accum_steps: int,
                       num_ranks: int = 1) -> Dict[str, torch.Tensor]:
    """(R*B, ...) -> (accum, R*B/accum, ...), preserving rank locality:
    every microbatch takes an equal slice of EVERY rank's buffer,
    (R, B, ...) -> (R, accum, B/accum, ...) -> (accum, R * B/accum, ...).
    Requires buffer_rows % accum == 0."""
    def split(a):
        n = a.shape[0]
        if n % (accum_steps * num_ranks):
            raise ValueError(
                f"rows {n} not divisible by accum {accum_steps} "
                f"x ranks {num_ranks}")
        b = n // num_ranks
        a = a.reshape(num_ranks, accum_steps, b // accum_steps,
                      *a.shape[1:])
        a = a.transpose(0, 1)
        return a.reshape(accum_steps, num_ranks * (b // accum_steps),
                         *a.shape[3:])

    return {k: split(v) for k, v in batch.items()}
