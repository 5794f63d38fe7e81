"""Weighted loss/gradient aggregation, the HetSeq invariant
(port of ``repro/core/weighting.py``, single process).

The paper's master process computes ``sum_i(loss_i * w_i) / sum_i(w_i)``
over workers; gradients are averaged the same way. The invariant: for
ANY split of a global batch across R workers with arbitrary per-worker
counts (including zero => dummy rows, weight 0), the aggregate equals
the gradient of the single-process loss over the union of real rows.
The cross-rank ``psum_*`` helpers and the canonical executor come with
the multi-rank slice.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core import accumulate
from repro_torch.models.transformer import tree_map


def finalize(objective_sum: torch.Tensor, weight_sum: torch.Tensor
             ) -> torch.Tensor:
    """Global weighted mean from (already summed) sums."""
    return objective_sum / torch.clamp(weight_sum, min=1e-9)


def scale_grads(grads: Any, weight_sum: torch.Tensor) -> Any:
    """Divide a gradient-of-sums tree by the total weight, once."""
    inv = 1.0 / torch.clamp(weight_sum, min=1e-9)
    return tree_map(lambda g: g * inv.to(g.dtype), grads)


def simulate_workers(loss_fn, params, worker_batches: Sequence[Dict]
                     ) -> Tuple[torch.Tensor, Any]:
    """Reference het-DP executor (no process group): runs each worker's
    batch through ``loss_fn`` in turn and aggregates with the HetSeq
    rule. Empty workers (all weights 0) still execute, the paper's
    dummy-batch path. Returns (loss, grads) that must equal
    single-process training on the union of all real rows."""
    total_obj = None
    total_w = None
    grads_sum = None
    for b in worker_batches:
        (o, w), g = accumulate.value_and_grad(loss_fn, params, b)
        total_obj = o if total_obj is None else total_obj + o
        total_w = w if total_w is None else total_w + w
        grads_sum = g if grads_sum is None else tree_map(
            torch.add, grads_sum, g)
    return finalize(total_obj, total_w), scale_grads(grads_sum, total_w)
