"""Weighted loss/gradient aggregation, the HetSeq invariant
(port of ``repro/core/weighting.py``).

The paper's master process computes ``sum_i(loss_i * w_i) / sum_i(w_i)``
over workers; gradients are averaged the same way. The invariant: for
ANY split of a global batch across R workers with arbitrary per-worker
counts (including zero => dummy rows, weight 0), the aggregate equals
the gradient of the single-process loss over the union of real rows.
:func:`psum_weighted` and :func:`weighted_grad_psum` aggregate across
the ranks of a process group (``core/comm.py``).

The order-canonical aggregation (``HetConfig.weighting="canonical"``,
``launch/steps.py::canonical_backward``) evaluates every row as its own
one-row batch and sums the per-row values in global-row order with one
fixed left :func:`fold`, so the result does not depend on which rank
held a row. It folds one row at a time into one fp32 accumulator (the
JAX package's ``per_row_values`` holds every row's gradient, which a
full-width model cannot: 4.7 GB a row at olmo-1b).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core import accumulate
from repro_torch.core.comm import Comm
from repro_torch.models.transformer import tree_map


def finalize(objective_sum: torch.Tensor, weight_sum: torch.Tensor
             ) -> torch.Tensor:
    """Global weighted mean from (already summed) sums."""
    return objective_sum / torch.clamp(weight_sum, min=1e-9)


def scale_grads(grads: Any, weight_sum: torch.Tensor) -> Any:
    """Divide a gradient-of-sums tree by the total weight, once."""
    inv = 1.0 / torch.clamp(weight_sum, min=1e-9)
    return tree_map(lambda g: g * inv.to(g.dtype), grads)


def fold(rows: Sequence[Any]) -> Any:
    """``rows[0] + rows[1] + ...`` left to right: the canonical fold."""
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


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


def psum_weighted(value: torch.Tensor, weight: torch.Tensor, comm: Comm
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit HetSeq aggregation over ``comm``'s ranks: (weighted mean,
    total weight). ``value`` is this rank's *sum* (loss sum or
    grad-of-sum), ``weight`` its weight sum; a rank of dummy rows only
    adds weight 0 and still takes part. One all-reduce carries both."""
    both = torch.stack([value.float(), weight.float()])
    comm.all_reduce(both)
    return finalize(both[0], both[1]), both[1]


def weighted_grad_psum(grads: Any, weight: torch.Tensor, comm: Comm) -> Any:
    """The tree version for gradients: each leaf summed over the ranks
    and divided by the total weight, in place (the leaves are the
    caller's gradient-of-sums, written over)."""
    total_w = comm.all_reduce(weight.float().clone())
    inv = 1.0 / torch.clamp(total_w, min=1e-9)
    return tree_map(lambda g: comm.all_reduce(g).mul_(inv.to(g.dtype)),
                    grads)
