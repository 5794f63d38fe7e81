"""LAMB, layerwise adaptive large-batch optimization (You et al. 2019)
(port of ``repro/optim/lamb.py``).

    p <- p - lr * phi(||p||) / ||update|| * update,
    update = m_hat / (sqrt(v_hat) + eps) + wd * p

The trust ratio is per leaf of the JAX package's tree (the layer
stack's leaves stacked: one ratio per stacked (L, ...) leaf), 1.0 where
either norm is 0. The state is :class:`repro_torch.optim.adam.AdamState`
and the metrics add ``trust_ratio``, the mean over the leaves.

Flat-view path (``HetConfig.overlap``): everything but the final
trust-scaled step is elementwise, so the train step
(``launch/steps.py::FlatUpdate``) runs AdamW's moment math on each
bucket (``adam.flat_adamw_terms``), keeps the bucket's per-leaf
squared-norm partials (:func:`bucket_norm_terms`), and after the last
bucket folds the partials in bucket-index order
(``core/weighting.py::fold``) and applies the ratios in one trailing
pass (:func:`apply_trust`), whether the buckets landed one by one or
all behind the clip barrier. A bucket's leaves are given as runs
(``core/buckets.py::bucket_runs``), each summed by one reduction: the
sums are deterministic on the card, where a scatter-add is not.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim import adam

Runs = Sequence[Tuple[int, int, int]]


@torch.no_grad()
def apply_update(params: Any, grads: Any, state: adam.AdamState,
                 cfg: OptimizerConfig, lr: torch.Tensor
                 ) -> Tuple[Any, adam.AdamState, Dict[str, torch.Tensor]]:
    """One LAMB step on parameter trees, in place (state-compatible with
    AdamW). Returns (params, state', metrics)."""
    if cfg.grad_clip > 0:
        grads, gnorm = adam.clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = adam.global_norm(grads)
    step = state.step + 1
    bc1, bc2 = adam.bias_corrections(cfg, step)
    trusts = []
    for shape, (ps, gs, ms, vs) in adam.leaf_groups(params, grads, state.m,
                                                    state.v):
        terms = []
        for p, g, m, v in zip(ps, gs, ms, vs):
            pf, update, mf, vf = adam.moments(g, m, v, p, cfg, bc1, bc2,
                                              len(shape) >= 2)
            m.copy_(mf)
            v.copy_(vf)
            terms.append((pf, update))
        p_ssq = sum(torch.sum(torch.square(pf)) for pf, _ in terms)
        u_ssq = sum(torch.sum(torch.square(u)) for _, u in terms)
        trust = trust_from_norms(p_ssq, u_ssq)
        for p, (pf, update) in zip(ps, terms):
            p.copy_(pf - lr * trust * update)
        trusts.append(trust)
    metrics = {"grad_norm": gnorm, "lr": lr,
               "trust_ratio": torch.mean(torch.stack(trusts))}
    return params, adam.AdamState(step=step, m=state.m, v=state.v), metrics


def bucket_norm_terms(pf: torch.Tensor, update: torch.Tensor, runs: Runs,
                      num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE bucket's per-leaf squared-norm partials: (p_ssq, u_ssq), each
    (num_leaves + 1,), element ``i`` this bucket's share of leaf i's
    squared norm (index ``num_leaves``: the zero padding). ``pf`` and
    ``update`` are (bucket_elems,) fp32."""
    p_ssq = torch.zeros(num_leaves + 1, dtype=torch.float32,
                        device=pf.device)
    u_ssq = torch.zeros_like(p_ssq)
    for lo, hi, i in runs:
        p_ssq[i] = torch.sum(torch.square(pf[lo:hi]))
        u_ssq[i] = torch.sum(torch.square(update[lo:hi]))
    return p_ssq, u_ssq


def trust_from_norms(p_ssq: torch.Tensor, u_ssq: torch.Tensor
                     ) -> torch.Tensor:
    """Trust ratios from squared norms (1.0 where either norm is 0,
    the padding's included)."""
    p_norm, u_norm = torch.sqrt(p_ssq), torch.sqrt(u_ssq)
    return torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                       torch.ones_like(p_norm))


def apply_trust(pf: torch.Tensor, update: torch.Tensor, lr: torch.Tensor,
                runs: Runs, trust: torch.Tensor) -> torch.Tensor:
    """The trailing pass on one (bucket_elems,) bucket: the trust-scaled
    step on the fp32 parameters, each run at its leaf's ratio."""
    out = torch.empty_like(pf)
    for lo, hi, i in runs:
        out[lo:hi] = pf[lo:hi] - lr * trust[i] * update[lo:hi]
    return out
