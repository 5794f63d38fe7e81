"""Train state and the single-device train step
(port of ``repro/launch/steps.py``, the plain ``allreduce`` path).

One device, so the JAX step's mesh, shardings and ``jit`` have no
counterpart: the step is a Python function over plain parameter trees.
What it keeps is the HetSeq arithmetic of the JAX step's plain path:
the gradient of the objective SUM and the weight sum per microbatch
(``accum_steps`` microbatches from ``split_microbatches``), summed in
fp32, divided by the summed weight exactly once, then global-norm clip
and AdamW. Dummy rows carry weight 0 and run forward and backward like
real ones.

Every other mode of the JAX step (bucketed or hierarchical reduction,
int8 compression, overlap, pipeline stages, the canonical executor,
LAMB) raises "not ported yet": they need more than one rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.accumulate import accumulate_grads, split_microbatches
from repro_torch.models import transformer as tr
from repro_torch.models.model import Model
from repro_torch.optim import adam, schedules


class TrainState(NamedTuple):
    params: Any
    opt: adam.AdamState
    err: Any                       # error-feedback state: () on one device


def validate_train_config(model: Model, tcfg: TrainConfig) -> None:
    """The JAX package's config checks, then what this port runs: raises
    ``ValueError`` for an invalid config and ``NotImplementedError`` for
    a valid mode that is not ported yet."""
    het = tcfg.het.validate()
    if not 0.0 <= tcfg.label_smoothing < 1.0:
        raise ValueError(
            f"TrainConfig.label_smoothing must be in [0, 1), got "
            f"{tcfg.label_smoothing}")
    tr.check_supported(model.cfg)
    unported = [
        (het.grad_reduction != "allreduce",
         f"grad_reduction='{het.grad_reduction}'"),
        (het.compression != "none", f"compression='{het.compression}'"),
        (het.overlap != "none", f"overlap='{het.overlap}'"),
        (het.pipeline_stages > 1,
         f"pipeline_stages={het.pipeline_stages}"),
        (het.weighting == "canonical", "weighting='canonical'"),
        (tcfg.optimizer.name != "adamw",
         f"optimizer '{tcfg.optimizer.name}'"),
    ]
    missing = [name for bad, name in unported if bad]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not ported yet (repro_torch trains on "
            f"one device with grad_reduction='allreduce' and AdamW)")


def init_train_state(model: Model, tcfg: TrainConfig,
                     seed: int | None = None) -> TrainState:
    """Parameters from ``seed`` (default ``tcfg.seed``) on the model's
    device and zero AdamW moments."""
    params = model.init_params(tcfg.seed if seed is None else seed)
    return TrainState(params=params,
                      opt=adam.init_state(params, tcfg.optimizer), err=())


def loss_and_grads(model: Model, tcfg: TrainConfig, params: Any,
                   batch: Dict[str, torch.Tensor], *, ce_impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """The step's gradient computation without the update: returns
    (loss, weight_sum, grads), loss and grads of the weighted mean over
    every real token of ``batch`` (all ``accum_steps`` microbatches),
    divided by the summed weight once."""
    grads, loss, w = accumulate_grads(
        model.loss_fn, params,
        split_microbatches(batch, max(1, tcfg.het.accum_steps)),
        ce_impl=ce_impl, label_smoothing=tcfg.label_smoothing)
    return loss, w, grads


def build_train_step(model: Model, tcfg: TrainConfig
                     ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                             Dict]]:
    """``step(state, batch) -> (state', metrics)`` with metrics ``loss``,
    ``weight``, ``grad_norm`` and ``lr`` (0-dim tensors), as the JAX
    step returns, with the cross entropy through the kernel
    (``ce_impl="kernel"``). ``batch``: inputs, labels (R*B, S) int and
    weights (R*B, S) float on the model's device. The update is written into
    the state's tensors (``adam.apply_update``), so the state passed in
    is the state returned."""
    validate_train_config(model, tcfg)
    ocfg = tcfg.optimizer

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, w, grads = loss_and_grads(model, tcfg, state.params, batch)
        lr = schedules.learning_rate(ocfg, state.opt.step + 1)
        params, opt, met = adam.apply_update(state.params, grads, state.opt,
                                             ocfg, lr)
        return (TrainState(params=params, opt=opt, err=state.err),
                {"loss": loss, "weight": w, **met})

    return step
