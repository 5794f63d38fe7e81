"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

inverse_sqrt (the paper's translation schedule), linear (its BERT
schedule), cosine and constant; all warm up linearly and are pure
functions of the global step, in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def learning_rate(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(torch.as_tensor(step).float(), min=1.0)
    warm = max(float(cfg.warmup_steps), 1.0)
    total = max(float(cfg.total_steps), warm + 1.0)
    if cfg.schedule == "inverse_sqrt":
        return cfg.lr * torch.minimum(s / warm, torch.sqrt(warm / s))
    if cfg.schedule == "linear":
        decay = torch.clamp((total - s) / (total - warm), 0.0, 1.0)
        return cfg.lr * torch.minimum(s / warm, decay)
    if cfg.schedule == "cosine":
        frac = torch.clamp((s - warm) / (total - warm), 0.0, 1.0)
        return cfg.lr * torch.minimum(
            s / warm, 0.5 * (1.0 + torch.cos(math.pi * frac)))
    if cfg.schedule == "constant":
        return cfg.lr * torch.clamp(s / warm, max=1.0)
    raise ValueError(cfg.schedule)
