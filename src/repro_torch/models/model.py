"""Model facade (port of ``repro/models/model.py``).

``build_model(cfg, device)`` returns a :class:`Model` whose methods are
the entry points: ``init_params``, the training loss ``loss_fn``, and
the serving functions ``init_paged_cache``, ``prefill_paged`` and
``decode_paged``. The device defaults to ``"cuda"`` and a CUDA device
that is not there raises: the CPU runs only when the caller asks for it.

The training loss follows the HetSeq aggregation contract (paper M1/M3):
every token carries a weight (0 for dummy/padding tokens); ``loss_fn``
returns the *weighted loss sum* and the *weight sum*, never a local
mean, so any split of the batch across heterogeneous workers aggregates
to exactly the single-process loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cross_entropy import ops as ce_ops
from repro_torch.models import kvcache as kvc
from repro_torch.models import transformer as tr


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and CUDA is
    not available (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class Model:
    """The training loss and serving functions of one config on one
    device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        tr.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: int) -> Dict[str, Any]:
        return tr.init_params(self.cfg, seed, self.device)

    def loss_fn(self, params, batch: Dict[str, torch.Tensor],
                ce_impl: str = "kernel",
                label_smoothing: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """batch: inputs (B, S) int, labels (B, S) int, weights (B, S)
        float (0 => dummy token, paper M3).

        ``label_smoothing``: CE smoothing factor; None falls back to a
        float ``batch["label_smoothing"]`` entry if present, else 0.0.
        Returns (objective_sum, weight_sum, metrics); objective_sum is
        differentiable, divide by the (summed) weight_sum once. The MoE
        aux term of the JAX package is 0 on the dense plan."""
        cfg = self.cfg
        if label_smoothing is None:
            from_batch = batch.get("label_smoothing", 0.0)
            label_smoothing = (from_batch
                               if isinstance(from_batch, float) else 0.0)
        x = tr.embed_tokens(params, batch["inputs"], cfg)
        hidden, aux = tr.hidden_states(params, x, cfg)
        b, s, d = hidden.shape
        loss_sum, w_sum = ce_ops.weighted_cross_entropy(
            hidden.reshape(b * s, d), tr.lm_head_matrix(params, cfg),
            batch["labels"].reshape(-1),
            batch["weights"].reshape(-1).float(),
            label_smoothing=label_smoothing,
            logit_softcap=cfg.logit_softcap, impl=ce_impl)
        objective_sum = loss_sum + aux * w_sum.detach()
        return objective_sum, w_sum, {"ce_sum": loss_sum, "aux": aux}

    def init_paged_cache(self, layout: kvc.PagedLayout
                         ) -> Dict[str, torch.Tensor]:
        return tr.init_paged_cache(self.cfg, layout, self.device)

    @torch.no_grad()
    def prefill_paged(self, params, inputs: torch.Tensor,
                      lens: torch.Tensor, paged_cache,
                      block_tables: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Prefill a length-bucketed chunk into the paged pool.

        inputs (B, S) token ids padded to the bucket length S (a multiple
        of the block size); lens (B,) real prompt lengths; block_tables
        (B, MB). Returns (next-token logits (B, V) at each sequence's own
        last real token, the pool updated in place).
        """
        cfg = self.cfg
        s = inputs.shape[1]
        x = tr.embed_tokens(params, inputs, cfg)
        hidden, contiguous = tr.prefill(params, x, cfg, s)
        last = torch.clamp(lens.long() - 1, 0, s - 1)
        h_last = hidden[torch.arange(hidden.shape[0],
                                     device=hidden.device), last][:, None]
        logits = tr.unembed(params, h_last, cfg)[:, 0, :]
        cache = kvc.write_prefill_blocks(paged_cache, contiguous,
                                         block_tables)
        return logits, cache

    @torch.no_grad()
    def decode_paged(self, params, inputs: torch.Tensor, paged_cache,
                     block_tables: torch.Tensor, kv_lens: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """inputs: token ids (B,); kv_lens (B,) per-sequence depths."""
        x = tr.embed_tokens(params, inputs[:, None], self.cfg)
        hidden, cache = tr.decode_step_paged(params, x, self.cfg,
                                             paged_cache, block_tables,
                                             kv_lens)
        return tr.unembed(params, hidden, self.cfg)[:, 0, :], cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
