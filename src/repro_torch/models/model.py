"""Model facade for the paged serving path (port of ``repro/models/model.py``).

``build_model(cfg, device)`` returns a :class:`Model` whose methods are
the serving entry points: ``init_params``, ``init_paged_cache``,
``prefill_paged`` and ``decode_paged``. The device defaults to
``"cuda"`` and a CUDA device that is not there raises: the CPU runs only
when the caller asks for it. The training loss comes with the training
slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
    """The serving functions of one config on one device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        tr.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: int) -> Dict[str, Any]:
        return tr.init_params(self.cfg, seed, self.device)

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
