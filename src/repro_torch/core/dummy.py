"""Dummy-batch construction and weight masks (port of ``repro/core/dummy.py``).

Every DP rank owns a fixed-size buffer (capacity.py); this module fills
buffers: real rows first, then dummy rows that copy row 0 of the global
batch (real token ids, finite activations) with per-token weight 0. The
weighted aggregation (weighting.py) then makes dummy rows exact no-ops
in the loss and gradient. Host-side numpy.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.capacity import CapacityPlan


def pack_global_batch(
    samples: Dict[str, np.ndarray],
    plan: CapacityPlan,
    token_weights: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Distribute ``global_rows`` samples into the padded (R * buffer)
    layout: rank r gets the next n_r rows, then dummies. Returns
    {"inputs", "labels", "weights"} with leading dim R * buffer_rows.
    ``token_weights`` (G, S) marks real-token weights within real rows;
    defaults to all-ones."""
    g = samples["labels"].shape[0]
    if g != plan.global_rows:
        raise ValueError(f"got {g} rows, plan expects {plan.global_rows}")
    seq_shape = samples["labels"].shape[1:]
    if token_weights is None:
        token_weights = np.ones((g,) + seq_shape, np.float32)

    out_rows = plan.padded_rows
    packed: Dict[str, np.ndarray] = {}
    for key in ("inputs", "labels"):
        src = samples[key]
        dst = np.empty((out_rows,) + src.shape[1:], src.dtype)
        dst[:] = src[0]           # dummy rows copy row 0
        cursor = 0
        for r, n in enumerate(plan.rows_per_rank):
            o = r * plan.buffer_rows
            dst[o:o + n] = src[cursor:cursor + n]
            cursor += n
        packed[key] = dst

    w = np.zeros((out_rows,) + seq_shape, np.float32)
    cursor = 0
    for r, n in enumerate(plan.rows_per_rank):
        o = r * plan.buffer_rows
        w[o:o + n] = token_weights[cursor:cursor + n]
        cursor += n
    packed["weights"] = w
    return packed


def unpack_real_rows(packed: Dict[str, np.ndarray],
                     plan: CapacityPlan) -> Dict[str, np.ndarray]:
    """Inverse of pack_global_batch: the G real rows in original order."""
    idx = []
    for r, n in enumerate(plan.rows_per_rank):
        o = r * plan.buffer_rows
        idx.extend(range(o, o + n))
    return {key: packed[key][idx] for key in ("inputs", "labels", "weights")}
