"""Heterogeneity-aware batch sampler (paper: forward-pass sampling).

Responsibilities:
  * deterministic epoch plans: the permutation of record indices derives
    from (seed, epoch) ONLY — never from rank count or capacities — so
    elastic re-meshes and replans reproduce the identical global sample
    stream (paper: reproducible shuffling; our Cython-analogue is a
    precomputed NumPy plan, zero per-step Python in the hot path);
  * max-tokens batching: greedy length-bucketed packing that fills a
    global token budget (paper: "maximize number of tokens in a batch");
  * capacity-aware slicing: each global batch is split across DP ranks
    per the CapacityPlan (rank r takes the next n_r rows), then padded
    into uniform buffers with weight-0 dummies (core/dummy.py).

Port of ``repro/data/sampler.py``: the same numpy code, copied so that
the port does not import the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.capacity import CapacityPlan
from repro_torch.core.dummy import pack_global_batch, unpack_real_rows
from repro_torch.data.dataset import ShardedDataset


def epoch_permutation(num_records: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(num_records)


@dataclasses.dataclass(frozen=True)
class BatchPlanEntry:
    indices: np.ndarray            # record ids in this global batch


def plan_epoch_batches(
    num_records: int,
    seed: int,
    epoch: int,
    *,
    global_rows: Optional[int] = None,
    max_tokens: Optional[int] = None,
    lengths: Optional[np.ndarray] = None,
    drop_last: bool = False,
) -> List[BatchPlanEntry]:
    """Either fixed-rows batches or max-tokens batches over one epoch.

    The final batch may be partial — the paper's epoch-boundary case;
    the capacity planner turns the shortfall into dummy rows.
    """
    perm = epoch_permutation(num_records, seed, epoch)
    batches: List[BatchPlanEntry] = []
    if max_tokens is not None:
        if lengths is None:
            raise ValueError("max_tokens batching needs per-record lengths")
        cur: List[int] = []
        cur_tokens = 0
        for idx in perm:
            l = int(lengths[idx])
            if cur and cur_tokens + l > max_tokens:
                batches.append(BatchPlanEntry(np.asarray(cur, np.int64)))
                cur, cur_tokens = [], 0
            cur.append(int(idx))
            cur_tokens += l
        if cur and not drop_last:
            batches.append(BatchPlanEntry(np.asarray(cur, np.int64)))
    else:
        if global_rows is None:
            raise ValueError("need global_rows or max_tokens")
        for start in range(0, num_records, global_rows):
            idx = perm[start:start + global_rows]
            if len(idx) < global_rows and drop_last:
                break
            batches.append(BatchPlanEntry(idx))
    return batches


class HetSampler:
    """Iterates packed SPMD batches for one epoch under a CapacityPlan."""

    def __init__(self, dataset: ShardedDataset, plan: CapacityPlan,
                 seed: int, input_field: str = "inputs",
                 label_field: str = "labels",
                 max_tokens: Optional[int] = None,
                 canonical_order: bool = False):
        self.dataset = dataset
        self.plan = plan
        self.seed = seed
        self.input_field = input_field
        self.label_field = label_field
        self.max_tokens = max_tokens
        self.canonical_order = canonical_order

    def set_plan(self, plan: CapacityPlan) -> None:
        """Capacity replan between steps (straggler feedback)."""
        self.plan = plan

    def epoch_batches(self, epoch: int) -> List[BatchPlanEntry]:
        lengths = (self.dataset.sequence_lengths()
                   if self.max_tokens is not None else None)
        return plan_epoch_batches(
            len(self.dataset), self.seed, epoch,
            global_rows=(None if self.max_tokens else self.plan.global_rows),
            max_tokens=self.max_tokens, lengths=lengths)

    def pack(self, entry: BatchPlanEntry) -> Dict[str, np.ndarray]:
        """Fetch + pack one global batch into the padded SPMD layout.

        Short (epoch-final) batches are padded with dummy rows via a
        shrunken per-batch plan — the paper's partial/empty batch case.
        """
        recs = self.dataset.gather(entry.indices)
        rows = len(entry.indices)
        plan = self.plan
        if rows != plan.global_rows:
            from repro_torch.core.capacity import plan_capacities
            plan = plan_capacities(rows, plan.capacities,
                                   buffer_rows=plan.buffer_rows)
        samples = {"inputs": recs[self.input_field],
                   "labels": recs[self.label_field]}
        weights = recs.get("weights")
        packed = pack_global_batch(samples, plan, token_weights=weights)
        if not self.canonical_order:
            return packed
        # canonical mode (weighting="canonical"): rows in global-row
        # order, NOT rank-buffer order — the order-canonical train step
        # sums per-row grads along this axis with one fixed tree, so
        # the layout must not depend on the plan. Partial batches pad
        # with weight-0 rows at the END (a trailing zero term keeps the
        # reduction tree of the real rows intact; an interleaved one
        # would regroup it), keeping the batch shape static at
        # global_rows.
        real = unpack_real_rows(packed, plan)
        rows = real["inputs"].shape[0]
        target = self.plan.global_rows
        if rows < target:
            pad = target - rows
            real = {
                k: np.concatenate(
                    [v, np.repeat(v[:1], pad, axis=0)], axis=0)
                for k, v in real.items()}
            real["weights"][rows:] = 0.0
        return real

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_epoch(0)

    def iter_epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for entry in self.epoch_batches(epoch):
            yield self.pack(entry)
