"""Admission, preemption, and prefill bucketing for continuous batching
(copy of ``repro/serve/scheduler.py``; host-side, framework-free).

The scheduler is pure host-side bookkeeping over three budgets:

- **decode slots** — the fixed batch width D of the decode step;
  a free slot is a row in that batch.
- **per-pod concurrency** — the CapacityRouter's ``rows_per_rank``
  limits: a slow pod holds proportionally fewer concurrent sequences.
- **blocks** — each pod's extent of the paged pool (serve/blocks.py);
  a sequence needs ceil(len / block_size) blocks at admission and one
  more each time its kv_len crosses a block boundary.

Admission is strict FIFO (head-of-line blocking keeps the trace
deterministic and starvation-free). When a running sequence cannot get
its next block, the *newest* running sequence on the same pod is
preempted: its blocks are freed and it re-enters the FRONT of the
waiting queue as a longer prompt (original prompt + tokens generated so
far), to be re-prefilled later. The oldest running sequence is never
the victim while others exist, so the system always drains.

Prompts are prefilled in length buckets — multiples of the block size —
so prefill runs at a few fixed shapes instead of one per prompt
length.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.models.kvcache import PagedLayout
from repro_torch.serve.blocks import BlockPool, pod_block_pools
from repro_torch.serve.router import CapacityRouter


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``prompt`` is the token ids; after a
    preemption the re-queued request carries prompt + generated-so-far
    and the remaining token budget."""
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0


@dataclasses.dataclass
class SeqState:
    """A running sequence: its decode-batch slot, pod, owned blocks,
    and current cache depth."""
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int          # remaining budget for THIS admission
    arrival: float
    pod: int
    slot: int
    blocks: List[int]
    kv_len: int = 0              # tokens currently in the paged cache
    last_token: int = -1         # input to the next decode step
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_order: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    def __init__(self, layout: PagedLayout, router: CapacityRouter,
                 decode_slots: int,
                 bucket_lens: Optional[Sequence[int]] = None):
        self.layout = layout
        self.router = router
        self.decode_slots = decode_slots
        self.pools: List[BlockPool] = pod_block_pools(layout,
                                                      router.num_pods)
        if bucket_lens is None:
            bucket_lens = default_bucket_lens(layout)
        self.bucket_lens = tuple(sorted(set(int(b) for b in bucket_lens)))
        for b in self.bucket_lens:
            if b <= 0 or b % layout.block_size:
                raise ValueError(
                    f"prefill bucket {b} is not a positive multiple of "
                    f"block size {layout.block_size}")
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, SeqState] = {}      # slot -> seq
        self._free_slots = list(range(decode_slots - 1, -1, -1))
        self.active_per_pod = [0] * router.num_pods
        self._admit_counter = 0
        self.preemptions = 0

    # -- budgets -----------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        for b in self.bucket_lens:
            if b >= length:
                return b
        raise ValueError(
            f"prompt of {length} tokens exceeds the largest prefill "
            f"bucket {self.bucket_lens[-1]}")

    def allocated_blocks(self) -> int:
        return sum(len(s.blocks) for s in self.running.values())

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError(f"request {req.rid}: max_new_tokens must "
                             f"be positive")
        if total > self.layout.max_seq_len:
            raise ValueError(
                f"request {req.rid}: {total} tokens exceeds layout max "
                f"{self.layout.max_seq_len}")
        need = self.layout.blocks_for(total)
        fits = max((p.num_blocks for p, lim in zip(self.pools,
                                                   self.router.limits)
                    if lim > 0), default=0)
        if need > fits:
            raise ValueError(
                f"request {req.rid}: needs {need} blocks but the largest "
                f"admitting pod extent holds {fits}")
        self.bucket_for(len(req.prompt))   # raises if no bucket fits
        self.waiting.append(req)

    def try_admit(self) -> List[SeqState]:
        """Admit waiting requests FIFO while slots / pod limits / blocks
        allow. Returns the newly admitted sequences (to be prefilled)."""
        admitted: List[SeqState] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = self.layout.blocks_for(len(req.prompt))
            pod = self._route_with_blocks(need)
            if pod is None:
                break                       # head-of-line blocks: FIFO
            self.waiting.popleft()
            seq = SeqState(
                rid=req.rid, prompt=req.prompt,
                max_new_tokens=req.max_new_tokens, arrival=req.arrival,
                pod=pod, slot=self._free_slots.pop(),
                blocks=self.pools[pod].alloc(need),
                admit_order=self._admit_counter)
            self._admit_counter += 1
            self.running[seq.slot] = seq
            self.active_per_pod[pod] += 1
            admitted.append(seq)
        return admitted

    def _route_with_blocks(self, need: int) -> Optional[int]:
        """Route respecting pod limits AND that pod's block extent."""
        active = list(self.active_per_pod)
        while True:
            pod = self.router.route(active)
            if pod is None:
                return None
            if self.pools[pod].num_free >= need:
                return pod
            active[pod] = self.router.limits[pod]   # mask it, try next

    def ensure_next_block(self, seq: SeqState) -> bool:
        """Guarantee the block holding position ``kv_len`` exists before
        a decode step writes there. May preempt (newest-first, same
        pod); returns False if ``seq`` itself got preempted."""
        needed = seq.kv_len // self.layout.block_size
        if needed < len(seq.blocks):
            return True
        pool = self.pools[seq.pod]
        while pool.num_free < 1:
            victim = self._newest_on_pod(seq.pod)
            self.preempt(victim)
            if victim is seq:
                return False
        seq.blocks.extend(pool.alloc(1))
        return True

    def _newest_on_pod(self, pod: int) -> SeqState:
        cands = [s for s in self.running.values() if s.pod == pod]
        return max(cands, key=lambda s: s.admit_order)

    def preempt(self, seq: SeqState) -> None:
        """Evict: free blocks + slot, re-queue at the FRONT as a longer
        prompt with the remaining token budget."""
        self._release(seq)
        self.preemptions += 1
        self.waiting.appendleft(Request(
            rid=seq.rid,
            prompt=seq.prompt + tuple(seq.generated),
            max_new_tokens=seq.max_new_tokens - len(seq.generated),
            arrival=seq.arrival))

    def finish(self, seq: SeqState) -> None:
        self._release(seq)

    def _release(self, seq: SeqState) -> None:
        del self.running[seq.slot]
        self.pools[seq.pod].free(seq.blocks)
        self.active_per_pod[seq.pod] -= 1
        self._free_slots.append(seq.slot)


def default_bucket_lens(layout: PagedLayout) -> Tuple[int, ...]:
    """Power-of-two multiples of the block size up to the layout max."""
    out, b = [], layout.block_size
    while b < layout.max_seq_len:
        out.append(b)
        b *= 2
    out.append(layout.max_seq_len)
    return tuple(out)
