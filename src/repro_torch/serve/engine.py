"""The continuous-batching decode loop (port of ``repro/serve/engine.py``).

Each iteration: ingest due arrivals, admit what fits (scheduler),
prefill the admitted prompts in length buckets, then run ONE decode
step for the whole slot batch — every active sequence advances one
token at its own depth (per-sequence ``kv_lens``), finished sequences
free their blocks immediately and their slots are refilled next
iteration. The decode step has fixed shapes (D,), (D, MB), (D,);
inactive slots carry kv_len=0 and all-NULL block tables, so their
writes drop and their outputs are discarded host-side.

Host arrays become tensors on the engine's device for each step, and
logits come back with ``.float().cpu().numpy()``. The JAX engine's
retrace assertion guards a jit cache; PyTorch runs eagerly and has no
compile cache to guard, so it has no counterpart here.

**Modeled clock.** As in the JAX engine, throughput/latency stats ride
on a deterministic cost model in abstract time units (one unit == one
decode-token on a speed-1.0 pod):

- decode iteration:  dt = max_p active_p / speed_p
- prefill of a bucket-L group: dt = max_p rows_p * L / speed_p

``wall_seconds`` is the host clock around the whole run, which ends in
a device synchronisation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, flash_decode_paged_cuda)
from repro_torch.models.kvcache import PagedLayout
from repro_torch.serve.scheduler import Request, Scheduler, SeqState

KERNELS = {"flash_attention_cuda": flash_attention_cuda,
           "flash_decode_paged_cuda": flash_decode_paged_cuda}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    decode_slots: int
    prefill_batch: int
    max_iterations: int = 100_000     # runaway-loop guard, fail loud
    # which attention ran (ModelConfig.attention_impl at build time) —
    # recorded in stats so a serving run is auditable
    attention_impl: str = "reference"


@dataclasses.dataclass
class ServeResult:
    tokens: Dict[int, List[int]]      # rid -> generated token ids
    stats: Dict[str, Any]


class ServeEngine:
    """Ties the scheduler and the paged steps into a serving loop.

    ``decode_fn(tokens, cache, tables, kv_lens)`` and
    ``prefill_fns[bucket](prompts, lens, cache, tables)`` take tensors
    on ``device`` and return (logits, cache); ``init_cache_fn()`` builds
    the zeroed pool.
    """

    def __init__(self, cfg: EngineConfig, layout: PagedLayout,
                 scheduler: Scheduler,
                 decode_fn: Callable,
                 prefill_fns: Dict[int, Callable],
                 init_cache_fn: Callable[[], Any],
                 device: torch.device):
        missing = [b for b in scheduler.bucket_lens
                   if b not in prefill_fns]
        if missing:
            raise ValueError(f"no prefill step for buckets {missing}")
        self.cfg = cfg
        self.layout = layout
        self.sched = scheduler
        self.decode_fn = decode_fn
        self.prefill_fns = prefill_fns
        self.init_cache_fn = init_cache_fn
        self.device = torch.device(device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- modeled costs -----------------------------------------------------

    def _decode_dt(self) -> float:
        speeds = self.sched.router.pod_speeds
        return max((a / speeds[p]
                    for p, a in enumerate(self.sched.active_per_pod)
                    if a > 0), default=0.0)

    def _prefill_dt(self, bucket: int, seqs: Sequence[SeqState]) -> float:
        speeds = self.sched.router.pod_speeds
        rows = [0] * len(speeds)
        for s in seqs:
            rows[s.pod] += 1
        return max((r * bucket / speeds[p]
                    for p, r in enumerate(rows) if r > 0), default=0.0)

    # -- the loop ----------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> ServeResult:
        sched, layout = self.sched, self.layout
        NULL = layout.null_block
        D, MB = self.cfg.decode_slots, layout.max_blocks_per_seq

        arrivals = sorted(requests, key=lambda r: (r.arrival, r.rid))
        tokens_out: Dict[int, List[int]] = {r.rid: [] for r in arrivals}
        token_times: Dict[int, List[float]] = {r.rid: [] for r in arrivals}
        arrival_of = {r.rid: r.arrival for r in arrivals}

        launches0 = {n: k.launches for n, k in KERNELS.items()}
        cache = self.init_cache_fn()
        clock, ai = 0.0, 0
        decode_steps = prefill_groups = 0
        peak_active = [0] * sched.router.num_pods
        block_util_peak, block_util_sum, util_samples = 0.0, 0.0, 0
        wall0 = time.monotonic()

        def emit(seq: SeqState, tok: int, t: float) -> None:
            seq.generated.append(tok)
            seq.last_token = tok
            tokens_out[seq.rid].append(tok)
            token_times[seq.rid].append(t)
            if seq.done:
                sched.finish(seq)

        it = 0
        while ai < len(arrivals) or sched.waiting or sched.running:
            it += 1
            if it > self.cfg.max_iterations:
                raise RuntimeError(
                    f"serve loop exceeded {self.cfg.max_iterations} "
                    f"iterations — scheduler stuck?")
            # idle: jump the clock to the next arrival
            if (not sched.running and not sched.waiting
                    and ai < len(arrivals)):
                clock = max(clock, arrivals[ai].arrival)
            while ai < len(arrivals) and arrivals[ai].arrival <= clock:
                sched.submit(arrivals[ai])
                ai += 1

            admitted = sched.try_admit()
            by_bucket: Dict[int, List[SeqState]] = {}
            for seq in admitted:
                by_bucket.setdefault(
                    sched.bucket_for(len(seq.prompt)), []).append(seq)
            for bucket in sorted(by_bucket):
                group = by_bucket[bucket]
                Bp = self.cfg.prefill_batch
                for lo in range(0, len(group), Bp):
                    chunk = group[lo:lo + Bp]
                    cache, logits = self._prefill(chunk, bucket, Bp,
                                                  cache, NULL, MB)
                    clock += self._prefill_dt(bucket, chunk)
                    prefill_groups += 1
                    toks = np.argmax(logits[:len(chunk)], axis=-1)
                    for seq, tok in zip(chunk, toks):
                        seq.kv_len = len(seq.prompt)
                        emit(seq, int(tok), clock)

            if sched.running:
                # grow block tables BEFORE the step (the new token
                # writes at position kv_len); may preempt newest-first
                for slot in sorted(sched.running):
                    seq = sched.running.get(slot)
                    if seq is not None and not sched.ensure_next_block(
                            seq):
                        continue            # seq preempted itself
                if not sched.running:
                    continue
                tok_arr = np.zeros((D,), np.int32)
                tbl_arr = np.full((D, MB), NULL, np.int32)
                len_arr = np.zeros((D,), np.int32)
                for slot, seq in sched.running.items():
                    tok_arr[slot] = seq.last_token
                    tbl_arr[slot, :len(seq.blocks)] = seq.blocks
                    len_arr[slot] = seq.kv_len
                logits, cache = self.decode_fn(
                    self._tensor(tok_arr), cache, self._tensor(tbl_arr),
                    self._tensor(len_arr))
                clock += self._decode_dt()
                decode_steps += 1
                for p, a in enumerate(sched.active_per_pod):
                    peak_active[p] = max(peak_active[p], a)
                util = sched.allocated_blocks() / layout.num_blocks
                block_util_peak = max(block_util_peak, util)
                block_util_sum += util
                util_samples += 1
                logits_h = logits.float().cpu().numpy()
                for slot, seq in list(sched.running.items()):
                    seq.kv_len += 1
                    emit(seq, int(np.argmax(logits_h[slot])), clock)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.monotonic() - wall0
        total_tokens = sum(len(v) for v in tokens_out.values())
        tpot = [(token_times[rid][-1] - arrival_of[rid]) / len(ts)
                for rid, ts in token_times.items() if ts]
        ttft = [ts[0] - arrival_of[rid]
                for rid, ts in token_times.items() if ts]
        stats = {
            "requests": len(arrivals),
            "total_tokens": total_tokens,
            "modeled_time": clock,
            "modeled_tokens_per_sec": (total_tokens / clock
                                       if clock > 0 else 0.0),
            "p50_time_per_token": (float(np.percentile(tpot, 50))
                                   if tpot else 0.0),
            "p99_time_per_token": (float(np.percentile(tpot, 99))
                                   if tpot else 0.0),
            "mean_ttft": float(np.mean(ttft)) if ttft else 0.0,
            "decode_steps": decode_steps,
            "prefill_groups": prefill_groups,
            "preemptions": sched.preemptions,
            "peak_active_per_pod": [int(x) for x in peak_active],
            "pod_limits": [int(x) for x in sched.router.limits],
            "block_util_peak": block_util_peak,
            "block_util_mean": (block_util_sum / util_samples
                                if util_samples else 0.0),
            "attention_impl": self.cfg.attention_impl,
            "kernel_launches": {n: k.launches - launches0[n]
                                for n, k in KERNELS.items()},
            "device": str(self.device),
            "wall_seconds": wall,
        }
        return ServeResult(tokens=tokens_out, stats=stats)

    def _prefill(self, chunk: Sequence[SeqState], bucket: int, Bp: int,
                 cache: Any, NULL: int, MB: int):
        prompts = np.zeros((Bp, bucket), np.int32)
        lens = np.zeros((Bp,), np.int32)
        tables = np.full((Bp, MB), NULL, np.int32)
        for i, seq in enumerate(chunk):
            prompts[i, :len(seq.prompt)] = seq.prompt
            lens[i] = len(seq.prompt)
            tables[i, :len(seq.blocks)] = seq.blocks
        logits, cache = self.prefill_fns[bucket](
            self._tensor(prompts), self._tensor(lens), cache,
            self._tensor(tables))
        return cache, logits.float().cpu().numpy()
