"""Continuous-batching serving engine (port of ``repro/serve``).

- blocks.py    — paged-pool free-list allocator, per-pod extents
- router.py    — capacity-aware request routing (CapacityPlan limits)
- scheduler.py — admission / preemption / length-bucketed prefill
- engine.py    — the decode loop tying it all together
"""
from repro_torch.serve.blocks import BlockPool, pod_block_pools
from repro_torch.serve.engine import EngineConfig, ServeEngine, ServeResult
from repro_torch.serve.router import CapacityRouter
from repro_torch.serve.scheduler import Request, Scheduler, SeqState

__all__ = ["BlockPool", "pod_block_pools", "CapacityRouter", "Request",
           "Scheduler", "SeqState", "EngineConfig", "ServeEngine",
           "ServeResult"]
