"""The process mesh: one process per data-parallel rank
(port of ``repro/launch/mesh.py`` for the ``(pod, data)`` axes).

The JAX package lays its devices out as a ``(pod, data, model)`` mesh
and names axes in collectives. Here every data-parallel rank is a
process of one ``torch.distributed`` process group, rank ``r = pod *
data_size + data`` (the row order of the JAX batch sharding
``P(("pod", "data"))``), and each named axis becomes a group:

  * ``world`` — every rank (the ``("pod", "data")`` axes together);
  * ``pod``   — the ranks with my data index, one per pod (the cross-pod
    leg of the hierarchical reduction);
  * ``data``  — the ranks of my pod (its in-pod leg).

A ``model`` axis larger than 1 (tensor parallelism) is not ported yet.

Backends, chosen once by :func:`choose_backend`: NCCL where each rank
has its own card; gloo on the CPU; gloo with CUDA tensors where several
ranks share one card, as on a one-card machine (NCCL refuses two ranks
on one device).

:func:`spawn` starts the ranks (the ``spawn`` start method: CUDA does
not survive ``fork``) and gathers what each returns.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import elastic
from repro_torch.core.comm import Comm

DP_AXES = ("pod", "data")


def parse_devices(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``--devices``, as the JAX driver reads it: two entries are
    ``data,model``, three are ``pod,data,model``."""
    shape = tuple(int(x) for x in spec.split(","))
    if len(shape) == 2:
        axes = ("data", "model")
    elif len(shape) == 3:
        axes = ("pod", "data", "model")
    else:
        raise SystemExit(f"--devices {spec}: expected data,model or "
                         f"pod,data,model")
    if any(n < 1 for n in shape):
        raise SystemExit(f"--devices {spec}: every axis needs size >= 1")
    if shape[-1] > 1:
        raise NotImplementedError(
            f"--devices {spec}: a model axis of {shape[-1]} (tensor "
            f"parallelism) is not ported yet")
    return shape, axes


def topology_from_devices(spec: str) -> elastic.MeshTopology:
    """The topology a ``--devices`` value describes (the JAX driver's
    ``topology_from_mesh``)."""
    shape, axes = parse_devices(spec)
    sizes = dict(zip(axes, shape))
    return elastic.MeshTopology(pods=sizes.get("pod", 1),
                                data_per_pod=sizes["data"],
                                model=sizes["model"])


def devices_for_topology(topo: elastic.MeshTopology) -> str:
    """The ``--devices`` value of a topology, for a fresh spawn of its
    ranks (the JAX driver's ``mesh_for_topology``: ``pod,data,model``
    with more than one pod, else ``data,model``)."""
    return ",".join(str(n) for n in topo.mesh_shape())


def choose_backend(device_type: str, world: int,
                   cards: int) -> Tuple[str, str]:
    """(backend, transport) for ``world`` ranks on ``device_type``."""
    if device_type == "cpu":
        return "gloo", ("local" if world == 1 else "direct")
    if world == 1:
        return "nccl", "local"
    if world <= cards:
        return "nccl", "direct"
    return "gloo", "direct"


@dataclasses.dataclass
class ProcessMesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    transport: str
    world: Comm
    pod: Comm
    data: Comm

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in DP_AXES)

    @property
    def dp_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp_axes)

    @property
    def pod_index(self) -> int:
        return self.rank // self.sizes.get("data", 1)

    @property
    def data_index(self) -> int:
        return self.rank % self.sizes.get("data", 1)

    def describe(self) -> str:
        return (f"mesh {dict(self.sizes)}: {self.dp_size} rank(s), backend "
                f"{self.backend}, transport {self.transport}")


def _groups(shape: Dict[str, int]) -> Tuple[List[List[int]],
                                            List[List[int]]]:
    pods, data = shape.get("pod", 1), shape.get("data", 1)
    pod_groups = [[p * data + d for p in range(pods)] for d in range(data)]
    data_groups = [[p * data + d for d in range(data)] for p in range(pods)]
    return pod_groups, data_groups


def local(shape: Sequence[int] = (1, 1),
          axis_names: Sequence[str] = ("data", "model"),
          device: torch.device | str = "cpu") -> ProcessMesh:
    """The one-rank mesh: no process group, every collective the
    identity."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if math.prod(s for s, a in zip(shape, axis_names) if a in DP_AXES) != 1:
        raise ValueError(f"mesh {shape} has more than one rank")
    comm = Comm((0,), 0, "local")
    dev = torch.device(device)
    return ProcessMesh(shape, axis_names, 0, dev,
                       "gloo" if dev.type == "cpu" else "nccl", "local",
                       comm, comm, comm)


def unjoined(shape: Sequence[int], axis_names: Sequence[str],
             device: torch.device | str = "cpu") -> ProcessMesh:
    """The mesh as the driver sees it before its ranks start: the axes
    and their sizes, no process group (every collective a one-rank
    stand-in). For the config checks, which read only the axes."""
    comm = Comm((0,), 0, "local")
    return ProcessMesh(tuple(shape), tuple(axis_names), 0,
                       torch.device(device), "none", "local", comm, comm,
                       comm)


def init(shape: Sequence[int], axis_names: Sequence[str], rank: int,
         init_method: str, device_type: str) -> ProcessMesh:
    """Join the process group as ``rank`` (once per process: a later call
    for another mesh of the same ranks reuses it) and build the axis
    groups (every rank creates every group, in the same order)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    sizes = dict(zip(axis_names, shape))
    world = math.prod(sizes[a] for a in axis_names if a in DP_AXES)
    if world == 1:
        dev = torch.device("cuda", 0) if device_type == "cuda" else \
            torch.device("cpu")
        return local(shape, axis_names, dev)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and cards == 0:
        raise RuntimeError("CUDA is not available: pass --device cpu")
    backend, transport = choose_backend(device_type, world, cards)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, **kw)
    elif (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise RuntimeError(f"process group of {dist.get_world_size()} "
                           f"ranks joined as {dist.get_rank()}; mesh "
                           f"{shape} needs {world}, rank {rank}")
    pod_groups, data_groups = _groups(sizes)

    def comm_of(groups):
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Comm(ranks, rank,
                            transport if len(ranks) > 1 else "local", g)
        return mine

    pod = comm_of(pod_groups)
    data = comm_of(data_groups)
    world_comm = Comm(range(world), rank, transport, dist.group.WORLD)
    return ProcessMesh(shape, axis_names, rank, dev, backend, transport,
                       world_comm, pod, data)


def destroy(mesh: ProcessMesh) -> None:
    if mesh.transport != "local" and dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# spawning the ranks
# --------------------------------------------------------------------------


def share_cpu(world: int) -> None:
    """Give this rank its share of the host's cores for PyTorch's CPU
    threads: ``world`` ranks each spinning a thread per core slow a CPU
    run down tenfold."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, init_method: str,
               results, args: tuple) -> None:
    try:
        out = fn(rank, world, init_method, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` new
    processes (start method ``spawn``; ``fn`` must be importable) and
    return their results in rank order. Raises if any rank raises or
    dies; the others are then terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(fn, r, world, init_method, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    errors: List[str] = []
    t0 = time.monotonic()
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead and not errors:
                    errors.append(f"rank(s) {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                if errors or (timeout_s is not None
                              and time.monotonic() - t0 > timeout_s):
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        if errors or len(got) < world:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(got) < world:
        raise RuntimeError("multi-rank run failed: " + (
            "\n".join(errors) or f"{world - len(got)} rank(s) did not "
            f"report within {timeout_s} s"))
    return [got[r] for r in range(world)]
