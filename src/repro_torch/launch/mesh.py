"""The process mesh: one process per data-parallel rank and pipeline
stage (port of ``repro/launch/mesh.py`` for the ``(pipe, pod, data)``
axes).

The JAX package lays its devices out as a ``(pipe, pod, data, model)``
mesh and names axes in collectives. Here every rank is a process of one
``torch.distributed`` process group, rank ``r = pipe * dp_size + pod *
data_size + data`` (within a stage, the row order of the JAX batch
sharding ``P(("pod", "data"))``), and each named axis becomes a group:

  * ``world`` — every rank;
  * ``dp``    — the data-parallel ranks of my pipeline stage (the
    ``("pod", "data")`` axes together): every gradient and loss
    reduction runs over it, and without a ``pipe`` axis it is ``world``;
  * ``pod``   — the ranks of my stage with my data index, one per pod
    (the cross-pod leg of the hierarchical reduction);
  * ``data``  — the ranks of my stage and pod (its in-pod leg);
  * ``pipe``  — the ranks with my data-parallel index, one per stage
    (the stage-boundary hops and the per-step gathers of the pipelined
    step, ``launch/steps.py``). Without a ``pipe`` axis it is my rank
    alone.

A leading ``pipe`` axis (:func:`with_pipe`) puts each pipeline stage on
its own processes, the counterpart of the JAX package's
``make_local_mesh(pipe=S)``. A ``model`` axis larger than 1 (tensor
parallelism) is not ported yet.

Backends, chosen once by :func:`choose_backend`: NCCL where each rank
has its own card; gloo on the CPU; gloo with CUDA tensors where several
ranks share one card, as on a one-card machine (NCCL refuses two ranks
on one device).

:func:`spawn` starts the ranks (the ``spawn`` start method: CUDA does
not survive ``fork``) and gathers what each returns. The ranks meet
through a ``file://`` store in a directory :func:`spawn` creates and
removes, so no port is picked before a rank binds it: a port picked by
binding port 0 and closing the socket can be taken by another process
before rank 0 binds it again (``EADDRINUSE``). Gloo and NCCL bind their
own sockets and publish them through the store.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import elastic
from repro_torch.core.comm import Comm

DP_AXES = ("pod", "data")
PIPE_AXIS = "pipe"


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


def with_pipe(shape: Sequence[int], axis_names: Sequence[str],
              stages: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The mesh with a leading ``pipe`` axis of ``stages`` (the driver's
    ``--pipe-axis``): ``stages`` times the ranks of ``shape``."""
    if stages < 2:
        raise ValueError(f"a pipe axis needs pipeline_stages >= 2, got "
                         f"{stages}")
    return (int(stages), *shape), (PIPE_AXIS, *axis_names)


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
    dp: Comm
    pipe: Comm

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in DP_AXES)

    @property
    def dp_size(self) -> int:
        """Data-parallel ranks of one pipeline stage."""
        return math.prod(self.sizes[a] for a in self.dp_axes)

    @property
    def pipe_size(self) -> int:
        return self.sizes.get(PIPE_AXIS, 1)

    @property
    def dp_rank(self) -> int:
        """My index among my stage's data-parallel ranks: the rows of
        the packed global batch I load."""
        return self.rank % self.dp_size

    @property
    def pipe_index(self) -> int:
        """My pipeline stage (0 without a ``pipe`` axis)."""
        return self.rank // self.dp_size

    @property
    def pod_index(self) -> int:
        return self.dp_rank // self.sizes.get("data", 1)

    @property
    def data_index(self) -> int:
        return self.dp_rank % self.sizes.get("data", 1)

    def describe(self) -> str:
        return (f"mesh {dict(self.sizes)}: {self.pipe_size * self.dp_size} "
                f"rank(s), backend {self.backend}, transport "
                f"{self.transport}")


def _groups(shape: Dict[str, int]) -> Dict[str, List[List[int]]]:
    """Every axis group of the mesh, each a list of global ranks, in the
    order every rank creates them."""
    stages = shape.get(PIPE_AXIS, 1)
    pods, data = shape.get("pod", 1), shape.get("data", 1)
    n = pods * data
    return {
        "pod": [[s * n + p * data + d for p in range(pods)]
                for s in range(stages) for d in range(data)],
        "data": [[s * n + p * data + d for d in range(data)]
                 for s in range(stages) for p in range(pods)],
        "dp": [[s * n + r for r in range(n)] for s in range(stages)],
        "pipe": [[s * n + r for s in range(stages)] for r in range(n)]}


def local(shape: Sequence[int] = (1, 1),
          axis_names: Sequence[str] = ("data", "model"),
          device: torch.device | str = "cpu") -> ProcessMesh:
    """The one-rank mesh: no process group, every collective the
    identity."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if _world(dict(zip(axis_names, shape))) != 1:
        raise ValueError(f"mesh {shape} has more than one rank")
    comm = Comm((0,), 0, "local")
    dev = torch.device(device)
    return ProcessMesh(shape, axis_names, 0, dev,
                       "gloo" if dev.type == "cpu" else "nccl", "local",
                       comm, comm, comm, comm, comm)


def unjoined(shape: Sequence[int], axis_names: Sequence[str],
             device: torch.device | str = "cpu") -> ProcessMesh:
    """The mesh as the driver sees it before its ranks start: the axes
    and their sizes, no process group (every collective a one-rank
    stand-in). For the config checks, which read only the axes."""
    comm = Comm((0,), 0, "local")
    return ProcessMesh(tuple(shape), tuple(axis_names), 0,
                       torch.device(device), "none", "local", comm, comm,
                       comm, comm, comm)


def _world(sizes: Dict[str, int]) -> int:
    return math.prod(n for a, n in sizes.items()
                     if a in DP_AXES or a == PIPE_AXIS)


def init(shape: Sequence[int], axis_names: Sequence[str], rank: int,
         init_method: str, device_type: str) -> ProcessMesh:
    """Join the process group as ``rank`` (once per process: a later call
    for another mesh of the same ranks reuses it) and build the axis
    groups (every rank creates every group, in the same order)."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    sizes = dict(zip(axis_names, shape))
    world = _world(sizes)
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
    groups = _groups(sizes)
    world_comm = Comm(range(world), rank, transport, dist.group.WORLD,
                      backend=backend)

    def comm_of(axis):
        mine = None
        for ranks in groups[axis]:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Comm(ranks, rank,
                            transport if len(ranks) > 1 else "local", g,
                            backend=backend)
        return mine

    # every rank creates every group, in this order; without a pipe axis
    # the dp group is the world and the pipe group my rank alone
    pod, data = comm_of("pod"), comm_of("data")
    staged = sizes.get(PIPE_AXIS, 1) > 1
    dp = comm_of("dp") if staged else world_comm
    pipe = comm_of("pipe") if staged else Comm((rank,), rank, "local")
    return ProcessMesh(shape, axis_names, rank, dev, backend, transport,
                       world_comm, pod, data, dp, pipe)


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
    dies; the others are then terminated. ``init_method`` is a
    ``file://`` store in a fresh temporary directory, removed when the
    ranks are done."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rendezvous = tempfile.mkdtemp(prefix="hetseq_rendezvous_")
    init_method = "file://" + os.path.join(rendezvous, "store")
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(fn, r, world, init_method, results, args))
             for r in range(world)]
    got: Dict[int, Any] = {}
    errors: List[str] = []
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
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
            if p.pid is None:                   # never started
                continue
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    if errors or len(got) < world:
        raise RuntimeError("multi-rank run failed: " + (
            "\n".join(errors) or f"{world - len(got)} rank(s) did not "
            f"report within {timeout_s} s"))
    return [got[r] for r in range(world)]
