"""One process group's collectives, as the gradient exchange uses them.

:class:`Comm` wraps a ``torch.distributed`` group (or a single rank,
where every collective is the identity) with the three collectives the
reduction needs, always on tensors whose rows are the unit of a split:

  * :meth:`Comm.all_to_all` — ``all_to_all_single`` with row splits
    (ragged messages: the int8 exchange never sends the all-padding
    tail of the bucket stack);
  * :meth:`Comm.all_gather` — ``all_gather`` into the rows of one
    tensor, equal sizes;
  * :meth:`Comm.all_reduce` — a sum (or another reduction), in place.

and one point-to-point hop, the pipelined step's stage boundary (the
JAX package's ``_pipe_send``):

  * :meth:`Comm.send` / :meth:`Comm.recv` — one tensor to / from one
    other rank of the group, both posted at once and returned as a
    :class:`Pending` (the caller posts every hop of a pair of ranks in
    one order on both sides, ``launch/steps.py::PipeHop``).

``sent_bytes`` counts the bytes this rank hands to the first two for
other ranks (its own row of a message and its own piece of a gather
stay local), the number ``core/buckets.py::modeled_link_bytes`` models,
and every byte it sends point to point.

With ``async_op=True`` the first two issue their collective and return
a :class:`Pending` at once (the overlapped bucket pipelines keep one
bucket's collective in flight while they prepare the next); its
:meth:`Pending.wait` returns the output. The bytes are counted when the
collective is issued, exactly as for the blocking call, and the Pending
holds the input until the wait, so a buffer in flight is never freed
under the backend.

Transports (``TRANSPORTS``), chosen once by ``launch/mesh.py`` and
printed by the driver:

  * ``local``  — one rank, no process group;
  * ``direct`` — the backend takes the tensors where they lie: NCCL with
    a card per rank, gloo on the CPU, and gloo with CUDA tensors where
    several ranks share one card (PyTorch 2.11's gloo takes CUDA tensors
    for all three collectives). The point-to-point hop is NCCL's
    ``isend``/``irecv`` with a card a rank and gloo's on the CPU; gloo's
    ``send`` reads a CUDA tensor's pointer as host memory (PyTorch
    2.11's gloo aborts the process: ``writev ... Bad address``), so with
    CUDA tensors over gloo the hop goes through a host copy on each side
    (:data:`P2P_VIA_HOST`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("local", "direct")
# backends whose point-to-point ops take host memory only: a CUDA
# tensor's hop is staged through a host copy
P2P_VIA_HOST = ("gloo",)


class Pending:
    """A collective in flight: :meth:`wait` blocks until it is done (on
    CUDA tensors, orders the current stream after it) and returns its
    output; the input it holds is released then."""

    def __init__(self, out: torch.Tensor, work=None,
                 keep: Tuple[torch.Tensor, ...] = (), then=None):
        self._out, self._work, self._keep = out, work, keep
        self._then = then

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            self._then()
            self._then = None
        self._keep = ()
        return self._out


class Comm:
    def __init__(self, ranks: Sequence[int], rank: int, transport: str,
                 group: Optional[object] = None, backend: str = "gloo"):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport '{transport}'")
        self.ranks: Tuple[int, ...] = tuple(ranks)
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} not in group {self.ranks}")
        if len(self.ranks) > 1 and (group is None or transport == "local"):
            raise ValueError("a group of several ranks needs a process "
                             "group and a non-local transport")
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)      # my position in the group
        self.transport = transport
        self.group = group
        self.backend = backend
        self.sent_bytes = 0

    def all_to_all(self, x: torch.Tensor, send_rows: Sequence[int],
                   recv_rows: Sequence[int], async_op: bool = False):
        """``x``: the messages to each rank of the group in order,
        ``send_rows[j]`` rows for rank j. Returns the messages from each
        rank in order, ``recv_rows[j]`` rows from rank j (a
        :class:`Pending` of them with ``async_op``)."""
        send_rows, recv_rows = list(send_rows), list(recv_rows)
        if x.shape[0] != sum(send_rows) or len(send_rows) != self.size \
                or len(recv_rows) != self.size:
            raise ValueError(f"all_to_all: {x.shape[0]} rows, splits "
                             f"{send_rows} / {recv_rows} for {self.size} "
                             f"ranks")
        row = x[0].numel() * x.element_size() if x.shape[0] else 0
        self.sent_bytes += (sum(send_rows) - send_rows[self.index]) * row
        if self.size == 1:
            return Pending(x) if async_op else x
        out = x.new_empty((sum(recv_rows), *x.shape[1:]))
        x = x.contiguous()
        work = dist.all_to_all_single(out, x, output_split_sizes=recv_rows,
                                      input_split_sizes=send_rows,
                                      group=self.group, async_op=async_op)
        return Pending(out, work, (x,)) if async_op else out

    def all_gather(self, x: torch.Tensor, async_op: bool = False):
        """(…) -> (size, …), rank j's tensor at row j (a
        :class:`Pending` of it with ``async_op``)."""
        self.sent_bytes += (self.size - 1) * x.numel() * x.element_size()
        if self.size == 1:
            return Pending(x[None]) if async_op else x[None]
        out = x.new_empty((self.size, *x.shape))
        x = x.contiguous()
        work = dist.all_gather(list(out.unbind(0)), x, group=self.group,
                               async_op=async_op)
        return Pending(out, work, (x,)) if async_op else out

    def all_reduce(self, x: torch.Tensor,
                   op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """Sum (or ``op``) over the group, written into ``x``; returns
        ``x``."""
        if self.size > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def _via_host(self, x: torch.Tensor) -> bool:
        return x.device.type != "cpu" and self.backend in P2P_VIA_HOST

    def send(self, x: torch.Tensor, peer: int, tag: int = 0) -> Pending:
        """Post ``x`` to the group's rank ``peer`` (an index into the
        group); the :class:`Pending` holds ``x`` until its wait."""
        if peer == self.index or not 0 <= peer < self.size:
            raise ValueError(f"send to {peer} from {self.index} of "
                             f"{self.size}")
        x = x.contiguous()
        self.sent_bytes += x.numel() * x.element_size()
        wire = x.to("cpu") if self._via_host(x) else x
        work = dist.isend(wire, self.ranks[peer], group=self.group, tag=tag)
        return Pending(x, work, (x, wire))

    def recv(self, shape: Sequence[int], dtype: torch.dtype,
             device: torch.device, peer: int, tag: int = 0) -> Pending:
        """Post a receive of a ``shape``/``dtype`` tensor from the
        group's rank ``peer``; the :class:`Pending`'s wait returns it on
        ``device``."""
        if peer == self.index or not 0 <= peer < self.size:
            raise ValueError(f"recv from {peer} at {self.index} of "
                             f"{self.size}")
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        if not self._via_host(out):
            work = dist.irecv(out, self.ranks[peer], group=self.group,
                              tag=tag)
            return Pending(out, work, (out,))
        wire = torch.empty(tuple(shape), dtype=dtype)
        work = dist.irecv(wire, self.ranks[peer], group=self.group, tag=tag)
        return Pending(out, work, (wire,), then=lambda: out.copy_(wire))
