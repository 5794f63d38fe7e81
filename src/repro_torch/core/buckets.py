"""Bucketed flat-buffer gradient reduction
(port of ``repro/core/buckets.py``).

  * :func:`build_layout` assigns every leaf a contiguous range of one
    fp32 stream, padded so it divides into ``num_buckets`` buckets of
    ``bucket_elems`` elements. Leaves are taken in the JAX package's
    pytree flatten order (:func:`stream_leaves`: sorted dict keys; the
    port's per-layer list is one stacked (L, ...) leaf per name, layer 0
    first), so the grid, and which leaves share a quantization block,
    are the JAX package's.
  * :func:`pack_buckets` / :func:`unpack_buckets` move a parameter-shaped
    tree into and out of the (num_buckets, bucket_elems) fp32 stack.
  * :func:`exchange_buckets` is the reduction schedule over one
    :class:`~repro_torch.core.comm.Comm` group:

      fp32: a reduce-scatter (``all_to_all`` plus a sum in rank order)
            -> ``all_gather``
      int8: the send leg (error correction, quantize, the stage-1
            residual, the fused int8 payload in message order) ->
            ``all_to_all`` -> the receive leg (dequant-accumulate over
            the ranks, re-quantize the shard sum, the stage-2 residual)
            -> a ragged all-gather of the shard payloads -> the decode
            (``kernels/quantize/ops.py``: one CUDA kernel a leg on the
            card, kernels 4 and 5 in their fused forms)

    two collectives for each chunk of whole buckets. Unlike the JAX
    function it works in place, to keep a full-width rank's memory
    bounded: the result is written into ``buckets``, the new error
    state into ``err``. Chunking does not change a value: quantization
    is per block of 256 and the exchange elementwise per bucket (the JAX
    package's per-bucket pipeline agrees bitwise with its monolithic
    exchange).

The int8 exchange never puts the all-padding tail of the stream on the
wire (``total``): each message holds only data blocks, so messages are
ragged and the broadcast leg is an ``all_to_all`` whose input repeats
this rank's shard payload once per peer (``all_gather_into_tensor``
takes equal sizes only).

:func:`layout_record` / :func:`layout_fingerprint` describe a grid in
checkpoint ``meta.json`` exactly as the JAX package does (the same
fields, the same sha1 over the same JSON), so a checkpoint's packed
state is recognised across the two packages.

The packed optimizer path (``HetConfig.overlap``) reads per-leaf
structure through the grid a bucket at a time: :func:`bucket_runs` (the
JAX package's ``segment_ids`` row, run-length coded),
:func:`bucket_decay_mask` (its ``decay_mask`` row) and
:func:`bucket_pieces` (views of a tree's tensors at a bucket's
positions). One double-buffered driver, :class:`BucketFlushPipeline`,
runs the per-bucket exchange: bucket *k+1*'s send leg and its first
collective are issued before bucket *k*'s is waited on (``Comm``'s
``async_op``), and each landed bucket goes to a hook.
``overlap="backward"`` feeds it in the order :func:`bucket_readiness`
gives as the backward lands the gradients; ``overlap="buckets"`` (:func:`exchange_buckets_overlapped`,
after the backward) feeds it every bucket at once. It reuses the
monolithic exchange's legs on one bucket, so each bucket's result is
bitwise the same rows of :func:`exchange_buckets`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.capacity import host_shard_extents
from repro_torch.core.comm import Comm, Pending
from repro_torch.kernels.quantize import ops as q_ops

# fp32 bytes of the bucket stack one exchange chunk covers (whole
# buckets, at least one): bounds a rank's temporaries to a few times
# this, whatever the model's size. Read at each call.
EXCHANGE_CHUNK_BYTES = 1 << 30


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------


def stream_leaves(tree: Any) -> List[Tuple[Tuple[int, ...],
                                           List[torch.Tensor]]]:
    """The tree's leaves in JAX flatten order, as (shape, pieces): a dict
    is walked in sorted key order; a list (the layer stack) is one
    stacked leaf per name, shape (L, ...), whose pieces are the L layer
    tensors in order. Empty dicts contribute nothing."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in stream_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        per = [stream_leaves(t) for t in tree]
        if any(len(p) != len(per[0]) for p in per):
            raise ValueError("a stacked list needs one structure per item")
        return [((len(tree), *per[0][i][0]),
                 [t for p in per for t in p[i][1]])
                for i in range(len(per[0]))]
    return [(tuple(tree.shape), [tree])]


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static assignment of the stream's leaves to fixed-size fp32
    buckets (the JAX package's fields, without the treedef: the port
    packs and unpacks against a tree of the same structure)."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]        # leaf start in the flat stream
    sizes: Tuple[int, ...]          # leaf element counts
    total: int                      # sum(sizes)
    bucket_elems: int
    num_buckets: int

    @property
    def padded_total(self) -> int:
        return self.num_buckets * self.bucket_elems

    @property
    def bucket_bytes(self) -> int:
        return self.bucket_elems * 4

    @property
    def total_bytes(self) -> int:
        return self.total * 4

    def error_shape(self, ranks: int) -> Tuple[int, int, int]:
        return (ranks, self.num_buckets, self.bucket_elems)


def build_layout(tree: Any, *, bucket_mb: float = 4.0,
                 multiple_of: int = 1) -> BucketLayout:
    """The bucket grid for a tree of tensors (the JAX package's rule):
    ``bucket_elems`` is ``bucket_mb`` MiB of fp32 rounded up to
    ``multiple_of`` (ranks * block size for compressed exchanges), and
    never more than the padded total."""
    leaves = stream_leaves(tree)
    shapes = tuple(shape for shape, _ in leaves)
    dtypes = tuple(pieces[0].dtype for _, pieces in leaves)
    sizes = tuple(int(math.prod(s)) for s in shapes)
    offsets = []
    off = 0
    for n in sizes:
        offsets.append(off)
        off += n
    total = off
    if total == 0:
        raise ValueError("cannot bucket an empty tree")
    target = max(1, int(bucket_mb * (1 << 20) / 4))
    bucket_elems = -(-target // multiple_of) * multiple_of
    bucket_elems = min(bucket_elems, -(-total // multiple_of) * multiple_of)
    num_buckets = -(-total // bucket_elems)
    return BucketLayout(shapes=shapes, dtypes=dtypes, offsets=tuple(offsets),
                        sizes=sizes, total=total, bucket_elems=bucket_elems,
                        num_buckets=num_buckets)


# Bump when the serialized layout record changes incompatibly
# (checkpoint/repack.py validates it on restore).
LAYOUT_VERSION = 1

_FINGERPRINT_FIELDS = ("bucket_elems", "num_buckets", "total", "offsets",
                       "sizes", "shapes", "dtypes")


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``bfloat16``): the
    name the JAX package writes into a layout record."""
    return str(dtype).removeprefix("torch.")


def layout_fingerprint(record: Dict) -> str:
    """Stable short hash of the grid-defining fields of a layout record
    (``leaf_paths``, ``version`` and the host split are provenance, not
    the grid)."""
    body = {k: record[k] for k in _FINGERPRINT_FIELDS if k in record}
    return hashlib.sha1(
        json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


def layout_record(layout: BucketLayout,
                  leaf_paths: Optional[Sequence[str]] = None,
                  hosts: Optional[int] = None) -> Dict:
    """JSON-able versioned description of a :class:`BucketLayout`, as
    the JAX package saves it into checkpoint ``meta.json``: the grid,
    optionally the checkpoint key of every leaf and the v3 per-host
    split (``host_extents[k]``: the bucket rows host ``k`` writes)."""
    rec: Dict[str, Any] = {
        "version": LAYOUT_VERSION,
        "bucket_elems": int(layout.bucket_elems),
        "num_buckets": int(layout.num_buckets),
        "total": int(layout.total),
        "offsets": [int(o) for o in layout.offsets],
        "sizes": [int(s) for s in layout.sizes],
        "shapes": [list(s) for s in layout.shapes],
        "dtypes": [dtype_name(d) for d in layout.dtypes],
    }
    if leaf_paths is not None:
        rec["leaf_paths"] = [str(p) for p in leaf_paths]
    if hosts is not None:
        rec["hosts"] = int(hosts)
        rec["host_extents"] = [
            [lo, hi]
            for lo, hi in host_shard_extents(layout.num_buckets, hosts)]
    rec["fingerprint"] = layout_fingerprint(rec)
    return rec


def layout_from_record(record: Dict) -> BucketLayout:
    """Rebuild a :class:`BucketLayout` from its record; raises on a
    record version newer than this build reads."""
    version = int(record.get("version", 0))
    if version > LAYOUT_VERSION:
        raise ValueError(
            f"bucket layout record version {version} is newer than this "
            f"build supports ({LAYOUT_VERSION})")
    return BucketLayout(
        shapes=tuple(tuple(int(d) for d in s) for s in record["shapes"]),
        dtypes=tuple(getattr(torch, d) for d in record["dtypes"]),
        offsets=tuple(int(o) for o in record["offsets"]),
        sizes=tuple(int(s) for s in record["sizes"]),
        total=int(record["total"]),
        bucket_elems=int(record["bucket_elems"]),
        num_buckets=int(record["num_buckets"]))


def tree_pieces(tree: Any, layout: BucketLayout):
    """(stream offset, tensor) of every piece of every leaf."""
    leaves = stream_leaves(tree)
    if len(leaves) != len(layout.sizes):
        raise ValueError(f"tree has {len(leaves)} leaves, layout expects "
                         f"{len(layout.sizes)}")
    out = []
    for (shape, pieces), off, n in zip(leaves, layout.offsets, layout.sizes):
        if int(math.prod(shape)) != n:
            raise ValueError(f"leaf of shape {shape}, layout expects {n} "
                             f"elements")
        for t in pieces:
            out.append((off, t))
            off += t.numel()
    return out


def pack_buckets(tree: Any, layout: BucketLayout) -> torch.Tensor:
    """Tree -> (num_buckets, bucket_elems) fp32 stack (a new tensor on the
    tree's device; the padding tail is zero)."""
    pieces = tree_pieces(tree, layout)
    flat = torch.zeros(layout.padded_total, dtype=torch.float32,
                       device=pieces[0][1].device)
    for off, t in pieces:
        flat[off:off + t.numel()].copy_(t.reshape(-1))
    return flat.view(layout.num_buckets, layout.bucket_elems)


def unpack_buckets(buckets: torch.Tensor, layout: BucketLayout,
                   like: Any) -> Any:
    """(num_buckets, bucket_elems) -> a tree shaped like ``like``, each
    leaf in its ``like`` leaf's dtype: a view into ``buckets`` where that
    dtype is fp32 (no copy), a cast copy otherwise."""
    flat = buckets.reshape(-1)
    views = {}
    for off, t in tree_pieces(like, layout):
        v = flat[off:off + t.numel()].view(t.shape)
        views[id(t)] = v if t.dtype == torch.float32 else v.to(t.dtype)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return views[id(node)]

    return rebuild(like)


def init_error_buckets(layout: BucketLayout,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """This rank's flat error-feedback state."""
    return torch.zeros((layout.num_buckets, layout.bucket_elems),
                       dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# flat views of per-leaf structure (for the packed optimizer path)
# --------------------------------------------------------------------------


def bucket_runs(layout: BucketLayout, k: int
                ) -> List[Tuple[int, int, int]]:
    """Bucket ``k`` as ``(lo, hi, leaf)`` runs of bucket positions, in
    order, one per stream leaf it holds (a leaf is contiguous in the
    stream), the padding as leaf ``len(layout.sizes)``: the segment ids
    of the bucket, run-length coded, so a per-leaf reduction is one
    deterministic sum a run."""
    be = layout.bucket_elems
    lo_k, hi_k = k * be, (k + 1) * be
    runs = []
    for i, (off, n) in enumerate(zip(layout.offsets, layout.sizes)):
        lo, hi = max(off, lo_k), min(off + n, hi_k)
        if lo < hi:
            runs.append((lo - lo_k, hi - lo_k, i))
    end = min(layout.total, hi_k) - lo_k
    if end < be:
        runs.append((max(end, 0), be, len(layout.sizes)))
    return runs


def bucket_decay_mask(layout: BucketLayout, k: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Bucket ``k``'s (bucket_elems,) int8 weight-decay mask, the JAX
    package's ``decay_mask`` row k: 1 where the element's stream leaf
    is a matrix (``ndim >= 2`` of the stacked shape, the AdamW rule), 0
    for vector and scalar leaves and for the padding."""
    mask = torch.zeros(layout.bucket_elems, dtype=torch.int8, device=device)
    for lo, hi, i in bucket_runs(layout, k):
        if i < len(layout.shapes) and len(layout.shapes[i]) >= 2:
            mask[lo:hi] = 1
    return mask


def bucket_pieces(tree: Any, layout: BucketLayout
                  ) -> List[List[Tuple[int, int, torch.Tensor]]]:
    """For every bucket, ``(lo, hi, view)`` of each piece of ``tree``
    it holds: ``view`` is the piece's elements at bucket positions
    ``[lo, hi)``, a flat view into the tree's tensor (so writing it
    writes the tree)."""
    be = layout.bucket_elems
    out: List[List[Tuple[int, int, torch.Tensor]]] = [
        [] for _ in range(layout.num_buckets)]
    for off, t in tree_pieces(tree, layout):
        flat = t.view(-1)
        start, stop = off, off + flat.numel()
        while start < stop:
            k = start // be
            end = min(stop, (k + 1) * be)
            out[k].append((start - k * be, end - k * be,
                           flat[start - off:end - off]))
            start = end
    return out


def gather_bucket(pieces: Sequence[Tuple[int, int, torch.Tensor]],
                  bucket_elems: int, device: torch.device | str
                  ) -> torch.Tensor:
    """One bucket of a tree as a new fp32 (bucket_elems,) tensor (zero
    padding), from its :func:`bucket_pieces` entry."""
    out = torch.zeros(bucket_elems, dtype=torch.float32, device=device)
    for lo, hi, view in pieces:
        out[lo:hi].copy_(view)
    return out


def scatter_bucket(pieces: Sequence[Tuple[int, int, torch.Tensor]],
                   values: torch.Tensor) -> None:
    """Write a (bucket_elems,) bucket back into the tree's tensors, each
    piece cast to its tensor's dtype."""
    for lo, hi, view in pieces:
        view.copy_(values[lo:hi])


# --------------------------------------------------------------------------
# the exchange schedule
# --------------------------------------------------------------------------


def _chunk(num_buckets: int, bucket_elems: int) -> int:
    return max(1, min(num_buckets,
                      EXCHANGE_CHUNK_BYTES // (bucket_elems * 4)))


def chunk_buckets(layout: BucketLayout) -> int:
    """Whole buckets per exchange chunk."""
    return _chunk(layout.num_buckets, layout.bucket_elems)


def exchange_chunks(layout: BucketLayout) -> int:
    """How many chunks (of two collectives each) one exchange runs."""
    return -(-layout.num_buckets // chunk_buckets(layout))


def _issue(comm: Comm, wire: torch.Tensor, send: List[int],
           recv: List[int], async_op: bool) -> Pending:
    """A leg's ``all_to_all``, in flight with ``async_op``, else done."""
    if async_op:
        return comm.all_to_all(wire, send, recv, async_op=True)
    return Pending(comm.all_to_all(wire, send, recv))


def _send_fp32(x: torch.Tensor, comm: Comm, async_op: bool) -> Pending:
    """The reduce-scatter's message leg of an fp32 chunk (nbc, p, shard):
    slot j of every bucket to rank j."""
    nbc, p, shard = x.shape
    wire = x.transpose(0, 1).reshape(p * nbc, shard)
    return _issue(comm, wire, [nbc] * p, [nbc] * p, async_op)


def _finish_fp32(x: torch.Tensor, sent: Pending, comm: Comm) -> None:
    """The rest of an fp32 chunk: my shard summed in rank order, then
    the all-gather, written into ``x``."""
    nbc, p, shard = x.shape
    rx = sent.wait().view(p, nbc, shard)
    sh = rx[0].clone()
    for r in range(1, p):                       # fixed rank order
        sh += rx[r]
    del rx
    full = comm.all_gather(sh)                  # (p, nbc, shard)
    x.copy_(full.transpose(0, 1))


def _send_int8(x: torch.Tensor, e: Optional[torch.Tensor], comm: Comm,
               d_rows: int, block_size: int, impl: str, async_op: bool
               ) -> Tuple[Pending, List[int]]:
    """The send side of an int8 chunk (nbc, p, shard): the send leg
    (error correction, quantize of the data rows, the stage-1 residual
    in ``e``, the wire in message order: one launch on the card), then
    its ``all_to_all``."""
    wire, lens = q_ops.exchange_send(x, e, d_rows, block_size=block_size,
                                     impl=impl)
    return _issue(comm, wire, lens, [lens[comm.index]] * x.shape[1],
                  async_op), lens


def _finish_int8(x: torch.Tensor, e: Optional[torch.Tensor], comm: Comm,
                 sent: Tuple[Pending, List[int]], block_size: int,
                 impl: str) -> None:
    """The receive side of an int8 chunk: the receive leg (my shard
    summed over the ranks, re-quantized, the stage-2 residual into my
    slot of ``e``), the gather leg's ``all_to_all`` of every rank's
    shard payload, and the decode into ``x``: two launches on the
    card."""
    p = x.shape[1]
    me = comm.index
    pending, lens = sent
    rx = pending.wait().view(p, lens[me], block_size + 4)
    mine = q_ops.exchange_receive(rx, e, me, block_size=block_size,
                                  impl=impl)
    del rx
    gathered = comm.all_to_all(mine, [lens[me]] * p, lens)
    del mine
    q_ops.exchange_decode(gathered, lens, x, block_size=block_size,
                          impl=impl)


def _check_stack(buckets: torch.Tensor, err: Optional[torch.Tensor],
                 p: int, compress: bool, block_size: int) -> bool:
    """The exchange's shape rules; returns whether ``err`` is kept."""
    nb, be = buckets.shape
    if be % p:
        raise ValueError(f"bucket_elems {be} not divisible by {p} ranks; "
                         f"build the layout with multiple_of={p}")
    shard = be // p
    if compress and shard % block_size:
        raise ValueError(
            f"shard {shard} not divisible by block_size {block_size}; "
            f"build the layout with multiple_of={p * block_size}")
    if not buckets.is_contiguous() or buckets.dtype != torch.float32:
        raise ValueError("exchange_buckets: a contiguous fp32 stack")
    want_err = compress and err is not None
    if want_err and (err.shape != buckets.shape or not err.is_contiguous()):
        raise ValueError(f"err {tuple(err.shape)} must be a contiguous "
                         f"{tuple(buckets.shape)} stack")
    return want_err


def _data_rows(nb: int, be: int, compress: bool, block_size: int,
               total: Optional[int]) -> int:
    """Blocks of the stack that hold data (all of them without
    ``total``)."""
    n_rows = nb * (be // block_size if compress else 0)
    return (n_rows if total is None
            else max(1, min(n_rows, -(-total // block_size))))


def exchange_buckets(
    buckets: torch.Tensor,
    err: Optional[torch.Tensor] = None,
    *,
    comm: Comm,
    compress: bool = False,
    block_size: int = 256,
    impl: str = "reference",
    total: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All-reduce this rank's (num_buckets, bucket_elems) stack over
    ``comm``, in place: returns ``(buckets, err)`` holding the global
    sum and (compressed mode with ``err``) the new error state.

    ``total``: the stream's real element count (``layout.total``);
    compressed mode then quantizes and sends only the blocks that hold
    data, and pins the error state of the all-padding tail to zero, as
    the JAX package's ``exchange_buckets`` does."""
    nb, be = buckets.shape
    p = comm.size
    want_err = _check_stack(buckets, err, p, compress, block_size)
    shard = be // p
    step = _chunk(nb, be)
    rows_per_bucket = be // block_size if compress else 0
    d_rows = _data_rows(nb, be, compress, block_size, total)
    for k0 in range(0, nb, step):
        k1 = min(nb, k0 + step)
        x = buckets[k0:k1].view(k1 - k0, p, shard)
        if not compress:
            _finish_fp32(x, _send_fp32(x, comm, False), comm)
            continue
        e = err[k0:k1].view(k1 - k0, p, shard) if want_err else None
        d_c = min((k1 - k0) * rows_per_bucket,
                  max(0, d_rows - k0 * rows_per_bucket))
        _finish_int8(x, e, comm, _send_int8(x, e, comm, d_c, block_size,
                                            impl, False), block_size, impl)
    return buckets, (err if want_err else None)


# --------------------------------------------------------------------------
# the overlapped (double-buffered per-bucket) exchange pipeline
# --------------------------------------------------------------------------


def prepare_bucket(x_k: torch.Tensor, err_k: Optional[torch.Tensor], *,
                   comm: Comm, compress: bool, d_rows: int,
                   block_size: int, impl: str):
    """Send side for ONE bucket, ``x_k`` its (1, p, shard) view: in
    int8 the send leg (error correction, quantize, payload fusion), then
    the first collective, issued asynchronously and returned in flight.
    ``d_rows``: the bucket's data blocks."""
    if not compress:
        return _send_fp32(x_k, comm, True)
    return _send_int8(x_k, err_k, comm, d_rows, block_size, impl, True)


def exchange_prepared_bucket(x_k: torch.Tensor,
                             err_k: Optional[torch.Tensor], prepared, *,
                             comm: Comm, compress: bool, block_size: int,
                             impl: str) -> torch.Tensor:
    """Link and receive legs for ONE prepared bucket: waits on its first
    collective, then (int8) the receive leg, the gather leg and the
    decode. ``x_k`` ends holding the global sum
    and ``err_k`` its new error slice: bitwise the same rows of
    :func:`exchange_buckets` (the same legs on one bucket: quantization
    is per block of 256, the sums elementwise). Returns ``x_k``."""
    if not compress:
        _finish_fp32(x_k, prepared, comm)
    else:
        _finish_int8(x_k, err_k, comm, prepared, block_size, impl)
    return x_k


def bucket_legs(buckets: torch.Tensor, err: Optional[torch.Tensor], *,
                comm: Comm, compress: bool, block_size: int, impl: str,
                total: Optional[int] = None) -> Tuple[Callable, Callable]:
    """The per-bucket legs over a (num_buckets, bucket_elems) stack, in
    place: ``prep(k)`` issues bucket *k*'s send side
    (:func:`prepare_bucket`, only its data blocks in int8);
    ``exchange(k, prepared)`` completes it (``err[k]`` then holds the
    bucket's new error slice) and returns ``buckets[k]``, the reduced
    bucket."""
    nb, be = buckets.shape
    p = comm.size
    want_err = _check_stack(buckets, err, p, compress, block_size)
    x = buckets.view(nb, 1, p, be // p)
    e = err.view(nb, 1, p, be // p) if want_err else None
    rpb = be // block_size if compress else 0
    d_rows = _data_rows(nb, be, compress, block_size, total)

    def prep(k):
        return prepare_bucket(
            x[k], e[k] if want_err else None, comm=comm, compress=compress,
            d_rows=min(rpb, max(0, d_rows - k * rpb)),
            block_size=block_size, impl=impl)

    def exchange(k, prepared):
        exchange_prepared_bucket(x[k], e[k] if want_err else None,
                                 prepared, comm=comm, compress=compress,
                                 block_size=block_size, impl=impl)
        return buckets[k]

    return prep, exchange


def exchange_buckets_overlapped(
    buckets: torch.Tensor,
    err: Optional[torch.Tensor] = None,
    *,
    comm: Comm,
    compress: bool = False,
    block_size: int = 256,
    impl: str = "reference",
    total: Optional[int] = None,
    bucket_fn: Optional[Callable] = None,
) -> Tuple[List[Any], Optional[torch.Tensor]]:
    """:func:`exchange_buckets` as the per-bucket pipeline, in place:
    :class:`BucketFlushPipeline` with every bucket ready at once, so two
    collectives a bucket, bucket *k+1*'s send side issued before bucket
    *k*'s first collective is waited on, and each reduced bucket handed
    to ``bucket_fn(k, reduced_k)`` (a (bucket_elems,) view of
    ``buckets``) the moment it lands (the train step fuses the flat
    optimizer update there). The result is bitwise
    :func:`exchange_buckets`'s. Returns (the ``bucket_fn`` outputs in
    bucket order, ``err``)."""
    prep, exchange = bucket_legs(buckets, err, comm=comm, compress=compress,
                                 block_size=block_size, impl=impl,
                                 total=total)
    pipe = BucketFlushPipeline((0,) * buckets.shape[0],
                               lambda k, _raw: prep(k), exchange,
                               bucket_fn=bucket_fn)
    pipe.flush_ready_buckets(0, lambda k: None)
    return pipe.finish(), (err if compress else None)


# --------------------------------------------------------------------------
# backward-overlap readiness schedule (HetConfig.overlap="backward")
#
# Each leaf (or per-layer slice of a stacked leaf) occupies a contiguous
# range of the stream and is annotated with the backward stage at which
# its gradient is final (0 = head, s = layer L-s, L+1 = embedding); a
# bucket is ready at the LATEST stage of any element it holds.
# --------------------------------------------------------------------------


def bucket_readiness(layout: BucketLayout,
                     leaf_pieces: Sequence[Sequence[Tuple[int, int, int]]]
                     ) -> Tuple[int, ...]:
    """Per-bucket backward stage at which the bucket is flushable.
    ``leaf_pieces[i]``: stream leaf *i* as ``(offset_within_leaf,
    n_elems, stage)`` ranges, which must tile the leaf; padding never
    delays a flush."""
    if len(leaf_pieces) != len(layout.sizes):
        raise ValueError(
            f"leaf_pieces has {len(leaf_pieces)} entries, layout has "
            f"{len(layout.sizes)} leaves")
    ready = [0] * layout.num_buckets
    be = layout.bucket_elems
    for i, (off, size) in enumerate(zip(layout.offsets, layout.sizes)):
        covered = 0
        for p_off, n, stage in leaf_pieces[i]:
            if p_off != covered:
                raise ValueError(
                    f"leaf {i}: pieces must tile the leaf contiguously "
                    f"(expected offset {covered}, got {p_off})")
            covered += n
            start = off + p_off
            for k in range(start // be, (start + n - 1) // be + 1):
                if stage > ready[k]:
                    ready[k] = stage
        if covered != size:
            raise ValueError(
                f"leaf {i}: pieces cover {covered} of {size} elements")
    return tuple(ready)


class BucketFlushPipeline:
    """THE double-buffered per-bucket exchange driver, fed buckets in
    READINESS order (``overlap="backward"``: as the backward lands their
    gradients; ``"buckets"``: all at stage 0). For each ready bucket it
    runs ``prep(k, raw_k)`` (its send side, whose first collective it
    issues) FIRST, then ``exchange(k, prepared) -> reduced_k`` of the
    bucket prepped before (the double buffer), and hands each landed
    bucket to ``bucket_fn(k, reduced_k) -> out_k`` (the reduced bucket
    by default). Per-bucket results do not depend on the issue order."""

    def __init__(self, readiness: Sequence[int], prep: Callable,
                 exchange: Callable, *, bucket_fn: Optional[Callable] = None):
        self.readiness = tuple(int(s) for s in readiness)
        self.num_buckets = len(self.readiness)
        self._prep = prep
        self._exchange = exchange
        self._bucket_fn = bucket_fn or (lambda k, red: red)
        self._by_stage: Dict[int, List[int]] = {}
        for k, s in enumerate(self.readiness):
            self._by_stage.setdefault(s, []).append(k)
        self._pending: Optional[Tuple[int, Any]] = None
        self._outs: Dict[int, Any] = {}
        self._flushed: set = set()

    def _exchange_pending(self) -> None:
        k, prepared = self._pending
        self._pending = None
        self._outs[k] = self._bucket_fn(k, self._exchange(k, prepared))

    def flush_ready_buckets(self, stage: int, raw_of: Callable) -> None:
        """Feed every bucket whose readiness is ``stage``; ``raw_of(k)``
        gives bucket *k*'s raw payload at flush time."""
        for k in self._by_stage.get(int(stage), ()):
            if k in self._flushed:
                raise ValueError(f"bucket {k} flushed twice")
            self._flushed.add(k)
            nxt = (k, self._prep(k, raw_of(k)))
            if self._pending is not None:
                self._exchange_pending()
            self._pending = nxt

    def finish(self) -> List[Any]:
        """Exchange the last prepped bucket; returns the ``bucket_fn``
        outputs in BUCKET-INDEX order."""
        if self._pending is not None:
            self._exchange_pending()
        if len(self._flushed) != self.num_buckets:
            missing = sorted(set(range(self.num_buckets)) - self._flushed)
            raise ValueError(
                f"finish() before buckets {missing} were flushed: the "
                f"backward must visit every readiness stage")
        return [self._outs[k] for k in range(self.num_buckets)]


# --------------------------------------------------------------------------
# analytic link-byte model
# --------------------------------------------------------------------------


def modeled_link_bytes(layout: BucketLayout, ranks: int, *,
                       compress: bool = False,
                       block_size: int = 256) -> int:
    """Per-rank bytes on the reduction link for one bucketed exchange
    (the JAX package's model): uncompressed, reduce-scatter and
    all-gather each move (p-1)/p of the padded stack; compressed, both
    legs move (p-1)/p of the fused payload of the data blocks."""
    p = ranks
    n = layout.padded_total
    if not compress:
        return int(2 * (p - 1) / p * n * 4)
    blocks = -(-layout.total // block_size)
    payload = blocks * (block_size + 4)
    a2a = (p - 1) / p * payload
    ag = (p - 1) / p * payload
    return int(a2a + ag)


def modeled_bucket_link_bytes(layout: BucketLayout, ranks: int, k: int, *,
                              compress: bool = False,
                              block_size: int = 256) -> int:
    """Per-rank link bytes of bucket ``k`` in the per-bucket pipeline
    (the JAX package's model): :func:`modeled_link_bytes` on one
    bucket, only its data blocks in int8."""
    p = ranks
    if not compress:
        return int(2 * (p - 1) / p * layout.bucket_elems * 4)
    start = k * layout.bucket_elems
    data = max(0, min(layout.total - start, layout.bucket_elems))
    blocks = -(-data // block_size)
    return int(2 * (p - 1) / p * blocks * (block_size + 4))


def modeled_per_leaf_bytes(shapes: Sequence[Sequence[int]], ranks: int, *,
                           compress: bool = False,
                           block_size: int = 256) -> int:
    """Per-rank link bytes of the legacy per-leaf schedule, for leaves of
    the given shapes: a ring all-reduce per leaf uncompressed, an
    all-gather of every rank's full quantized payload compressed."""
    p = ranks
    total = 0
    for shape in shapes:
        n = int(math.prod(shape)) if len(shape) else 1
        if not compress:
            total += int(2 * (p - 1) / p * n * 4)
        else:
            blocks = -(-n // block_size)
            total += int((p - 1) * (blocks * block_size + blocks * 4))
    return total
