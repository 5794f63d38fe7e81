"""Layout-portable checkpoint repack (port of ``repro/checkpoint/repack.py``).

A checkpoint addresses its leaves by escaped ``/``-joined key paths
(``params/layers/attn/wq``, ``opt/step``, ``opt/m/...``, ``err`` or
``err/...``) and stores the state in the JAX package's layout, whichever
package wrote it. :func:`flatten_with_paths` walks a tree the way
``jax.tree_util`` does, so the port produces JAX's keys in JAX's order
without importing JAX:

  * a dict in sorted key order (a ``DictKey``: the escaped key);
  * a NamedTuple in field order (a ``GetAttrKey``: the field name);
  * a list or tuple in index order (a ``SequenceKey``: the index);
  * ``None`` and empty containers hold no leaf;
  * anything else is a leaf (a numpy array, or a :class:`ShapeDtype`
    in a template).

The order matters beyond the keys: packed moment stacks and the
error-feedback residual are the leaves' *flat stream* (every leaf
raveled and concatenated in flatten order), so unpacking a stack into
per-leaf moments needs the same order as the writer's.

:func:`adapt_arrays` rewrites the ``{key: array}`` dict a checkpoint
holds to fit a template: packed ``(num_buckets, bucket_elems)`` moments
of any grid <-> per-leaf moments through the flat stream (bit-exact:
packing is a reshape and a zero pad, and :func:`fit_stream` refuses to
drop a nonzero tail), and the residual across rank counts. The same
rank count is the identity; another rank count has no exact image of
each rank's residual, so the ranks' streams are summed and the sum is
split over the new ranks' contiguous stream extents (the sum is
conserved bit for bit; a rank's own residual is not). A template
without a residual ignores a saved one, and a template with one and a
checkpoint without starts from zeros.

Host-side numpy only: the driver converts between the port's tensors
and this layout (``launch/steps.py::state_to_host`` /
``state_from_host``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.capacity import host_shard_extents, plan_from_record

# The on-disk format the JAX package writes and reads: version 2 = escaped
# keys + structured meta + layout records in one gathered arrays.npz;
# version 3 = per-host shard files + a checksummed manifest.json. Version 2
# still loads; the key scheme is unchanged since version 2.
FORMAT_VERSION = 3

MOMENT_GROUPS = ("opt/m", "opt/v")
ERR_GROUP = "err"
PARAMS_PREFIX = "params/"


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A template leaf: what a restore needs of it (``jax``'s
    ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


# --------------------------------------------------------------------------
# path keys
# --------------------------------------------------------------------------


def _escape(component: str) -> str:
    """Injective escaping: no raw '/' survives, so joined keys decode
    uniquely back into components."""
    return component.replace("%", "%25").replace("/", "%2F")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key component, child) pairs in flatten order, or None for a
    leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(_escape(str(k)), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(_escape(f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _walk(node: Any, prefix: str):
    kids = _children(node)
    if kids is None:
        yield prefix, node
        return
    for comp, child in kids:
        yield from _walk(child, f"{prefix}/{comp}" if prefix else comp)


def flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """Ordered ``{escaped key path: leaf}``; raises on a collision."""
    out: Dict[str, Any] = {}
    for key, leaf in _walk(tree, ""):
        if key in out:
            raise ValueError(
                f"checkpoint path key collision: two leaves flatten to "
                f"'{key}'")
        out[key] = leaf
    return out


def unflatten_like(template: Any, leaves: Dict[str, Any]) -> Any:
    """The template's structure with ``leaves[key]`` at each leaf."""
    def build(node, prefix):
        kids = _children(node)
        if kids is None:
            return leaves[prefix]
        if node is None:
            return None
        if isinstance(node, dict):
            esc = {_escape(str(k)): k for k in node}
            got = {esc[c]: build(v, f"{prefix}/{c}" if prefix else c)
                   for c, v in kids}
            return {k: got[k] for k in node}
        vals = [build(v, f"{prefix}/{c}" if prefix else c) for c, v in kids]
        return type(node)(*vals) if _is_namedtuple(node) else \
            type(node)(vals)

    return build(template, "")


# --------------------------------------------------------------------------
# the flat stream
# --------------------------------------------------------------------------


def fit_stream(stream: np.ndarray, n: int, what: str = "state"
               ) -> np.ndarray:
    """The stream resized to exactly ``n`` elements: growing pads with
    zeros; shrinking verifies the dropped tail is all zero (nonzero data
    there means the checkpoint does not fit the target layout)."""
    flat = np.asarray(stream).reshape(-1)
    if flat.size == n:
        return flat
    if flat.size < n:
        out = np.zeros(n, flat.dtype)
        out[:flat.size] = flat
        return out
    if np.any(flat[n:]):
        raise ValueError(
            f"cannot repack '{what}': checkpoint holds nonzero data past "
            f"element {n} ({flat.size} saved) — the saved state does not "
            f"fit the target layout")
    return flat[:n]


def _sizes(shapes: Sequence[Sequence[int]]) -> List[int]:
    return [int(np.prod(s)) if len(s) else 1 for s in shapes]


# --------------------------------------------------------------------------
# group translation
# --------------------------------------------------------------------------


def _group_leaf_order(template: Dict[str, Any], saved_keys: List[str],
                      group: str) -> List[str]:
    """Stream order for a per-leaf group being packed: the template's
    ``params/`` flatten order transplanted onto the group prefix, else
    the saved order (the writer's flatten order of the same tree)."""
    subpaths = [k[len(PARAMS_PREFIX):] for k in template
                if k.startswith(PARAMS_PREFIX)]
    expected = [f"{group}/{s}" for s in subpaths]
    if subpaths and set(expected) == set(saved_keys):
        return expected
    return saved_keys


def _adapt_group(arrays: Dict[str, np.ndarray], template: Dict[str, Any],
                 group: str, record: Optional[Dict]) -> None:
    """Translate one moment group in place to the template's form."""
    saved_packed = group in arrays
    tpl_packed = group in template
    tpl_sub = [k for k in template if k.startswith(group + "/")]
    saved_sub = [k for k in arrays if k.startswith(group + "/")]

    if saved_packed and tpl_packed:
        tgt = tuple(int(d) for d in template[group].shape)
        if tuple(arrays[group].shape) == tgt:
            return
        if len(tgt) != 2:
            raise ValueError(
                f"packed group '{group}' restores into rank-{len(tgt)} "
                f"template leaf; expected (num_buckets, bucket_elems)")
        stream = np.asarray(arrays[group]).reshape(-1)
        if record is not None:
            stream = fit_stream(stream, int(record["total"]), group)
        arrays[group] = fit_stream(stream, tgt[0] * tgt[1],
                                   group).reshape(tgt)
    elif saved_packed and not tpl_packed:
        if not tpl_sub:
            return                     # template holds no such group
        sizes = _sizes([template[k].shape for k in tpl_sub])
        total = sum(sizes)
        if record is not None and int(record["total"]) != total:
            raise ValueError(
                f"layout mismatch unpacking '{group}': checkpoint stream "
                f"holds {record['total']} elements, template pytree "
                f"expects {total} (fingerprint "
                f"{record.get('fingerprint', '?')})")
        stream = fit_stream(arrays.pop(group), total, group)
        off = 0
        for key, n in zip(tpl_sub, sizes):
            arrays[key] = stream[off:off + n].reshape(template[key].shape)
            off += n
    elif not saved_packed and tpl_packed:
        if not saved_sub:
            return                     # nothing saved -> missing-leaf error
        order = _group_leaf_order(template, saved_sub, group)
        stream = np.concatenate(
            [np.asarray(arrays.pop(k)).reshape(-1) for k in order])
        nb, be = (int(d) for d in template[group].shape)
        arrays[group] = fit_stream(stream, nb * be, group).reshape(nb, be)


def _redistribute_ranks(streams: np.ndarray, target_ranks: int
                        ) -> np.ndarray:
    """(ranks, n) residual streams -> (target_ranks, n): the identity
    for the same rank count; otherwise the sum over the ranks, each
    element on the one new rank whose contiguous extent holds it."""
    ranks = streams.shape[0]
    if ranks == target_ranks:
        return streams
    total = streams.sum(axis=0)
    out = np.zeros((target_ranks, streams.shape[1]), streams.dtype)
    for r, (lo, hi) in enumerate(host_shard_extents(streams.shape[1],
                                                    target_ranks)):
        out[r, lo:hi] = total[lo:hi]
    return out


def _adapt_err(arrays: Dict[str, np.ndarray],
               template: Dict[str, Any]) -> None:
    """Translate the error-feedback group to the template's form: flat
    (ranks, num_buckets, bucket_elems) stacks, per-leaf (ranks, *leaf)
    mirrors, or absence on either side."""
    tpl_flat = ERR_GROUP in template
    tpl_sub = [k for k in template if k.startswith(ERR_GROUP + "/")]
    if not tpl_flat and not tpl_sub:
        return
    saved_flat = ERR_GROUP in arrays
    saved_sub = [k for k in arrays if k.startswith(ERR_GROUP + "/")]

    streams: Optional[np.ndarray] = None
    if saved_flat:
        a = np.asarray(arrays.pop(ERR_GROUP))
        streams = a.reshape(a.shape[0], -1)
    elif saved_sub:
        order = _group_leaf_order(template, saved_sub, ERR_GROUP)
        per_leaf = [np.asarray(arrays.pop(k)) for k in order]
        ranks = per_leaf[0].shape[0]
        streams = np.concatenate(
            [a.reshape(ranks, -1) for a in per_leaf], axis=1)

    if tpl_flat:
        ranks_t, nb, be = (int(d) for d in template[ERR_GROUP].shape)
        if streams is None:
            arrays[ERR_GROUP] = np.zeros((ranks_t, nb, be), np.float32)
            return
        streams = _redistribute_ranks(streams, ranks_t)
        arrays[ERR_GROUP] = np.stack(
            [fit_stream(s, nb * be, ERR_GROUP) for s in streams]
        ).reshape(ranks_t, nb, be)
    else:
        ranks_t = int(template[tpl_sub[0]].shape[0])
        shapes = [tuple(int(d) for d in template[k].shape[1:])
                  for k in tpl_sub]
        sizes = _sizes(shapes)
        total = sum(sizes)
        if streams is None:
            for key in tpl_sub:
                arrays[key] = np.zeros(template[key].shape, np.float32)
            return
        streams = _redistribute_ranks(streams, ranks_t)
        fitted = np.stack([fit_stream(s, total, ERR_GROUP)
                           for s in streams])
        off = 0
        for key, n, shape in zip(tpl_sub, sizes, shapes):
            arrays[key] = fitted[:, off:off + n].reshape(
                (ranks_t,) + shape)
            off += n


def _check_stage_record(record: Any) -> None:
    """The JAX package's ``pipeline.stage_from_record`` checks: a
    malformed record means the writer was broken, so the restore
    fails."""
    if not isinstance(record, dict):
        raise ValueError(f"malformed stage-plan record: expected dict, got "
                         f"{type(record).__name__}")
    try:
        plan = plan_from_record(record["plan"])
        num_layers = int(record["num_layers"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed stage-plan record: {e!r}") from e
    if int(plan.rows_per_rank.sum()) != num_layers:
        raise ValueError(
            f"malformed stage-plan record: layers_per_stage sums to "
            f"{int(plan.rows_per_rank.sum())}, num_layers={num_layers}")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def adapt_arrays(arrays: Dict[str, np.ndarray], template: Any,
                 fmt: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Rewrite a loaded ``{path key: array}`` dict to fit ``template``
    (only each leaf's ``.shape`` is read). ``fmt`` is meta.json's
    ``"format"`` block: its version, which fields were saved packed, and
    the layout record that tightens the checks; the translation itself
    is structural."""
    fmt = fmt or {}
    version = fmt.get("version")
    if version is not None and int(version) > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format version {version} is newer than this "
            f"build supports ({FORMAT_VERSION})")
    if fmt.get("pipeline") is not None:
        _check_stage_record(fmt["pipeline"])
    record = fmt.get("layout") or None

    template_flat = flatten_with_paths(template)
    out = dict(arrays)
    groups = list(MOMENT_GROUPS)
    for g in fmt.get("packed_fields") or ():
        if g not in groups and g != ERR_GROUP:
            groups.append(g)
    for g in groups:
        _adapt_group(out, template_flat, g, record)
    _adapt_err(out, template_flat)
    return out
