"""Train state, the data-parallel train step, and the static-batch
serve steps (port of ``repro/launch/steps.py``).

The JAX package's jitted ``build_prefill_step`` / ``build_decode_step``
become plain closures under ``torch.inference_mode()`` (no jit, no
shardings on one device); :func:`repro_torch.launch.serve.static_generate`
runs them.

The JAX step runs one SPMD program over a mesh; here each data-parallel
rank is a process (``launch/mesh.py::ProcessMesh``) that runs the step
on its own rows of the packed global batch, and the mesh's named-axis
collectives become process-group collectives. The HetSeq arithmetic is
the JAX step's: the gradient of the objective SUM and the weight sum per
microbatch (``accum_steps`` microbatches of this rank's rows), summed in
fp32, summed over the ranks, divided by the global weight sum exactly
once, then global-norm clip and AdamW. Dummy rows carry weight 0 and
run forward and backward like real ones; a rank of capacity 0 holds
only dummy rows and still takes part in every collective.

Gradient reductions (``HetConfig.grad_reduction``), over the ranks:

  * "allreduce" — one fp32 all-reduce per leaf over every rank (the
    JAX package leaves it to XLA);
  * "bucketed_allreduce" — the fp32 bucket exchange over every rank
    (``core/buckets.py::exchange_buckets``);
  * "hierarchical" (a mesh with a ``pod`` axis) — an fp32 all-reduce
    over the ranks of my pod, then the cross-pod leg over the ranks with
    my data index: with ``bucket_mb > 0`` the bucket exchange
    (:func:`_reduce_bucketed`), ``compression`` "none" or "int8" (the
    CUDA quantize and dequant-accumulate kernels on the card), with
    error feedback held in one flat (num_buckets, bucket_elems) stack
    per rank; with ``bucket_mb == 0`` the legacy per-leaf walk
    (:func:`_cross_pod_reduce`, plain torch, as the JAX package's is
    plain jnp). Every data rank of a pod runs the same cross-pod leg
    on the same pod sum, so they hold the same error state.

Every rank applies the same update to the same reduced gradient, so the
parameters stay bitwise identical across ranks.

Checkpoints hold the state in the JAX package's layout (the layer stack
stacked, every pod's residual in one ``(pods, ...)`` array):
:func:`state_shapes` and :func:`checkpoint_format` are the JAX package's
template and format block, :func:`state_to_host` and
:func:`state_from_host` move a rank's ``TrainState`` there and back.

``overlap``, ``pipeline_stages > 1``, ``weighting="canonical"`` and
LAMB raise "not ported yet".
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import repack
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import buckets as bkt
from repro_torch.core import weighting
from repro_torch.core.accumulate import (accumulate_grads, accumulate_sums,
                                         split_microbatches, value_and_grad)
from repro_torch.core.comm import Comm
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import convert
from repro_torch.models import transformer as tr
from repro_torch.models.blocks import dtype_of
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import adam, schedules

# quantization block size for the compressed cross-pod exchanges
_BLOCK = 256


class TrainState(NamedTuple):
    params: Any
    opt: adam.AdamState
    # error-feedback state, or () when unused: the bucketed reduction's
    # flat (num_buckets, bucket_elems) fp32 stack of this rank (its pod's
    # slice of the JAX package's (pods, nb, be) array); the legacy
    # per-leaf reduction's fp32 tree shaped like the parameters
    err: Any


def _mesh(mesh: Optional[ProcessMesh], model: Model) -> ProcessMesh:
    return mesh if mesh is not None else mesh_mod.local(device=model.device)


def _hier(tcfg: TrainConfig, mesh: ProcessMesh) -> bool:
    return (tcfg.het.grad_reduction == "hierarchical"
            and "pod" in mesh.axis_names)


def _err_enabled(tcfg: TrainConfig, mesh: ProcessMesh) -> bool:
    return (_hier(tcfg, mesh) and tcfg.het.compression != "none"
            and tcfg.het.error_feedback)


def _reduce_axes(tcfg: TrainConfig, mesh: ProcessMesh) -> Tuple[str, ...]:
    """The mesh axes the explicit bucketed reduction runs over."""
    if tcfg.het.grad_reduction == "bucketed_allreduce":
        return mesh.dp_axes
    return ("pod",) if "pod" in mesh.axis_names else ()


def bucket_layout(tcfg: TrainConfig, mesh: ProcessMesh,
                  params: Any) -> Optional[bkt.BucketLayout]:
    """The gradient bucket grid for this (config, mesh, parameter tree):
    every bucket divides into per-rank shards of whole quantization
    blocks (``multiple_of = ranks * 256``)."""
    if tcfg.het.bucket_mb <= 0:
        return None
    axes = _reduce_axes(tcfg, mesh)
    if not axes:
        return None
    ranks = 1
    for a in axes:
        ranks *= mesh.sizes[a]
    return bkt.build_layout(params, bucket_mb=tcfg.het.bucket_mb,
                            multiple_of=ranks * _BLOCK)


def validate_train_config(model: Model, tcfg: TrainConfig,
                          mesh: Optional[ProcessMesh] = None) -> None:
    """The JAX package's config checks, then what this port runs: raises
    ``ValueError`` for an invalid config and ``NotImplementedError`` for
    a valid mode that is not ported yet."""
    het = tcfg.het.validate()
    mesh = _mesh(mesh, model)
    if not 0.0 <= tcfg.label_smoothing < 1.0:
        raise ValueError(
            f"TrainConfig.label_smoothing must be in [0, 1), got "
            f"{tcfg.label_smoothing}")
    if het.grad_reduction == "bucketed_allreduce" and not mesh.dp_axes:
        raise ValueError(
            "grad_reduction='bucketed_allreduce' needs a mesh with "
            f"data-parallel axes; got {mesh.axis_names}")
    tr.check_supported(model.cfg)
    unported = [
        (het.overlap != "none", f"overlap='{het.overlap}'"),
        (het.pipeline_stages > 1,
         f"pipeline_stages={het.pipeline_stages}"),
        (het.weighting == "canonical", "weighting='canonical'"),
        (tcfg.optimizer.name != "adamw",
         f"optimizer '{tcfg.optimizer.name}'"),
    ]
    missing = [name for bad, name in unported if bad]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not ported yet (repro_torch trains "
            f"with grad_reduction allreduce, bucketed_allreduce or "
            f"hierarchical, no overlap, no pipeline stages, and AdamW)")


def init_train_state(model: Model, tcfg: TrainConfig,
                     seed: int | None = None,
                     mesh: Optional[ProcessMesh] = None) -> TrainState:
    """Parameters from ``seed`` (default ``tcfg.seed``) on the model's
    device (the same on every rank), zero AdamW moments and a zero
    error-feedback state where the config keeps one."""
    mesh = _mesh(mesh, model)
    params = model.init_params(tcfg.seed if seed is None else seed)
    return TrainState(params=params,
                      opt=adam.init_state(params, tcfg.optimizer),
                      err=init_error_state(tcfg, mesh, params))


def init_error_state(tcfg: TrainConfig, mesh: ProcessMesh,
                     params: Any) -> Any:
    if not _err_enabled(tcfg, mesh):
        return ()
    dev = tree_leaves(params)[0].device
    layout = bucket_layout(tcfg, mesh, params)
    if layout is not None:
        return bkt.init_error_buckets(layout, dev)
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=dev), params)


# --------------------------------------------------------------------------
# checkpoints: the state in the JAX package's layout
# --------------------------------------------------------------------------


def _param_shapes(model: Model) -> Any:
    """The port's parameter tree as shapes and dtypes only (fake tensors:
    nothing is drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return tr.init_params(model.cfg, 0, "cpu")


def _spec(shape, dtype: torch.dtype) -> repack.ShapeDtype:
    return repack.ShapeDtype(tuple(int(d) for d in shape),
                             np.dtype(bkt.dtype_name(dtype)))


def checkpoint_format(model: Model, tcfg: TrainConfig,
                      mesh: ProcessMesh) -> Dict[str, Any]:
    """The checkpoint ``"format"`` meta block, as the JAX package writes
    it for a config without overlap or pipeline stages: pytree moments,
    no layout record, one writer file a pod (``hosts``)."""
    del model                       # the layout record needs overlap
    return {"version": repack.FORMAT_VERSION, "state": "pytree",
            "packed_fields": [], "layout": None,
            "hosts": mesh.sizes.get("pod", 1),
            "overlap": tcfg.het.overlap, "pipeline": None}


def state_shapes(model: Model, tcfg: TrainConfig,
                 mesh: ProcessMesh) -> TrainState:
    """The restore template: the JAX package's ``state_shapes`` for this
    config, leaves as ``repack.ShapeDtype`` (the layer stack stacked,
    the residual as every pod's: ``(pods, nb, be)`` bucketed or a
    ``(pods, *leaf)`` mirror)."""
    fake = _param_shapes(model)
    ocfg = tcfg.optimizer

    def specs(dtype=None):
        return convert.to_jax_layout(
            fake, lambda t: _spec(t.shape, dtype or t.dtype),
            lambda ts: _spec((len(ts), *ts[0].shape), dtype or ts[0].dtype))

    err: Any = ()
    if _err_enabled(tcfg, mesh):
        pods = mesh.sizes["pod"]
        layout = bucket_layout(tcfg, mesh, fake)
        if layout is not None:
            err = _spec(layout.error_shape(pods), torch.float32)
        else:
            err = convert.to_jax_layout(
                fake, lambda t: _spec((pods, *t.shape), torch.float32),
                lambda ts: _spec((pods, len(ts), *ts[0].shape),
                                 torch.float32))
    return TrainState(
        params=specs(),
        opt=adam.AdamState(step=_spec((), torch.int32),
                           m=specs(dtype_of(ocfg.m_dtype)),
                           v=specs(dtype_of(ocfg.v_dtype))),
        err=err)


def state_to_host(state: TrainState, tcfg: TrainConfig,
                  mesh: ProcessMesh) -> Optional[TrainState]:
    """This rank's state in the JAX layout as fresh numpy copies, each
    leaf in its own dtype, for ``CheckpointManager.save``: the residual
    of every pod gathered over the pod group (a collective when the
    config keeps one: every rank calls this at the same step). Rank 0
    gets the state (the parameters and moments are the same on every
    rank), the other ranks None."""
    err: Any = ()
    if _err_enabled(tcfg, mesh):
        comm = mesh.pod

        def gather(t):
            return comm.all_gather(t).to("cpu", copy=True).numpy()

        if isinstance(state.err, torch.Tensor):
            err = gather(state.err)
        else:
            err = convert.to_jax_layout(
                state.err, gather,
                lambda ts: np.stack([gather(t) for t in ts], axis=1))
    if mesh.rank != 0:
        return None
    return TrainState(
        params=convert.params_to_host(state.params),
        opt=adam.AdamState(
            step=state.opt.step.to("cpu", copy=True).numpy(),
            m=convert.params_to_host(state.opt.m),
            v=convert.params_to_host(state.opt.v)),
        err=err)


def state_from_host(host: TrainState, model: Model, tcfg: TrainConfig,
                    mesh: ProcessMesh) -> TrainState:
    """A restored host state (``state_shapes``' layout) on this rank's
    device: the per-layer lists split back out, this pod's row of the
    residual."""
    cfg, dev = model.cfg, model.device

    def tree(t):
        return convert.params_from_jax(t, cfg, dev)

    err: Any = ()
    if _err_enabled(tcfg, mesh):
        pod = mesh.pod_index
        if isinstance(host.err, np.ndarray):
            err = torch.from_numpy(np.ascontiguousarray(
                host.err[pod])).to(dev, copy=True)
        else:
            err = tree(_map_leaves(host.err, lambda a: a[pod]))
    return TrainState(
        params=tree(host.params),
        opt=adam.AdamState(
            step=torch.tensor(int(host.opt.step), dtype=torch.int32,
                              device=dev),
            m=tree(host.opt.m), v=tree(host.opt.v)),
        err=err)


def _map_leaves(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def loss_and_grads(model: Model, tcfg: TrainConfig, params: Any,
                   batch: Dict[str, torch.Tensor], *, ce_impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """The single-process gradient computation without the update:
    returns (loss, weight_sum, grads), loss and grads of the weighted
    mean over every real token of ``batch`` (all ``accum_steps``
    microbatches), divided by the summed weight once."""
    grads, loss, w = accumulate_grads(
        model.loss_fn, params,
        split_microbatches(batch, max(1, tcfg.het.accum_steps)),
        ce_impl=ce_impl, label_smoothing=tcfg.label_smoothing)
    return loss, w, grads


# --------------------------------------------------------------------------
# gradient reduction modes
# --------------------------------------------------------------------------


def _quant_lastdim(x: torch.Tensor, block: int):
    """Blockwise int8 quantization along the LAST dim only (the JAX
    package's, which keeps every other dim's sharding)."""
    last = x.shape[-1]
    bs = min(block, last)
    pad = (-last) % bs
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    nb = x.shape[-1] // bs
    q, s = q_ref.quantize_blocks(x.reshape(-1, bs))
    return (q.reshape(*x.shape[:-1], nb, bs), s.reshape(*x.shape[:-1], nb),
            last)


def _dequant_lastdim(q: torch.Tensor, scale: torch.Tensor, last: int):
    deq = q.to(torch.float32) * scale[..., None]
    deq = deq.reshape(*deq.shape[:-2], -1)
    return deq[..., :last]


def _cross_pod_reduce(grads: Any, err: Any, compress: str, comm: Comm,
                      block_size: int = _BLOCK) -> Tuple[Any, Any]:
    """LEGACY per-leaf walk over the pod group: one all-reduce per leaf,
    or, compressed, one quantize and one gather of every pod's full int8
    payload per leaf (two collectives: values and scales). ``err``: this
    pod's error tree, or () with error feedback off."""
    def leaf(g, e):
        if compress == "none":
            return comm.all_reduce(g), e
        gf = g.to(torch.float32)
        squeeze = gf.dim() == 1
        if squeeze:
            gf = gf[None]
        corrected = gf + (e.reshape(gf.shape) if e is not None else 0.0)
        q, s, last = _quant_lastdim(corrected, block_size)
        new_e = None
        if e is not None:
            new_e = (corrected - _dequant_lastdim(q, s, last)).reshape(
                e.shape)
        q_all = comm.all_gather(q)
        s_all = comm.all_gather(s)
        deq = q_all[0].to(torch.float32) * s_all[0][..., None]
        for r in range(1, comm.size):           # fixed pod order
            deq = deq + q_all[r].to(torch.float32) * s_all[r][..., None]
        out = deq.reshape(*deq.shape[:-2], -1)[..., :last]
        if squeeze:
            out = out[0]
        return out.to(g.dtype), new_e

    if isinstance(err, tuple) and err == ():
        return tree_map(lambda g: leaf(g, None)[0], grads), ()
    pairs = tree_map(lambda g, e: leaf(g, e), grads, err)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))


def _reduce_bucketed(grads: Any, err: Optional[torch.Tensor], *,
                     comm: Comm, compress: str, layout: bkt.BucketLayout,
                     impl: str, block_size: int = _BLOCK
                     ) -> Tuple[Any, Optional[torch.Tensor]]:
    """Pack the gradient tree into the bucket stack, exchange it (in
    place, in chunks of whole buckets) and return the reduced tree as
    views into the stack, with the new error state (written into
    ``err``). The tree and the stack are both held through the exchange
    (4.7 GB each at olmo-1b); the exchange's own temporaries are bounded
    by its chunk."""
    flat = bkt.pack_buckets(grads, layout)
    red, new_e = bkt.exchange_buckets(
        flat, err, comm=comm, compress=(compress != "none"),
        block_size=block_size, impl=impl, total=layout.total)
    return bkt.unpack_buckets(red, layout, grads), new_e


def reduce_grads(model: Model, tcfg: TrainConfig, mesh: ProcessMesh,
                 layout: Optional[bkt.BucketLayout], state: TrainState,
                 batch: Dict[str, torch.Tensor], *,
                 ce_impl: str = "kernel", q_impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, torch.Tensor, Any, Any]:
    """This rank's half of the step: the gradient of the objective sum
    over its rows, reduced over the ranks and divided by the global
    weight once. Returns (loss, weight sum) over every rank, the
    gradient of the weighted mean and the new error state. The bytes
    put on the reduction link are counted by the mesh's ``Comm``
    objects (``sent_bytes``)."""
    het = tcfg.het
    accum = max(1, het.accum_steps)

    def grad_fn(p, mb):
        return value_and_grad(model.loss_fn, p, mb, ce_impl=ce_impl,
                              label_smoothing=tcfg.label_smoothing)

    g, o, w_local = accumulate_sums(grad_fn, state.params,
                                    split_microbatches(batch, accum))
    loss, w = weighting.psum_weighted(o, w_local, mesh.world)
    err = state.err
    if _hier(tcfg, mesh):
        if mesh.data.size > 1:                  # in-pod leg, fp32
            g = tree_map(mesh.data.all_reduce, g)
        comm, compress = mesh.pod, het.compression
    elif het.grad_reduction == "bucketed_allreduce":
        comm, compress = mesh.world, "none"
    else:
        return loss, w, weighting.weighted_grad_psum(g, w_local,
                                                     mesh.world), err
    use_err = _err_enabled(tcfg, mesh)
    if layout is not None:
        g, new_err = _reduce_bucketed(
            g, err if use_err else None, comm=comm, compress=compress,
            layout=layout, impl=q_impl)
        err = new_err if use_err else err
    else:
        g, new_err = _cross_pod_reduce(g, err if use_err else (), compress,
                                       comm)
        err = new_err if use_err else err
    inv = 1.0 / torch.clamp(w, min=1e-9)    # weighting.scale_grads in place
    return loss, w, tree_map(lambda t: t.mul_(inv.to(t.dtype)), g), err


def build_train_step(model: Model, tcfg: TrainConfig,
                     mesh: Optional[ProcessMesh] = None
                     ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                             Dict]]:
    """``step(state, batch) -> (state', metrics)`` for this rank, with
    metrics ``loss``, ``weight``, ``grad_norm`` and ``lr`` (0-dim
    tensors, the same on every rank), as the JAX step returns.
    ``batch``: this rank's rows, inputs, labels (B, S) int and weights
    (B, S) float on the model's device (on one rank, the whole packed
    batch). Attention, cross entropy and the int8 exchange go through
    the kernels (``ce_impl="kernel"``; ``HetConfig.quantize_impl``
    "pallas" maps to the kernels, "reference" to the plain versions).
    The update and the new error state are written into the state's
    tensors (``adam.apply_update``), so the state passed in is the state
    returned."""
    mesh = _mesh(mesh, model)
    validate_train_config(model, tcfg, mesh)
    ocfg = tcfg.optimizer
    q_impl = q_ops.impl_of(tcfg.het.quantize_impl)
    layouts: Dict[str, Optional[bkt.BucketLayout]] = {}

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if "layout" not in layouts:
            layouts["layout"] = bucket_layout(tcfg, mesh, state.params)
        loss, w, grads, err = reduce_grads(
            model, tcfg, mesh, layouts["layout"], state, batch,
            q_impl=q_impl)
        lr = schedules.learning_rate(ocfg, state.opt.step + 1)
        params, opt, met = adam.apply_update(state.params, grads, state.opt,
                                             ocfg, lr)
        return (TrainState(params=params, opt=opt, err=err),
                {"loss": loss, "weight": w, **met})

    return step


def params_checksum(params: Any) -> int:
    """An integer that changes with any bit of any parameter: the int64
    sum of every fp32 leaf's bits read as int32 (bf16 leaves as int16)."""
    total = 0
    for p in tree_leaves(params):
        bits = p.detach().contiguous().view(
            torch.int16 if p.element_size() == 2 else torch.int32)
        total += int(bits.sum(dtype=torch.int64))
    return total


# --------------------------------------------------------------------------
# serve steps (static batch, contiguous cache)
# --------------------------------------------------------------------------


def build_prefill_step(model: Model, shape: ShapeConfig):
    """``prefill(params, inputs) -> (next-token logits (B, V), cache)``
    with the contiguous cache covering ``shape.seq_len`` positions."""
    def prefill(params, inputs: torch.Tensor):
        with torch.inference_mode():
            return model.prefill(params, inputs, max_len=shape.seq_len)
    return prefill


def build_decode_step(model: Model, shape: ShapeConfig):
    """``decode(params, tokens, cache, pos) -> (logits (B, V), cache)``;
    the cache (from the prefill step) is updated in place."""
    del shape       # the cache carries its own length

    def decode(params, tokens: torch.Tensor, cache, pos: int):
        with torch.inference_mode():
            return model.decode(params, tokens, cache, pos)
    return decode
