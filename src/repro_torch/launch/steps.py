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
parameters stay bitwise identical across ranks. The optimizer is AdamW
or LAMB (``optim/{adam,lamb}.py``).

Overlap (``HetConfig.overlap``, the bucketed reductions only; a mesh
without reduction axes falls back to the monolithic step, as in the JAX
package): the optimizer moments live packed, one (num_buckets,
bucket_elems) stack each, and the update runs a bucket at a time on
views of the parameters (``core/buckets.py::bucket_pieces``):

  * "buckets" — the gradient as above, then the per-bucket pipeline
    (``exchange_buckets_overlapped``: bucket k+1's send side and first
    collective issued before bucket k's is waited on), each landed
    bucket's AdamW update fused in;
  * "backward" — one backward per microbatch whose autograd hooks add
    every landed leaf gradient into the fp32 stream and flush each
    bucket the moment the backward stage of its last piece completes
    (``BucketFlushPipeline``, readiness from the layer partition: layer
    l is stage L-l, the head 0, the embedding L+1). The global weight
    sum is reduced after the last microbatch's forward, before its
    backward; earlier microbatches only accumulate.

Global-norm clipping keeps the pipelined exchange but updates behind a
barrier (the clip factor needs every bucket); so does LAMB under
"buckets", while "backward" streams LAMB's moments and norm partials
and applies the trust ratios in one trailing pass. In fp32 with
``grad_clip=0`` both modes are bitwise the monolithic step.

``weighting="canonical"``: every row of the global batch (every rank
is given all of it, in global-row order) runs as its own one-row batch;
each rank takes an equal, plan-independent share of the rows and folds
their gradients in row order into one fp32 stream, and the ranks' sums
are added in rank order (the fp32 bucket exchange), so the step is
bitwise the same under any capacity plan.

Checkpoints hold the state in the JAX package's layout (the layer stack
stacked, every pod's residual in one ``(pods, ...)`` array):
:func:`state_shapes` and :func:`checkpoint_format` are the JAX package's
template and format block, :func:`state_to_host` and
:func:`state_from_host` move a rank's ``TrainState`` there and back.

``pipeline_stages > 1`` raises "not ported yet".
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
from repro_torch.optim import adam, lamb, schedules

# quantization block size for the compressed cross-pod exchanges
_BLOCK = 256
# the canonical step's stream grid when the config has no bucket_mb (a
# grid only bounds the rank-order exchange's chunks: no value depends
# on it)
_CANONICAL_BUCKET_MB = 25.0


class TrainState(NamedTuple):
    params: Any
    opt: adam.AdamState
    # overlap: opt.m and opt.v are packed (num_buckets, bucket_elems)
    # stacks; error-feedback state, or () when unused: the bucketed
    # reduction's
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


def _overlap_enabled(tcfg: TrainConfig, mesh: ProcessMesh) -> bool:
    """Whether this config runs a per-bucket pipeline (``overlap`` in
    {"buckets", "backward"} and reduction axes on the mesh; without them
    the monolithic step runs, as in the JAX package)."""
    tcfg.het.validate()
    return tcfg.het.overlap != "none" and bool(_reduce_axes(tcfg, mesh))


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
    cfg = model.cfg
    if het.overlap == "backward":
        if not tr.supports_staged_backward(cfg):
            raise ValueError(
                "HetConfig.overlap='backward' stages the backward over "
                "the uniform block stack (dense | moe | mla); stack "
                f"plan '{tr.stack_plan(cfg)}' of '{cfg.name}' is not "
                "supported — use overlap='buckets'")
        if cfg.scan_layers:
            raise ValueError(
                "HetConfig.overlap='backward' needs ModelConfig."
                "scan_layers=False: the staged layer-by-layer backward "
                "is an unrolled program, and bit-exactness with the "
                "monolithic path requires the monolithic stack "
                "unrolled too (launch/train.py: --no-scan-layers)")
    if het.pipeline_stages > 1:
        if not tr.supports_staged_backward(cfg):
            raise ValueError(
                "HetConfig.pipeline_stages > 1 cuts the uniform block "
                "stack (dense | moe | mla) into contiguous stages; "
                f"stack plan '{tr.stack_plan(cfg)}' of '{cfg.name}' is "
                "not supported")
        if cfg.scan_layers:
            raise ValueError(
                "HetConfig.pipeline_stages > 1 needs ModelConfig."
                "scan_layers=False: the per-stage VJP segments are an "
                "unrolled program, and bit-exactness with pure DP "
                "requires the monolithic stack unrolled too "
                "(launch/train.py: --no-scan-layers)")
        if cfg.num_layers < het.pipeline_stages:
            raise ValueError(
                f"pipeline_stages={het.pipeline_stages} exceeds the "
                f"{cfg.num_layers}-layer stack of '{cfg.name}' (every "
                "stage needs >= 1 layer)")
        raise NotImplementedError(
            f"pipeline_stages={het.pipeline_stages}: not ported yet "
            f"(repro_torch trains every data-parallel mode without "
            f"pipeline stages)")
    tr.check_supported(cfg)


def init_train_state(model: Model, tcfg: TrainConfig,
                     seed: int | None = None,
                     mesh: Optional[ProcessMesh] = None) -> TrainState:
    """Parameters from ``seed`` (default ``tcfg.seed``) on the model's
    device (the same on every rank), zero moments (packed with an
    overlap mode) and a zero error-feedback state where the config
    keeps one."""
    mesh = _mesh(mesh, model)
    params = model.init_params(tcfg.seed if seed is None else seed)
    if _overlap_enabled(tcfg, mesh):
        lo = bucket_layout(tcfg, mesh, params)
        opt = adam.init_state_flat(lo.num_buckets, lo.bucket_elems,
                                   tcfg.optimizer, model.device)
    else:
        opt = adam.init_state(params, tcfg.optimizer)
    return TrainState(params=params, opt=opt,
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


def _jax_specs(fake: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """The parameter tree in the JAX layout (the layer stack stacked),
    leaves as ``repack.ShapeDtype``."""
    return convert.to_jax_layout(
        fake, lambda t: _spec(t.shape, dtype or t.dtype),
        lambda ts: _spec((len(ts), *ts[0].shape), dtype or ts[0].dtype))


def checkpoint_format(model: Model, tcfg: TrainConfig,
                      mesh: ProcessMesh) -> Dict[str, Any]:
    """The checkpoint ``"format"`` meta block, as the JAX package writes
    it (no pipeline stages): one writer file a pod (``hosts``); with an
    overlap mode the moments are packed, recorded as ``packed_fields``
    beside the grid's layout record and fingerprint."""
    hosts = mesh.sizes.get("pod", 1)
    fmt: Dict[str, Any] = {"version": repack.FORMAT_VERSION,
                           "state": "pytree", "packed_fields": [],
                           "layout": None, "hosts": hosts,
                           "overlap": tcfg.het.overlap, "pipeline": None}
    if _overlap_enabled(tcfg, mesh):
        fake = _param_shapes(model)
        paths = list(repack.flatten_with_paths(_jax_specs(fake)))
        rec = bkt.layout_record(bucket_layout(tcfg, mesh, fake),
                                leaf_paths=paths, hosts=hosts)
        fmt.update(state="packed", packed_fields=["opt/m", "opt/v"],
                   layout=rec, fingerprint=rec["fingerprint"])
    return fmt


def state_shapes(model: Model, tcfg: TrainConfig,
                 mesh: ProcessMesh) -> TrainState:
    """The restore template: the JAX package's ``state_shapes`` for this
    config, leaves as ``repack.ShapeDtype`` (the layer stack stacked,
    the residual as every pod's: ``(pods, nb, be)`` bucketed or a
    ``(pods, *leaf)`` mirror; packed ``(nb, be)`` moments with an
    overlap mode)."""
    fake = _param_shapes(model)
    ocfg = tcfg.optimizer

    def specs(dtype=None):
        return _jax_specs(fake, dtype)

    if _overlap_enabled(tcfg, mesh):
        lo = bucket_layout(tcfg, mesh, fake)

        def moments(dtype):
            return _spec((lo.num_buckets, lo.bucket_elems), dtype)
    else:
        def moments(dtype):
            return specs(dtype)

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
                           m=moments(dtype_of(ocfg.m_dtype)),
                           v=moments(dtype_of(ocfg.v_dtype))),
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
            m=_moments_to_host(state.opt.m),
            v=_moments_to_host(state.opt.v)),
        err=err)


def _moments_to_host(m: Any) -> Any:
    """Moments to the host: a packed stack as it is, a tree in the JAX
    layout."""
    if isinstance(m, torch.Tensor):
        return convert.params_to_host({"m": m})["m"]
    return convert.params_to_host(m)


def state_from_host(host: TrainState, model: Model, tcfg: TrainConfig,
                    mesh: ProcessMesh) -> TrainState:
    """A restored host state (``state_shapes``' layout) on this rank's
    device: the per-layer lists split back out, this pod's row of the
    residual."""
    cfg, dev = model.cfg, model.device

    def tree(t):
        return convert.params_from_jax(t, cfg, dev)

    def moments(t):
        if isinstance(t, np.ndarray):           # a packed stack
            return torch.from_numpy(np.ascontiguousarray(t)).to(
                dev, copy=True)
        return tree(t)

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
            m=moments(host.opt.m), v=moments(host.opt.v)),
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
    metrics ``loss``, ``weight``, ``grad_norm``, ``lr`` and, under LAMB,
    ``trust_ratio`` (0-dim tensors, the same on every rank), as the JAX
    step returns. ``batch``: this rank's rows, inputs, labels (B, S) int
    and weights (B, S) float on the model's device (on one rank, the
    whole packed batch; under ``weighting="canonical"``, the whole
    canonical batch on every rank). Attention, cross entropy and the
    int8 exchange go through the kernels (``ce_impl="kernel"``;
    ``HetConfig.quantize_impl`` "pallas" maps to the kernels,
    "reference" to the plain versions). The update and the new error
    state are written into the state's tensors, so the state passed in
    is the state returned."""
    mesh = _mesh(mesh, model)
    validate_train_config(model, tcfg, mesh)
    if tcfg.het.weighting == "canonical":
        return _build_canonical_step(model, tcfg, mesh)
    if _overlap_enabled(tcfg, mesh):
        return _build_overlap_step(model, tcfg, mesh)
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
        params, opt, met = _opt_apply(ocfg)(state.params, grads, state.opt,
                                            ocfg, lr)
        return (TrainState(params=params, opt=opt, err=err),
                {"loss": loss, "weight": w, **met})

    return step


def _opt_apply(ocfg) -> Callable:
    return lamb.apply_update if ocfg.name == "lamb" else adam.apply_update


# --------------------------------------------------------------------------
# the backward that lands leaf gradients into the stream
# --------------------------------------------------------------------------


def _stage_groups(tree: Any, cfg) -> List[Tuple[str, List[Tuple[Any,
                                                                int]]]]:
    """Each top-level subtree in sorted key order with its backward
    stages, the JAX package's partition: the layer list a part a layer
    (layer l at stage L-l), the embedding table at L+1 (a tied table is
    final only there), the head's keys at 0."""
    L = cfg.num_layers
    head = set(tr.head_param_keys(cfg))
    groups = []
    for key in sorted(tree):
        if key == "layers":
            parts = [(lp, L - l) for l, lp in enumerate(tree[key])]
        elif key == "embed":
            parts = [(tree[key], L + 1)]
        elif key in head:
            parts = [(tree[key], 0)]
        else:
            raise ValueError(
                f"overlap='backward': unexpected param subtree '{key}' "
                f"(uniform stack expects embed / final_norm / lm_head / "
                f"layers)")
        groups.append((key, parts))
    return groups


def staged_leaf_pieces(params: Any, cfg) -> List[List[Tuple[int, int,
                                                             int]]]:
    """Per stream leaf ``(offset_within_leaf, n, backward_stage)``
    pieces, the JAX package's ``_staged_leaf_pieces`` (a stacked layer
    leaf in per-layer slices): what ``bucket_readiness`` reads."""
    L = cfg.num_layers
    pieces = []
    for key, parts in _stage_groups(params, cfg):
        if key == "layers":
            for shape, _ in bkt.stream_leaves(params[key]):
                per = int(np.prod(shape)) // L
                pieces.append([(l * per, per, L - l) for l in range(L)])
            continue
        for part, stage in parts:
            pieces += [[(0, int(np.prod(shape)), stage)]
                       for shape, _ in bkt.stream_leaves(part)]
    return pieces


def _backward_into_stream(model: Model, tcfg: TrainConfig, params: Any,
                          mb: Dict[str, torch.Tensor], stream: torch.Tensor,
                          layout: bkt.BucketLayout, *, copy: bool,
                          on_forward: Optional[Callable] = None,
                          on_stage: Optional[Callable] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One microbatch's forward and backward with every leaf gradient
    written into its range of the fp32 ``stream`` (``copy``, or added
    to what is there) the moment autograd finishes it, then released:
    no gradient tree is ever held. ``on_forward(o, w)`` runs between
    the forward and the backward; ``on_stage(s)`` runs once the
    backward stage s and every stage below it are complete, in stage
    order (stage 0 the head, s layer L-s, L+1 the embedding). The hooks
    also fire under ``torch.utils.checkpoint`` (remat), where each
    layer is recomputed inside its own backward. Returns this
    microbatch's (objective sum, weight sum)."""
    cfg = model.cfg
    L = cfg.num_layers
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    stage_of = {id(t): stage for _, parts in _stage_groups(leaves, cfg)
                for part, stage in parts for t in tree_leaves(part)}
    flat = stream.view(-1)
    remaining = [0] * (L + 2)
    entries = []
    for off, t in bkt.tree_pieces(leaves, layout):
        entries.append((off, t, stage_of[id(t)]))
        remaining[stage_of[id(t)]] += 1
    done = [0]                          # the next stage to complete

    def advance():
        while done[0] <= L + 1 and remaining[done[0]] == 0:
            if on_stage is not None:
                on_stage(done[0])
            done[0] += 1

    def hook_for(off, stage):
        def hook(t):
            dst = flat[off:off + t.numel()]
            if copy:
                dst.copy_(t.grad.reshape(-1))
            else:
                dst.add_(t.grad.reshape(-1))
            t.grad = None
            remaining[stage] -= 1
            advance()
        return hook

    with torch.enable_grad():
        o, w, _ = model.loss_fn(leaves, mb, ce_impl="kernel",
                                label_smoothing=tcfg.label_smoothing)
    w = w.detach()
    if on_forward is not None:
        on_forward(o.detach(), w)
    handles = [t.register_post_accumulate_grad_hook(hook_for(off, stage))
               for off, t, stage in entries]
    try:
        advance()
        torch.autograd.backward(o, inputs=[t for _, t, _ in entries])
    finally:
        for h in handles:
            h.remove()
    if done[0] <= L + 1:
        raise RuntimeError(f"backward stage {done[0]} never completed: a "
                           f"parameter got no gradient")
    return o.detach(), w


# --------------------------------------------------------------------------
# the packed optimizer update, a bucket at a time
# --------------------------------------------------------------------------


class FlatUpdate:
    """One step's optimizer update on the bucket grid: the moments are
    the packed stacks, the parameters are read and written a bucket at a
    time through views (``bucket_pieces``), the decay mask and LAMB's
    runs are built per bucket from the layout. ``scale(k, red_k)``
    divides a reduced bucket by the global weight in place and keeps its
    squared sum for the grad norm (summed in bucket-index order). The
    fused form calls :meth:`update_bucket` as each bucket lands (then,
    under LAMB, :meth:`lamb_finish`); the barrier form
    :meth:`barrier` on the whole reduced stack. Both run the same
    per-bucket calls, so without a clip they are bitwise equal."""

    def __init__(self, layout: bkt.BucketLayout, ocfg, params: Any,
                 opt: adam.AdamState, lr: torch.Tensor):
        self.layout, self.ocfg, self.lr = layout, ocfg, lr
        self.pieces = bkt.bucket_pieces(params, layout)
        self.m, self.v = opt.m, opt.v
        self.step = opt.step + 1
        self.device = opt.m.device
        self.inv_w: Optional[torch.Tensor] = None
        self.ssq: Dict[int, torch.Tensor] = {}
        self.lamb_terms: Dict[int, Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = {}
        self.n_leaves = len(layout.sizes)

    def scale(self, k: int, red_k: torch.Tensor) -> torch.Tensor:
        g = red_k.mul_(self.inv_w)
        self.ssq[k] = torch.sum(g * g)
        return g

    def grad_norm(self) -> torch.Tensor:
        return torch.sqrt(weighting.fold(
            [self.ssq[k] for k in range(self.layout.num_buckets)]))

    def _p(self, k: int) -> torch.Tensor:
        return bkt.gather_bucket(self.pieces[k], self.layout.bucket_elems,
                                 self.device)

    def _mask(self, k: int) -> torch.Tensor:
        return bkt.bucket_decay_mask(self.layout, k, self.device)

    def adamw(self, k: int, g: torch.Tensor,
              clip: Optional[torch.Tensor] = None) -> None:
        p, m, v = adam.apply_update_flat(
            self._p(k), g, self.m[k], self.v[k], self.step, self.ocfg,
            self.lr, decay_mask=self._mask(k), clip_scale=clip)
        self.m[k].copy_(m)
        self.v[k].copy_(v)
        bkt.scatter_bucket(self.pieces[k], p)

    def lamb_bucket(self, k: int, g: torch.Tensor,
                    clip: Optional[torch.Tensor] = None) -> None:
        """LAMB's streamed half for bucket k: moments written, the
        update and the norm partials kept for :meth:`lamb_finish`."""
        pf, upd, mf, vf = adam.flat_adamw_terms(
            self._p(k), g, self.m[k], self.v[k], self.step, self.ocfg,
            decay_mask=self._mask(k), clip_scale=clip)
        self.m[k].copy_(mf)
        self.v[k].copy_(vf)
        psq, usq = lamb.bucket_norm_terms(
            pf, upd, bkt.bucket_runs(self.layout, k), self.n_leaves)
        self.lamb_terms[k] = (upd, psq, usq)

    def lamb_finish(self) -> torch.Tensor:
        """The trailing trust pass (partials combined in bucket-index
        order); returns the mean trust ratio."""
        nb = self.layout.num_buckets
        terms = [self.lamb_terms.pop(k) for k in range(nb)]
        trust = lamb.trust_from_norms(weighting.fold([t[1] for t in terms]),
                                      weighting.fold([t[2] for t in terms]))
        for k, (upd, _, _) in enumerate(terms):
            bkt.scatter_bucket(self.pieces[k], lamb.apply_trust(
                self._p(k), upd, self.lr, bkt.bucket_runs(self.layout, k),
                trust))
        return torch.mean(trust[:self.n_leaves])

    def update_bucket(self, k: int, red_k: torch.Tensor) -> None:
        """The fused update of one landed bucket (``grad_clip == 0``)."""
        g = self.scale(k, red_k)
        if self.ocfg.name == "lamb":
            self.lamb_bucket(k, g)
        else:
            self.adamw(k, g)

    def barrier(self, stack: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole-stack update behind the barrier (global-norm clip,
        and LAMB in the after-backward engine): every bucket scaled
        first, the clip factor from their norm, then the updates.
        Returns LAMB's mean trust ratio (None under AdamW)."""
        nb = self.layout.num_buckets
        for k in range(nb):
            self.scale(k, stack[k])
        clip = (adam.clip_scale(self.grad_norm(), self.ocfg.grad_clip)
                if self.ocfg.grad_clip > 0 else None)
        for k in range(nb):
            if self.ocfg.name == "lamb":
                self.lamb_bucket(k, stack[k], clip)
            else:
                self.adamw(k, stack[k], clip)
        return self.lamb_finish() if self.ocfg.name == "lamb" else None


# --------------------------------------------------------------------------
# the overlap steps (HetConfig.overlap = "buckets" | "backward")
# --------------------------------------------------------------------------


def _build_overlap_step(model: Model, tcfg: TrainConfig, mesh: ProcessMesh):
    het, ocfg = tcfg.het, tcfg.optimizer
    accum = max(1, het.accum_steps)
    q_impl = q_ops.impl_of(het.quantize_impl)
    hier = _hier(tcfg, mesh)
    comm = mesh.pod if hier else mesh.world
    compress = hier and het.compression != "none"
    use_err = _err_enabled(tcfg, mesh)
    backward = het.overlap == "backward"
    fused = ocfg.grad_clip <= 0 and (backward or ocfg.name != "lamb")
    cache: Dict[str, Any] = {}

    def layout_of(params):
        if "layout" not in cache:
            lo = bucket_layout(tcfg, mesh, params)
            cache["layout"] = lo
            cache["readiness"] = bkt.bucket_readiness(
                lo, staged_leaf_pieces(params, model.cfg))
        return cache["layout"]

    def grad_fn(p, mb):
        return value_and_grad(model.loss_fn, p, mb, ce_impl="kernel",
                              label_smoothing=tcfg.label_smoothing)

    def after_backward(state, batch, flat, layout):
        """``overlap="buckets"``: the monolithic step's gradient, then the
        per-bucket pipeline."""
        g, o, w_local = accumulate_sums(grad_fn, state.params,
                                        split_microbatches(batch, accum))
        loss, w = weighting.psum_weighted(o, w_local, mesh.world)
        flat.inv_w = 1.0 / torch.clamp(w, min=1e-9)
        if hier and mesh.data.size > 1:         # in-pod leg, fp32
            g = tree_map(mesh.data.all_reduce, g)
        stack = bkt.pack_buckets(g, layout)
        del g
        bkt.exchange_buckets_overlapped(
            stack, state.err if use_err else None, comm=comm,
            compress=compress, block_size=_BLOCK, impl=q_impl,
            total=layout.total, bucket_fn=flat.update_bucket if fused else None)
        return loss, w, stack

    def during_backward(state, batch, flat, layout):
        """``overlap="backward"``: buckets flushed as the last
        microbatch's backward lands them."""
        stream = torch.zeros((layout.num_buckets, layout.bucket_elems),
                             dtype=torch.float32, device=model.device)
        prep_k, exchange_k = bkt.bucket_legs(
            stream, state.err if use_err else None, comm=comm,
            compress=compress, block_size=_BLOCK, impl=q_impl,
            total=layout.total)

        def prep(k, raw_k):
            if hier and mesh.data.size > 1:     # in-pod leg, fp32
                mesh.data.all_reduce(raw_k)
            return prep_k(k)

        pipeline = bkt.BucketFlushPipeline(
            cache["readiness"], prep, exchange_k,
            bucket_fn=flat.update_bucket if fused else None)
        cell: Dict[str, torch.Tensor] = {}
        # the sums of the earlier microbatches, as accumulate_sums adds
        # them (none with one microbatch)
        o_acc = w_acc = (torch.zeros((), dtype=torch.float32,
                                     device=model.device)
                         if accum > 1 else None)
        mbs = split_microbatches(batch, accum)
        for i in range(accum):
            mb = {k: v[i] for k, v in mbs.items()}
            last = i == accum - 1

            def on_forward(o, w, o_acc=o_acc, w_acc=w_acc):
                cell["loss"], cell["w"] = weighting.psum_weighted(
                    o if o_acc is None else o_acc + o,
                    w if w_acc is None else w_acc + w, mesh.world)
                flat.inv_w = 1.0 / torch.clamp(cell["w"], min=1e-9)

            o, w = _backward_into_stream(
                model, tcfg, state.params, mb, stream, layout,
                copy=accum == 1, on_forward=on_forward if last else None,
                on_stage=(lambda s: pipeline.flush_ready_buckets(
                    s, lambda k: stream[k])) if last else None)
            if not last:
                o_acc, w_acc = o_acc + o, w_acc + w
        pipeline.finish()
        return cell["loss"], cell["w"], stream

    run = during_backward if backward else after_backward

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        layout = layout_of(state.params)
        lr = schedules.learning_rate(ocfg, state.opt.step + 1)
        flat = FlatUpdate(layout, ocfg, state.params, state.opt, lr)
        loss, w, stack = run(state, batch, flat, layout)
        trust = None
        if not fused:
            trust = flat.barrier(stack)
        elif ocfg.name == "lamb":
            trust = flat.lamb_finish()
        del stack
        metrics = {"loss": loss, "weight": w, "grad_norm": flat.grad_norm(),
                   "lr": lr}
        if ocfg.name == "lamb":
            metrics["trust_ratio"] = trust
        opt = adam.AdamState(step=flat.step, m=state.opt.m, v=state.opt.v)
        return TrainState(params=state.params, opt=opt,
                          err=state.err), metrics

    return step


# --------------------------------------------------------------------------
# the order-canonical step (HetConfig.weighting = "canonical")
# --------------------------------------------------------------------------


def canonical_rows(global_rows: int, ranks: int, rank: int) -> range:
    """The global rows a rank runs under ``weighting="canonical"``: an
    equal contiguous share that depends on nothing but the row and rank
    counts."""
    return range(rank * global_rows // ranks,
                 (rank + 1) * global_rows // ranks)


def canonical_backward(model: Model, tcfg: TrainConfig, params: Any,
                       batch: Dict[str, torch.Tensor], rows: range,
                       stream: torch.Tensor, layout: bkt.BucketLayout
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The order-canonical executor on this rank's ``rows`` of the
    global ``batch``: each row, dummies included, runs as its own
    one-row batch in global-row order, and its gradient is folded into
    the fp32 ``stream`` (the first row's written, each later one added)
    as it lands, one row's gradient held at a time. Returns the rows'
    objective and weight sums, in row order (the JAX package's
    ``per_row_values`` + ``canonical_aggregate`` on these rows, with
    the gradient fold done in the stream)."""
    objs, weights = [], []
    for i in rows:
        o, w = _backward_into_stream(
            model, tcfg, params, {k: v[i:i + 1] for k, v in batch.items()},
            stream, layout, copy=i == rows.start)
        objs.append(o)
        weights.append(w)
    return objs, weights


def _build_canonical_step(model: Model, tcfg: TrainConfig,
                          mesh: ProcessMesh):
    ocfg = tcfg.optimizer
    comm = mesh.world
    cache: Dict[str, bkt.BucketLayout] = {}

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if "layout" not in cache:
            cache["layout"] = bkt.build_layout(
                state.params, bucket_mb=(tcfg.het.bucket_mb
                                         or _CANONICAL_BUCKET_MB),
                multiple_of=comm.size)
        layout = cache["layout"]
        dev = model.device
        stream = torch.zeros((layout.num_buckets, layout.bucket_elems),
                             dtype=torch.float32, device=dev)
        rows = canonical_rows(next(iter(batch.values())).shape[0],
                              comm.size, comm.index)
        objs, weights = canonical_backward(model, tcfg, state.params, batch,
                                           rows, stream, layout)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mine = torch.stack([weighting.fold(objs) if objs else zero,
                            weighting.fold(weights) if weights else zero])
        sums = comm.all_gather(mine)            # (ranks, 2)
        o_sum = weighting.fold(list(sums[:, 0]))
        w_sum = weighting.fold(list(sums[:, 1]))
        if comm.size > 1:                       # the sum in rank order
            bkt.exchange_buckets(stream, comm=comm, compress=False)
        inv = 1.0 / torch.clamp(w_sum, min=1e-9)
        grads = tree_map(lambda t: t.mul_(inv.to(t.dtype)),
                         bkt.unpack_buckets(stream, layout, state.params))
        lr = schedules.learning_rate(ocfg, state.opt.step + 1)
        params, opt, met = _opt_apply(ocfg)(state.params, grads, state.opt,
                                            ocfg, lr)
        return (TrainState(params=params, opt=opt, err=state.err),
                {"loss": weighting.finalize(o_sum, w_sum), "weight": w_sum,
                 **met})

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
