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

Gradient reductions (``HetConfig.grad_reduction``), over the
data-parallel ranks (``ProcessMesh.dp``; every rank without a ``pipe``
axis):

  * "allreduce" — one fp32 all-reduce per leaf over those ranks (the
    JAX package leaves it to XLA);
  * "bucketed_allreduce" — the fp32 bucket exchange over them
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

A MoE stack's aux loss (:func:`aux_weight_for`): each rank routes its
own rows of a microbatch at the training capacity of their tokens,
dummy rows included, as each data rank of the JAX step's SPMD region
does. The JAX objective is ``ce + mean_r(aux_r) * W`` with ``W`` the
region's weight sum of the microbatch (every data rank under
"allreduce", the pod under "hierarchical", the rank itself under
"bucketed_allreduce", a row under ``weighting="canonical"``), so each
rank's objective takes ``aux_r * W / n`` (one scalar all-reduce a
microbatch, before its backward) and the ranks' sums add up to it.

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

Pipeline stages (``HetConfig.pipeline_stages > 1``, the uniform stack
unrolled; :func:`_build_pipeline_step`): the layer stack is cut into
contiguous stages (:func:`stage_plan_for`: sized by the capacities when
there is one positive entry a stage, else uniform) and the accumulation
microbatches stream through them in the 1F1B or GPipe program order of
``core/pipeline.py``, each stage's forward and backward a segment of
``transformer.pipeline_stage_fns``. The gradients are summed in the
monolithic step's order (a tied table's head and gather parts added
once a microbatch), reduced over the data-parallel ranks (per leaf, or
the bucket stream flushed a stage at a time) and applied by the tree
AdamW or LAMB, so in fp32 with ``grad_clip=0`` the step is bitwise the
one-stage step. Without a ``pipe`` mesh axis every data-parallel rank
runs all the stages in its process; with one, each stage runs on its own
ranks (:func:`stage_params`, :func:`owned_params`), the boundary values
cross between them point to point (:class:`PipeHop`) and the update's
sums over the stages come from one gather (:class:`StageIndex`).

Checkpoints hold the state in the JAX package's layout (the layer stack
stacked, every pod's residual in one ``(pods, ...)`` array):
:func:`state_shapes` and :func:`checkpoint_format` are the JAX package's
template and format block (with the stage plan's record),
:func:`state_to_host` and :func:`state_from_host` move a rank's
``TrainState`` there and back; on a ``pipe`` axis the save gathers every
stage's part to rank 0 over the pipe group, and the restore takes the
stage's part under the current cut.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import repack
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import buckets as bkt
from repro_torch.core import pipeline as pipe
from repro_torch.core import weighting
from repro_torch.core.accumulate import (accumulate_grads, accumulate_sums,
                                         split_microbatches, value_and_grad)
from repro_torch.core.comm import Comm, Pending
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


def aux_weight_for(model: Model, tcfg: TrainConfig, mesh: ProcessMesh
                   ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """``Model.loss_fn``'s ``aux_weight`` for this config's step, or None
    (a microbatch's own weight sum): the weight sum of the JAX step's
    routing region over its rank count, where the region spans more
    than this rank (see the module docstring). The pipelined step is
    pinned to "allreduce" or "bucketed_allreduce", the overlap steps to
    the bucketed reductions, so the rule covers them; a dense stack
    needs no weight (its aux is 0)."""
    if not model.cfg.moe.enabled or tcfg.het.weighting == "canonical":
        return None
    if _hier(tcfg, mesh):
        comm = mesh.data
    elif tcfg.het.grad_reduction == "bucketed_allreduce":
        return None
    else:
        comm = mesh.dp
    if comm.size <= 1:
        return None

    def weight(w: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(w.float().clone()) / comm.size

    return weight


def stage_plan_for(model: Model,
                   tcfg: TrainConfig) -> Optional[pipe.StagePlan]:
    """The pipeline StagePlan for this config (None when off), the JAX
    package's rule: when ``HetConfig.capacities`` has exactly
    ``pipeline_stages`` entries, all positive, they double as the stage
    speeds that size the layer cut; anything else (empty, one entry a
    data-parallel rank, or zeros, which mark dead ranks but cannot mark
    a stage) gets the uniform cut."""
    return _stage_plan(model.cfg.num_layers, tcfg)


def _stage_plan(num_layers: int,
                tcfg: TrainConfig) -> Optional[pipe.StagePlan]:
    S = tcfg.het.pipeline_stages
    if S <= 1:
        return None
    caps = tcfg.het.capacities
    if len(caps) == S and all(c > 0 for c in caps):
        return pipe.plan_stages(num_layers, caps)
    return pipe.uniform_stages(num_layers, S)


def _staged(tcfg: TrainConfig, mesh: ProcessMesh) -> bool:
    """Whether each pipeline stage runs on its own ranks (a ``pipe``
    axis on the mesh)."""
    return tcfg.het.pipeline_stages > 1 and mesh.pipe_size > 1


def stage_params(params: Any, cfg, splan: pipe.StagePlan,
                 stage: int) -> Dict[str, Any]:
    """What pipeline stage ``stage`` holds of the parameter tree (its
    keys in the tree's order): its layer slice, the embedding table on
    stage 0 and the head's keys on the last stage (a tied table is held
    by both)."""
    S = splan.num_stages
    r0, r1 = splan.stage_ranges()[stage]
    head = set(tr.head_param_keys(cfg))
    out: Dict[str, Any] = {}
    for key, sub in params.items():
        if key == "layers":
            out[key] = sub[r0:r1]
        elif (key == "embed" and stage == 0) or \
                (key in head and stage == S - 1):
            out[key] = sub
    return out


def owned_params(held: Dict[str, Any], cfg, splan: pipe.StagePlan,
                 stage: int) -> Dict[str, Any]:
    """What stage ``stage`` updates of what it holds (``stage_params``'
    keys; any tree with them): all of it, but for a tied table on stage
    0, whose gradient and update belong to the last stage (stage 0
    holds a copy for its gather, refreshed after every update)."""
    tied = "embed" in tr.head_param_keys(cfg)
    if stage == 0 and tied and splan.num_stages > 1:
        return {k: v for k, v in held.items() if k != "embed"}
    return held


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
    if mesh_mod.PIPE_AXIS in mesh.axis_names \
            and mesh.pipe_size != het.pipeline_stages:
        raise ValueError(
            f"mesh 'pipe' axis has size {mesh.pipe_size} but "
            f"HetConfig.pipeline_stages={het.pipeline_stages} — "
            "build the mesh with pipe=pipeline_stages "
            "(launch/mesh.py::with_pipe)")
    tr.check_supported(cfg)


def init_train_state(model: Model, tcfg: TrainConfig,
                     seed: int | None = None,
                     mesh: Optional[ProcessMesh] = None) -> TrainState:
    """Parameters from ``seed`` (default ``tcfg.seed``) on the model's
    device (the same on every rank), zero moments (packed with an
    overlap mode) and a zero error-feedback state where the config
    keeps one. On a mesh with a ``pipe`` axis, the stage's part of the
    parameters (:func:`stage_params`) and the moments of what it owns
    (:func:`owned_params`)."""
    mesh = _mesh(mesh, model)
    params = model.init_params(tcfg.seed if seed is None else seed)
    if _staged(tcfg, mesh):
        splan = stage_plan_for(model, tcfg)
        params = stage_params(params, model.cfg, splan, mesh.pipe_index)
        return TrainState(params=params, opt=adam.init_state(
            owned_params(params, model.cfg, splan, mesh.pipe_index),
            tcfg.optimizer), err=())
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


def _param_shapes(cfg) -> Any:
    """The port's parameter tree of a model config as shapes and dtypes
    only (fake tensors: nothing is drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return tr.init_params(cfg, 0, "cpu")


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
    it: one writer file a pod (``hosts``); the stage plan under
    ``"pipeline"`` (``core/pipeline.py::stage_record``, None without
    pipeline stages: parameters are stored per leaf, so a checkpoint
    restores bit-exactly under any stage plan and the record only lets
    the restore log the change); with an overlap mode the moments are
    packed, recorded as ``packed_fields`` beside the grid's layout
    record and fingerprint."""
    hosts = mesh.sizes.get("pod", 1)
    splan = stage_plan_for(model, tcfg)
    fmt: Dict[str, Any] = {"version": repack.FORMAT_VERSION,
                           "state": "pytree", "packed_fields": [],
                           "layout": None, "hosts": hosts,
                           "overlap": tcfg.het.overlap,
                           "pipeline": (pipe.stage_record(splan)
                                        if splan is not None else None)}
    if _overlap_enabled(tcfg, mesh):
        fake = _param_shapes(model.cfg)
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
    fake = _param_shapes(model.cfg)
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


def _stage_paths(cfg, splan: pipe.StagePlan, stage: int,
                 fake: Any) -> List[Tuple]:
    """The paths in the whole tree (layers by their global index) of
    what pipeline stage ``stage`` owns (``fake``: the whole tree's
    shapes), sorted: the order its part of the state crosses the pipe
    group."""
    first = splan.stage_ranges()[stage][0]
    own = owned_params(stage_params(fake, cfg, splan, stage), cfg, splan,
                       stage)
    return sorted(_global_path(p, first) for p, _ in _paths(own))


def stage_state_leaves(state: TrainState, cfg, splan: pipe.StagePlan,
                       stage: int, fake: Any = None) -> List[torch.Tensor]:
    """A stage rank's part of the state (``state.params`` its
    :func:`stage_params`, the moments those of its
    :func:`owned_params`): the parameters it owns, then their m, then
    their v, each in :func:`_stage_paths` order."""
    fake = _param_shapes(cfg) if fake is None else fake
    first = splan.stage_ranges()[stage][0]

    def leaf(tree, path):
        for i, k in enumerate(path):
            tree = tree[k - first if i == 1 and path[0] == "layers" else k]
        return tree

    paths = _stage_paths(cfg, splan, stage, fake)
    return [leaf(t, p) for t in (state.params, state.opt.m, state.opt.v)
            for p in paths]


def host_state_slots(host: TrainState, cfg, splan: pipe.StagePlan,
                     stage: int, fake: Any = None) -> List[torch.Tensor]:
    """Where :func:`stage_state_leaves` of stage ``stage`` go in a whole
    host state of the JAX layout: views of its numpy arrays (a layer of
    the stack a row of its stacked leaf), in the same order."""
    fake = _param_shapes(cfg) if fake is None else fake

    def view(tree, path):
        row = None
        if path[0] == "layers":
            row, path = path[1], ("layers",) + path[2:]
        for k in path:
            tree = tree[k]
        t = torch.from_numpy(tree)
        return t if row is None else t[row]

    paths = _stage_paths(cfg, splan, stage, fake)
    return [view(t, p) for t in (host.params, host.opt.m, host.opt.v)
            for p in paths]


def empty_host_state(cfg, ocfg, fake: Any = None) -> TrainState:
    """A whole host state of the JAX layout (``state_shapes``' without a
    residual), its arrays allocated and not filled, the step 0."""
    fake = _param_shapes(cfg) if fake is None else fake
    for owner, name in ((cfg, "param_dtype"), (ocfg, "m_dtype"),
                        (ocfg, "v_dtype")):
        if dtype_of(getattr(owner, name)) == torch.bfloat16:
            raise ValueError(f"{name} bfloat16 has no numpy dtype, and the "
                             f"npz format of checkpoints stores none: keep "
                             f"it float32 to checkpoint")

    def alloc(dtype=None):
        return _map_leaves(_jax_specs(fake, dtype),
                           lambda spec: np.empty(spec.shape, spec.dtype))

    return TrainState(params=alloc(), opt=adam.AdamState(
        step=np.zeros((), np.int32), m=alloc(dtype_of(ocfg.m_dtype)),
        v=alloc(dtype_of(ocfg.v_dtype))), err=())


def _gather_stages(state: TrainState, tcfg: TrainConfig,
                   mesh: ProcessMesh) -> Optional[TrainState]:
    """:func:`state_to_host` on a ``pipe`` axis: the stage ranks of
    data index 0 send what they own to stage 0 (rank 0) over their pipe
    group, a leaf at a time, and rank 0 copies each into its place in
    one whole host state; the other data indices take no part."""
    if mesh.dp_rank != 0:
        return None
    cfg, comm = tcfg.model, mesh.pipe
    splan = _stage_plan(cfg.num_layers, tcfg)
    fake = _param_shapes(cfg)
    me = mesh.pipe_index
    if me > 0:
        for i, t in enumerate(stage_state_leaves(state, cfg, splan, me,
                                                 fake)):
            comm.send(t.detach(), 0, tag=i).wait()
        return None
    host = empty_host_state(cfg, tcfg.optimizer, fake)
    for dst, t in zip(host_state_slots(host, cfg, splan, 0, fake),
                      stage_state_leaves(state, cfg, splan, 0, fake)):
        dst.copy_(t.detach())
    # gloo's hop takes host memory: receive straight onto the host
    at = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    for s in range(1, splan.num_stages):
        for i, dst in enumerate(host_state_slots(host, cfg, splan, s, fake)):
            dst.copy_(comm.recv(dst.shape, dst.dtype, at, s, tag=i).wait())
    return TrainState(params=host.params, opt=adam.AdamState(
        step=state.opt.step.to("cpu", copy=True).numpy(), m=host.opt.m,
        v=host.opt.v), err=())


def state_to_host(state: TrainState, tcfg: TrainConfig,
                  mesh: ProcessMesh) -> Optional[TrainState]:
    """This rank's state in the JAX layout as fresh numpy copies, each
    leaf in its own dtype, for ``CheckpointManager.save``: the residual
    of every pod gathered over the pod group (a collective when the
    config keeps one: every rank calls this at the same step). Rank 0
    gets the state (the parameters and moments are the same on every
    rank), the other ranks None. On a ``pipe`` axis every stage's part
    is gathered to rank 0 (:func:`_gather_stages`): the whole tree, a
    tied table and its moments from the last stage, leaf for leaf what
    the one-process pipelined run returns."""
    if _staged(tcfg, mesh):
        return _gather_stages(state, tcfg, mesh)
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
    residual. On a ``pipe`` axis only this rank's stage under the
    current cut: its :func:`stage_params` and the moments of its
    :func:`owned_params` (a tied table on stage 0 is the parameter copy,
    with no moments)."""
    cfg, dev = model.cfg, model.device
    if _staged(tcfg, mesh):
        splan, me = stage_plan_for(model, tcfg), mesh.pipe_index
        held = stage_params(_param_shapes(cfg), cfg, splan, me)
        own = owned_params(held, cfg, splan, me)
        first = splan.stage_ranges()[me][0]
        return TrainState(
            params=convert.part_from_jax(host.params, held, dev, first),
            opt=adam.AdamState(
                step=torch.tensor(int(host.opt.step), dtype=torch.int32,
                                  device=dev),
                m=convert.part_from_jax(host.opt.m, own, dev, first),
                v=convert.part_from_jax(host.opt.v, own, dev, first)),
            err=())

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
    aux_weight = aux_weight_for(model, tcfg, mesh)

    def grad_fn(p, mb):
        return value_and_grad(model.loss_fn, p, mb, ce_impl=ce_impl,
                              label_smoothing=tcfg.label_smoothing,
                              aux_weight=aux_weight)

    g, o, w_local = accumulate_sums(grad_fn, state.params,
                                    split_microbatches(batch, accum))
    loss, w = weighting.psum_weighted(o, w_local, mesh.dp)
    err = state.err
    if _hier(tcfg, mesh):
        if mesh.data.size > 1:                  # in-pod leg, fp32
            g = tree_map(mesh.data.all_reduce, g)
        comm, compress = mesh.pod, het.compression
    elif het.grad_reduction == "bucketed_allreduce":
        comm, compress = mesh.dp, "none"
    else:
        return loss, w, weighting.weighted_grad_psum(g, w_local,
                                                     mesh.dp), err
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
    if tcfg.het.pipeline_stages > 1:
        # HetConfig.validate pinned overlap="none", weighting="tokens" and
        # a flat reduction, so the moments stay a tree
        return _build_pipeline_step(model, tcfg, mesh)
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
    final only there), the head's keys at 0. On the zamba plan (which
    only the overlap-free stream paths take: ``overlap="buckets"`` and
    canonical weighting) the shared block, applied after every group,
    is final once the first group's backward has run: the stage of that
    group's last layer. On the xlstm plan (the same paths) pair p's
    mLSTM and sLSTM blocks are layers 2p and 2p + 1."""
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
        elif key == "shared_attn" and tr.stack_plan(cfg) == "zamba":
            parts = [(tree[key], L - cfg.hybrid.attn_every + 1)]
        elif key in ("mlstm_layers", "slstm_layers") \
                and tr.stack_plan(cfg) == "xlstm":
            first = 0 if key == "mlstm_layers" else 1
            parts = [(lp, L - (2 * p + first))
                     for p, lp in enumerate(tree[key])]
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
    pieces = []
    for key, parts in _stage_groups(params, cfg):
        if isinstance(params[key], (list, tuple)):
            # a layer list: stacked leaves, a slice a layer at its stage
            stages = [stage for _, stage in parts]
            for shape, _ in bkt.stream_leaves(params[key]):
                per = int(np.prod(shape)) // len(stages)
                pieces.append([(i * per, per, st)
                               for i, st in enumerate(stages)])
            continue
        for part, stage in parts:
            pieces += [[(0, int(np.prod(shape)), stage)]
                       for shape, _ in bkt.stream_leaves(part)]
    return pieces


def _backward_into_stream(model: Model, tcfg: TrainConfig, params: Any,
                          mb: Dict[str, torch.Tensor], stream: torch.Tensor,
                          layout: bkt.BucketLayout, *, copy: bool,
                          on_forward: Optional[Callable] = None,
                          on_stage: Optional[Callable] = None,
                          aux_weight: Optional[Callable] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One microbatch's forward and backward with every leaf gradient
    written into its range of the fp32 ``stream`` (``copy``, or added
    to what is there) the moment autograd finishes it, then released:
    no gradient tree is ever held. ``on_forward(o, w)`` runs between
    the forward and the backward; ``on_stage(s)`` runs once the
    backward stage s and every stage below it are complete, in stage
    order (stage 0 the head, s layer L-s, L+1 the embedding). The hooks
    also fire under ``torch.utils.checkpoint`` (remat), where each
    layer is recomputed inside its own backward. ``aux_weight``: as
    ``Model.loss_fn``'s. Returns this microbatch's (objective sum,
    weight sum)."""
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
                                label_smoothing=tcfg.label_smoothing,
                                aux_weight=aux_weight)
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
    comm = mesh.pod if hier else mesh.dp
    compress = hier and het.compression != "none"
    use_err = _err_enabled(tcfg, mesh)
    backward = het.overlap == "backward"
    fused = ocfg.grad_clip <= 0 and (backward or ocfg.name != "lamb")
    aux_weight = aux_weight_for(model, tcfg, mesh)
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
                              label_smoothing=tcfg.label_smoothing,
                              aux_weight=aux_weight)

    def after_backward(state, batch, flat, layout):
        """``overlap="buckets"``: the monolithic step's gradient, then the
        per-bucket pipeline."""
        g, o, w_local = accumulate_sums(grad_fn, state.params,
                                        split_microbatches(batch, accum))
        loss, w = weighting.psum_weighted(o, w_local, mesh.dp)
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
                    w if w_acc is None else w_acc + w, mesh.dp)
                flat.inv_w = 1.0 / torch.clamp(cell["w"], min=1e-9)

            o, w = _backward_into_stream(
                model, tcfg, state.params, mb, stream, layout,
                copy=accum == 1, on_forward=on_forward if last else None,
                on_stage=(lambda s: pipeline.flush_ready_buckets(
                    s, lambda k: stream[k])) if last else None,
                aux_weight=aux_weight)
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
    comm = mesh.dp
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


# --------------------------------------------------------------------------
# the pipelined step (HetConfig.pipeline_stages > 1)
# --------------------------------------------------------------------------


def _pipeline_leaf_pieces(params: Any, cfg, splan: pipe.StagePlan,
                          first_layer: int = 0
                          ) -> List[List[Tuple[int, int, int]]]:
    """Per stream leaf ``(offset_within_leaf, n, flush_stage)`` pieces
    for the pipelined step's bucket flushes (the JAX package's
    ``_pipeline_leaf_pieces``), in the order of the LAST microbatch's
    backward: the head at flush stage 0, layer ``l`` at ``S - 1 -
    stage_of_layer(l)``, the embedding table last (``S``: a tied table
    also takes the head's gradient, so it is final only then). ``params``
    may be a stage's part of the tree, its layer list starting at layer
    ``first_layer``. Feeds ``core/buckets.py::bucket_readiness``."""
    S = splan.num_stages
    head = set(tr.head_param_keys(cfg))
    pieces = []
    for key in sorted(params):
        for shape, _ in bkt.stream_leaves(params[key]):
            n = int(np.prod(shape))
            if key == "layers":
                per = n // shape[0]
                pieces.append([(i * per, per, S - 1 - splan.stage_of_layer(
                    first_layer + i)) for i in range(shape[0])])
            elif key == "embed":
                pieces.append([(0, n, S)])
            elif key in head:
                pieces.append([(0, n, 0)])
            else:
                raise ValueError(
                    f"pipeline_stages > 1: unexpected param subtree "
                    f"'{key}' (uniform stack expects embed / final_norm / "
                    f"lm_head / layers)")
    return pieces


def _paths(tree: Any, prefix: Tuple = ()):
    """(path, tensor) of every tensor, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _global_path(path: Tuple, first_layer: int) -> Tuple:
    """A path of a stage's part of the tree as the full tree's (its
    layer list starts at ``first_layer``)."""
    if path[0] == "layers":
        return ("layers", path[1] + first_layer) + path[2:]
    return path


class StageIndex:
    """Where each parameter of the full tree lives across the stages of
    a ``pipe`` axis, for the sums the update needs over all of them: the
    grad norm's per-leaf terms in ``tree_leaves`` order, LAMB's per-piece
    norm terms grouped by the JAX leaf (``adam.leaf_groups``, a stacked
    leaf's pieces in layer order). Each stage fills the slots of what it
    owns, one ``all_gather`` over the pipe group brings every stage's
    row, and every stage reads each slot from its owner's row and sums
    in the one-process update's order, so the sums are bitwise the
    same."""

    def __init__(self, full: Any, cfg, splan: pipe.StagePlan):
        S = splan.num_stages
        tied = "embed" in tr.head_param_keys(cfg)
        head = set(tr.head_param_keys(cfg))

        def owner(path):
            if path[0] == "layers":
                return splan.stage_of_layer(path[1])
            if path[0] == "embed":
                return S - 1 if tied else 0
            if path[0] in head:
                return S - 1
            raise ValueError(f"unexpected param subtree '{path[0]}'")

        paths = [p for p, _ in _paths(full)]
        self.leaf_slot = {p: i for i, p in enumerate(paths)}
        self.leaf_owner = torch.tensor([owner(p) for p in paths])
        by_id = {id(t): p for p, t in _paths(full)}
        self.groups: List[List[Tuple]] = [
            [by_id[id(t)] for t in pieces]
            for _, pieces in bkt.stream_leaves(full)]
        flat = [p for g in self.groups for p in g]
        self.piece_slot = {p: i for i, p in enumerate(flat)}
        self.piece_owner = torch.tensor([owner(p) for p in flat])

    def _gather(self, terms: Dict[Tuple, torch.Tensor], slot, owner,
                comm: Comm, width: int = 1) -> torch.Tensor:
        """(n, width) fp32: each slot's terms from its owner stage."""
        dev = next(iter(terms.values()))[0].device if terms else "cpu"
        mine = torch.zeros((len(slot), width), dtype=torch.float32,
                           device=dev)
        for path, vals in terms.items():
            for j, v in enumerate(vals):
                mine[slot[path], j] = v
        rows = comm.all_gather(mine)                    # (S, n, width)
        return rows[owner.to(rows.device),
                    torch.arange(len(slot), device=rows.device)]

    def grad_norm_sq(self, terms: Dict[Tuple, torch.Tensor],
                     comm: Comm) -> torch.Tensor:
        """``adam.global_norm``'s sum over the full tree from this
        stage's per-leaf terms (path -> squared sum)."""
        vals = self._gather({p: (t,) for p, t in terms.items()},
                            self.leaf_slot, self.leaf_owner, comm)
        return sum(vals[i, 0] for i in range(len(self.leaf_slot)))

    def lamb_trusts(self, psq: Dict[Tuple, torch.Tensor],
                    usq: Dict[Tuple, torch.Tensor], comm: Comm
                    ) -> Tuple[Dict[Tuple, torch.Tensor], torch.Tensor]:
        """``lamb.apply_update``'s trust ratio of every JAX leaf from
        this stage's per-piece terms: (path -> its leaf's ratio, the
        mean ratio over the leaves)."""
        vals = self._gather({p: (psq[p], usq[p]) for p in psq},
                            self.piece_slot, self.piece_owner, comm, 2)
        trust_of, trusts = {}, []
        for group in self.groups:
            idx = [self.piece_slot[p] for p in group]
            trust = lamb.trust_from_norms(sum(vals[i, 0] for i in idx),
                                          sum(vals[i, 1] for i in idx))
            trust_of.update({p: trust for p in group})
            trusts.append(trust)
        return trust_of, torch.mean(torch.stack(trusts))


@torch.no_grad()
def stage_update(own: Any, grads: Any, opt: adam.AdamState, ocfg,
                 lr: torch.Tensor, index: StageIndex, comm: Comm,
                 first_layer: int
                 ) -> Tuple[Any, adam.AdamState, Dict[str, torch.Tensor]]:
    """One stage rank's AdamW or LAMB update of what it owns, in place:
    the elementwise math of ``adam.apply_update`` / ``lamb.apply_update``
    on its leaves, the grad norm (for the metric and the clip) and
    LAMB's per-leaf norms summed over every stage through ``index``."""
    path_of = {id(t): _global_path(p, first_layer) for p, t in _paths(own)}
    gnorm = torch.sqrt(index.grad_norm_sq(
        {path_of[id(p)]: torch.sum(torch.square(g.float()))
         for p, g in zip(tree_leaves(own), tree_leaves(grads))}, comm))
    if ocfg.grad_clip > 0:
        scale = adam.clip_scale(gnorm, ocfg.grad_clip)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    step = opt.step + 1
    bc1, bc2 = adam.bias_corrections(ocfg, step)
    is_lamb = ocfg.name == "lamb"
    terms, psq, usq = [], {}, {}
    for shape, (ps, gs, ms, vs) in adam.leaf_groups(own, grads, opt.m,
                                                    opt.v):
        for p, g, m, v in zip(ps, gs, ms, vs):
            pf, update, mf, vf = adam.moments(g, m, v, p, ocfg, bc1, bc2,
                                              len(shape) >= 2)
            if not is_lamb:
                p.copy_(pf - lr * update)
            else:
                key = path_of[id(p)]
                psq[key] = torch.sum(torch.square(pf))
                usq[key] = torch.sum(torch.square(update))
                terms.append((p, pf, update, key))
            m.copy_(mf)
            v.copy_(vf)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if is_lamb:
        trust_of, metrics["trust_ratio"] = index.lamb_trusts(psq, usq, comm)
        for p, pf, update, key in terms:
            p.copy_(pf - lr * trust_of[key] * update)
    return own, adam.AdamState(step=step, m=opt.m, v=opt.v), metrics


class PipeHop:
    """A stage rank's boundary traffic with the other stages of its
    ``pipe`` group (the JAX package's ``_pipe_send``), one message per
    event that crosses a stage boundary:

      * ``("F", m)`` stage s -> s+1: the activation and the aux carry of
        microbatch m (F(s, m));
      * ``("B", m)`` stage s -> s-1: their cotangents (B(s, m));
      * ``("T", m)`` stage 0 -> the last stage (a tied table): the rows
        of the gather's gradient that microbatch m's tokens touched
        (B(0, m));
      * ``("E", 0)`` the last stage -> stage 0 (a tied table): the table
        after the update.

    The messages between two stages are numbered in the order
    ``core/pipeline.py::program_order`` produces them, and both stages
    post them in that order: before a send, every earlier receive of the
    pair is posted; a receive posts everything up to it. No rank then
    waits on a message its peer can only send after a message it has
    not posted, so 1F1B's steady state, where a stage sends forward and
    receives backward in one slot, cannot deadlock on NCCL's in-order
    point-to-point streams. Each tensor of a message is one hop with its
    own tag. ``shapes(msg)`` gives a received message's (shape, dtype)
    list."""

    def __init__(self, comm: Comm, order, num_stages: int, stage: int,
                 tied: bool, device: torch.device):
        S = num_stages
        msgs = []
        for s, kind, m in order:
            if kind == pipe.FWD and s < S - 1:
                msgs.append(("F", m, s, s + 1))
            elif kind == pipe.BWD and s > 0:
                msgs.append(("B", m, s, s - 1))
            if kind == pipe.BWD and s == 0 and tied:
                msgs.append(("T", m, 0, S - 1))
        if tied:
            msgs.append(("E", 0, S - 1, 0))
        self.comm, self.stage, self.device = comm, stage, device
        self.lines: Dict[int, List[Tuple]] = {}
        for msg in msgs:
            src, dst = msg[2], msg[3]
            if stage in (src, dst):
                self.lines.setdefault(dst if src == stage else src,
                                      []).append(msg)
        # (kind, m) -> (peer, number): a stage sends and receives at
        # most one message of each kind and microbatch
        self.outgoing: Dict[Tuple[str, int], Tuple[int, int]] = {}
        self.incoming: Dict[Tuple[str, int], Tuple[int, int]] = {}
        for peer, line in self.lines.items():
            for i, (kind, m, src, _) in enumerate(line):
                side = self.outgoing if src == stage else self.incoming
                side[(kind, m)] = (peer, i)
        self.shapes: Callable = lambda msg: []
        self.pos: Dict[int, int] = {}
        self.recvs: Dict[Tuple, List[Pending]] = {}
        self.sends: List[Pending] = []

    def begin(self, shapes: Callable) -> None:
        """Start a step's traffic; ``shapes(kind, m)`` gives a message's
        received (shape, dtype) list."""
        self.shapes = shapes
        self.pos = {peer: 0 for peer in self.lines}

    def _post_until(self, peer: int, upto: int,
                    send: Optional[Sequence[torch.Tensor]] = None) -> None:
        line = self.lines[peer]
        while self.pos[peer] <= upto:
            i = self.pos[peer]
            kind, m, src, _ = line[i]
            if src == self.stage:
                if i != upto or send is None:
                    raise RuntimeError(
                        f"stage {self.stage}: message {line[i][:2]} must "
                        f"be sent before {line[upto][:2]}")
                self.sends += [self.comm.send(t, peer, tag=2 * i + j)
                               for j, t in enumerate(send)]
            else:
                self.recvs[(kind, m)] = [
                    self.comm.recv(shape, dtype, self.device, peer,
                                   tag=2 * i + j)
                    for j, (shape, dtype) in enumerate(
                        self.shapes(kind, m))]
            self.pos[peer] += 1

    def send(self, kind: str, m: int,
             tensors: Sequence[torch.Tensor]) -> None:
        self._post_until(*self.outgoing[(kind, m)], tensors)

    def recv(self, kind: str, m: int) -> List[torch.Tensor]:
        self._post_until(*self.incoming[(kind, m)])
        return [p.wait() for p in self.recvs.pop((kind, m))]

    def wait_sends(self) -> None:
        for p in self.sends:
            p.wait()
        self.sends = []

    def finish(self) -> None:
        """Wait on every send of the step; every message must have been
        posted."""
        self.wait_sends()
        left = {peer: line[self.pos[peer]:]
                for peer, line in self.lines.items()
                if self.pos[peer] < len(line)}
        if left or self.recvs:
            raise RuntimeError(f"stage {self.stage}: messages never posted "
                               f"{left} or never read {list(self.recvs)}")


def modeled_pipe_bytes(cfg, splan: pipe.StagePlan, ocfg, *,
                       microbatches: int, mb_rows: int, seq_len: int,
                       stage: int, touched_rows: Sequence[int] = ()) -> int:
    """The bytes stage rank ``stage`` sends over its pipe group in one
    step: M activations (compute dtype) and M aux carries (fp32) to the
    next stage, M cotangents and aux cotangents to the previous one;
    with a tied table, from stage 0 the touched rows of each
    microbatch's gather gradient (``touched_rows[m]`` rows of d_model
    in the parameter dtype) and from the last stage the table after the
    update; and its row of each all-gather: the metrics (3 fp32), the
    grad norm's per-leaf terms and under LAMB the per-piece norm terms
    (2 each)."""
    from repro_torch.models.blocks import dtype_of as _dt
    S, M, d = splan.num_stages, microbatches, cfg.d_model
    act = mb_rows * seq_len * d * _dt(cfg.compute_dtype).itemsize + 4
    pbytes = _dt(cfg.param_dtype).itemsize
    tied = "embed" in tr.head_param_keys(cfg)
    total = M * act * ((stage < S - 1) + (stage > 0))
    if tied and stage == 0:
        total += sum(int(n) for n in touched_rows) * d * pbytes
    if tied and stage == S - 1:
        total += cfg.vocab_size * d * pbytes
    leaves = len(tree_leaves(_param_shapes(cfg)))
    total += (S - 1) * 4 * (3 + leaves + (2 * leaves if ocfg.name == "lamb"
                                          else 0))
    return total


def _build_pipeline_step(model: Model, tcfg: TrainConfig, mesh: ProcessMesh):
    """The pipelined train step (the JAX package's
    ``_build_pipeline_step``): capacity-sized contiguous stages, the
    accumulation microbatches streamed through them in 1F1B (or GPipe)
    program order (``core/pipeline.py::program_order``).

    An F event runs one stage's forward on its boundary input (detached,
    requiring grad) and keeps the graph; the last stage adds ``ce + aux
    * w`` and ``w`` into the fp32 sums (``w`` the aux term's weight,
    :func:`aux_weight_for`). A B event takes the gradient of that graph
    with the cotangents from the next stage, the activation's and the
    aux carry's (``torch.autograd.grad``): the stage slice's gradients
    are added into the fp32 accumulator (microbatch order, the
    monolithic step's add order) and the input cotangent goes back a
    stage. A tied table's
    head gradient is added to the gather's once per microbatch at the
    stage-0 B event, the monolithic backward's association. Then the
    reduction over the data-parallel ranks: "allreduce" a per-leaf fp32
    all-reduce after the drain; "bucketed_allreduce" the fp32 bucket
    stream, each stage's buckets flushed through ``BucketFlushPipeline``
    the moment the last microbatch's B event for that stage lands. Then
    the weight division once and the tree AdamW or LAMB. In fp32 with
    ``grad_clip=0`` it is bitwise the ``pipeline_stages=1`` step.

    Without a ``pipe`` axis one process runs every stage (the JAX
    driver's path: its ``_pipe_send`` is the identity there). With one,
    stage rank s runs only its own events, ``stage_schedule(S, M)[s]`` in
    order, on what it holds (:func:`stage_params`), and the boundary
    values cross ranks through :class:`PipeHop`; the metrics come from
    the last stage, the update's sums over every stage through
    :class:`StageIndex`, and a tied table's gradient meets its head part
    on the last stage, which sends the updated table back to stage 0."""
    cfg, het, ocfg = model.cfg, tcfg.het, tcfg.optimizer
    splan = stage_plan_for(model, tcfg)
    S, M = splan.num_stages, max(1, het.accum_steps)
    ranges = splan.stage_ranges()
    seg = tr.pipeline_stage_fns(cfg, ranges,
                                label_smoothing=tcfg.label_smoothing)
    embed_fn, head_fn = seg["embed_fn"], seg["head_fn"]
    stage_fwd, head_keys = seg["stage_fwd"], seg["head_keys"]
    tied = "embed" in head_keys
    # an embedding-stub frontend has no table: stage 0's embed_fn is the
    # identity (a cast) and its B event takes no input gradient
    token = cfg.frontend == "token"
    order = pipe.program_order(S, M, het.pipeline_schedule)
    staged = _staged(tcfg, mesh)
    me = mesh.pipe_index
    mine = (me,) if staged else tuple(range(S))
    events = [e for e in order if e[0] in mine]
    first = ranges[mine[0]][0]
    bucketed = het.grad_reduction == "bucketed_allreduce"
    q_impl = q_ops.impl_of(het.quantize_impl)
    dev = model.device
    cdt = dtype_of(cfg.compute_dtype)
    pdt = dtype_of(cfg.param_dtype)
    index = StageIndex(_param_shapes(cfg), cfg, splan) if staged else None
    hop = (PipeHop(mesh.pipe, order, S, me, tied, dev) if staged else None)
    owns_embed = (not staged) or me == (S - 1 if tied else 0)
    aux_weight = aux_weight_for(model, tcfg, mesh)
    cache: Dict[str, Any] = {}

    def layers_of(tree, s):
        r0, r1 = ranges[s]
        return tree["layers"][r0 - first:r1 - first]

    def owned(tree):
        return owned_params(tree, cfg, splan, me) if staged else tree

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        own = owned(params)
        lr = schedules.learning_rate(ocfg, state.opt.step + 1)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        mbs = split_microbatches(batch, M)
        # where each owned leaf's gradient accumulates: a tree of fp32
        # sums (bf16 params keep a bf16 carry, as accumulate_sums does),
        # or views of the fp32 bucket stream
        if bucketed:
            if "layout" not in cache:
                lo = bucket_layout(tcfg, mesh, own)
                cache["layout"] = lo
                cache["readiness"] = bkt.bucket_readiness(
                    lo, _pipeline_leaf_pieces(own, cfg, splan, first))
            layout = cache["layout"]
            stream = torch.zeros((layout.num_buckets, layout.bucket_elems),
                                 dtype=torch.float32, device=dev)
            flat = stream.view(-1)
            acc_of = {id(t): flat[off:off + t.numel()].view(t.shape)
                      for off, t in bkt.tree_pieces(owned(leaves), layout)}
            prep_k, exchange_k = bkt.bucket_legs(
                stream, None, comm=mesh.dp, compress=False,
                block_size=_BLOCK, impl=q_impl, total=layout.total)
            flusher = bkt.BucketFlushPipeline(
                cache["readiness"], lambda k, _raw: prep_k(k), exchange_k)

            def flush(stage):
                flusher.flush_ready_buckets(stage, lambda k: None)
        else:
            g_acc = tree_map(
                lambda p: torch.zeros(p.shape, device=p.device,
                                      dtype=p.dtype if p.dtype ==
                                      torch.bfloat16 else torch.float32),
                own)
            acc_of = {id(t): a for t, a in zip(tree_leaves(owned(leaves)),
                                               tree_leaves(g_acc))}

            def flush(stage):
                pass

        def add(t, g):
            a = acc_of[id(t)]
            a.add_(g.to(a.dtype))

        o_acc = torch.zeros((), dtype=torch.float32, device=dev)
        w_acc = torch.zeros_like(o_acc)
        touched = {}
        if staged and tied and me in (0, S - 1):
            touched = {m: torch.unique(mbs["inputs"][m]).long()
                       for m in range(M)}
        if staged:
            rows_mb, seq = mbs["inputs"].shape[1:3]
            act = ((rows_mb, seq, cfg.d_model), cdt)
            scalar = ((), torch.float32)
            hop.begin(lambda kind, m: {
                "F": [act, scalar], "B": [act, scalar],
                "T": [((len(touched.get(m, ())), cfg.d_model), pdt)],
                "E": [((cfg.vocab_size, cfg.d_model), pdt)]}[kind])
        boundary: Dict[Tuple[int, int], Tuple] = {}   # in-process hops
        saved: Dict[Tuple[int, int], Tuple] = {}
        head_emb: Dict[int, torch.Tensor] = {}

        def send(kind, s, m, tensors):
            if staged:
                hop.send(kind, m, tensors)
            else:
                boundary[(kind, s, m)] = tensors

        def recv(kind, s, m):
            if staged:
                return hop.recv(kind, m)
            return boundary.pop((kind, s, m))

        for s, kind, m in events:
            mb = {k: v[m] for k, v in mbs.items()}
            if kind == pipe.FWD:
                with torch.enable_grad():
                    if s == 0:
                        x_in = None
                        x = embed_fn({"embed": leaves["embed"]} if token
                                     else {}, mb["inputs"])
                        aux = torch.zeros((), dtype=torch.float32,
                                          device=dev)
                    else:
                        x_recv, aux = recv("F", s - 1, m)
                        x = x_in = x_recv.detach().requires_grad_(True)
                    positions = torch.arange(x.shape[1], device=dev)
                    x_out, a_out = stage_fwd[s](layers_of(leaves, s), x, aux,
                                                positions)
                    if s == S - 1:
                        ce, w = head_fn({k: leaves[k] for k in head_keys},
                                        x_out, mb["labels"], mb["weights"])
                # the graph's outputs and, but on the last stage, the
                # aux carry where a layer of the stage adds to it
                outs = [x_out] + ([a_out] if a_out.requires_grad else [])
                if s < S - 1:
                    send("F", s, m, (x_out.detach(), a_out.detach()))
                    saved[(s, m)] = (x_in, outs)
                else:
                    w_sg = w.detach()
                    a_w = w_sg if aux_weight is None else aux_weight(w_sg)
                    o_acc = o_acc + (ce.detach() + a_out.detach() * a_w)
                    w_acc = w_acc + w_sg
                    obj = ce + a_out * a_w if a_out.requires_grad else ce
                    saved[(s, m)] = (x_in, [obj], a_w)
                continue
            # a B event
            if s == S - 1:
                x_in, out, a_cot = saved.pop((s, m))
                cot = None
            else:
                x_in, out = saved.pop((s, m))
                cot, a_cot = recv("B", s + 1, m)
                cot = [cot, a_cot][:len(out)]
            inputs = tree_leaves(layers_of(leaves, s))
            n_slice = len(inputs)
            if s == S - 1:
                inputs += [t for k in head_keys for t in tree_leaves(leaves[k])]
            if s > 0:
                inputs.append(x_in)
            elif token:
                inputs.append(leaves["embed"])
            grads = list(torch.autograd.grad(out, inputs, grad_outputs=cot))
            del out, cot
            for t, g in zip(inputs[:n_slice], grads[:n_slice]):
                add(t, g)
            if s == S - 1:
                it = iter(grads[n_slice:])
                for k in head_keys:
                    for t in tree_leaves(leaves[k]):
                        g = next(it)
                        if k == "embed":    # tied: held for the stage-0 B
                            head_emb[m] = g
                        else:
                            add(t, g)
            if m == M - 1:
                flush(S - 1 - s)
            if s > 0:
                send("B", s, m, (grads[-1], a_cot))
                continue
            if token:
                g_emb = grads[-1]
                if not tied:
                    add(leaves["embed"], g_emb)
                elif staged:
                    hop.send("T", m, (g_emb.index_select(0, touched[m]),))
                else:
                    add(leaves["embed"], g_emb + head_emb.pop(m))
            if m == M - 1 and owns_embed:
                flush(S)
        if staged and tied and me == S - 1:
            # the gather's gradient rows from stage 0 meet the head's,
            # one add a microbatch in microbatch order
            emb = leaves["embed"]
            for m in range(M):
                rows, = hop.recv("T", m)
                dense = torch.zeros(emb.shape, dtype=rows.dtype, device=dev)
                dense.index_copy_(0, touched[m], rows)
                add(emb, dense + head_emb.pop(m))
                del dense
            flush(S)
        del saved, leaves
        if staged:
            hop.wait_sends()
        # the metrics: the last stage's sums over the data-parallel ranks
        # (as the monolithic step reduces them), given to every stage
        holder = (not staged) or me == S - 1
        if holder:
            loss, w = weighting.psum_weighted(o_acc, w_acc, mesh.dp)
            w_grad = (w if bucketed
                      else mesh.dp.all_reduce(w_acc.float().clone()))
            met = torch.stack([loss, w, w_grad])
        else:
            met = torch.zeros(3, dtype=torch.float32, device=dev)
        if staged:
            met = mesh.pipe.all_gather(met)[S - 1]
        loss, w, w_grad = met[0], met[1], met[2]
        inv = 1.0 / torch.clamp(w_grad, min=1e-9)
        if bucketed:
            flusher.finish()
            grads_t = tree_map(lambda t: t.mul_(inv.to(t.dtype)),
                               bkt.unpack_buckets(stream, layout, own))
        else:
            grads_t = tree_map(
                lambda g: mesh.dp.all_reduce(g).mul_(inv.to(g.dtype)), g_acc)
        if staged:
            _, opt, out_met = stage_update(own, grads_t, state.opt, ocfg, lr,
                                           index, mesh.pipe, first)
            if tied and me == S - 1:            # the table to stage 0
                hop.send("E", 0, (params["embed"],))
            elif tied and me == 0:
                params["embed"].copy_(hop.recv("E", 0)[0])
            hop.finish()
        else:
            _, opt, out_met = _opt_apply(ocfg)(params, grads_t, state.opt,
                                               ocfg, lr)
        return (TrainState(params=params, opt=opt, err=state.err),
                {"loss": loss, "weight": w, **out_met})

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
