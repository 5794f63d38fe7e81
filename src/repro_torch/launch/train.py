"""Heterogeneous data-parallel training driver
(port of ``repro/launch/train.py``).

Wires: synthetic corpus -> sharded dataset -> capacity plan -> het
sampler + prefetch loader -> train step (weighted objective sum and
weight sum, reduced over the ranks, divided once; clip; AdamW) ->
straggler monitor -> checkpoints -> elastic restart. The plan's headroom
leaves weight-0 dummy rows in every batch, and they run forward and
backward on the device like real rows (the paper's dummy-batch path); a
rank of capacity 0 runs only dummy rows.

``--devices`` is read as the JAX driver reads it: ``data,model`` or
``pod,data,model``. With more than one data-parallel rank the driver
builds the kernels, writes the corpus, then spawns one process per rank
(``launch/mesh.py``): rank ``r = pod * data + d`` takes rows ``[r*b,
(r+1)*b)`` of each packed global batch, the order of the JAX package's
``P(("pod", "data"))`` batch sharding. Rank 0 logs. The backend and the
transport are printed. A ``model`` axis above 1 raises (tensor
parallelism is not ported yet).

``--device`` defaults to ``cuda`` and the CPU runs only when asked for.
Attention, cross entropy and the int8 exchange go through the kernels
(``attention_impl="kernel"``, ``ce_impl="kernel"``,
``quantize_impl="pallas"``): the CUDA kernels on the card, their plain
versions on the CPU. The synthetic corpus goes to ``--data-dir``, or to a
temporary directory (under ``$TMPDIR``) that is removed at the end.

Fault tolerance, as the JAX driver has it:

  * ``--ckpt-every N`` writes a checkpoint every N steps and at the end,
    to ``--ckpt-dir`` (default ``$TMPDIR/hetseq_ckpt``), in the JAX
    package's on-disk format (``checkpoint/checkpoint.py``: per-pod
    shard files behind a sha256 manifest, written by rank 0 on a
    background thread; the residual of every pod gathered first);
    ``--resume`` restores the latest one that verifies and continues at
    its data-stream position. Without ``--ckpt-every`` nothing is
    written.
  * ``--chaos <preset|schedule.json>`` and ``--kill-pod P@S`` (a pod
    stops reporting from step S; needs two pods or more) feed the chaos
    engine's modelled per-rank step times, built from the slowest rank's
    wall (a MAX over the ranks, so every rank makes the same decisions),
    to the straggler monitor, which replans every ``--replan-interval``
    steps or when a rank dies. A replan that no longer fits the buffers
    raises ``RemeshRequired``: every rank joins its writer and returns;
    the driver plans the surviving pods' mesh (``core/elastic.py``),
    scales ``accum_steps``, spawns the new world, and its ranks restore
    the latest checkpoint through the repack. The losses of the steps
    after that checkpoint are dropped from the run's record.
  * ``--dry-run`` checks the configuration and exits.

Training modes, as the JAX driver has them: ``--optimizer lamb``
(the per-leaf trust ratio; the ``[train]`` lines and the summary show
its mean); ``--overlap buckets`` (the per-bucket exchange pipeline
after the backward, each landed bucket's update fused in) and
``--overlap backward --no-scan-layers`` (buckets flushed as the
backward lands them), both with ``--grad-reduction bucketed_allreduce``
or ``hierarchical`` and ``--bucket-mb``; ``--weighting canonical`` (the
sampler's plan-independent row order; every rank is given the whole
global batch and runs an equal share of its rows one at a time, so a
replan changes no bit).

Pipeline parallelism, as the JAX driver has it: ``--pipeline-stages S
--pipeline-schedule {1f1b,gpipe} --no-scan-layers`` cuts the layer stack
into S contiguous stages (sized by ``--capacities`` when it has S
positive entries, else uniform) and streams the ``--accum``
microbatches through them in program order; every data-parallel rank
runs all the stages in its own process, and checkpoints, ``--resume``
and the stage-plan restore log work as without stages. ``--pipe-axis``
puts each stage on its own processes instead (a leading ``pipe`` axis
of size S on ``--devices``: S times the data-parallel ranks; stage rank
``s`` of data-parallel rank ``r`` is rank ``s * dp + r`` and loads rank
``r``'s rows), the boundary values crossing between them point to
point. On a ``pipe`` axis a checkpoint gathers every stage's part to
rank 0 over the pipe group of data index 0 and writes the whole tree,
the same files as without the axis; a restore gives each stage rank its
part under the current cut; chaos, ``--kill-pod`` and the re-mesh run
as without it, and the new world is ``--pipeline-stages`` times the
surviving data-parallel ranks, cut by the surviving capacities (a
changed cut is logged). The ``[train] summary`` line records the stage
plan (layers per stage), the schedule and, with a ``pipe`` axis, each
rank's stage and pipe bytes per step.

Example (H100, one rank):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 6 --global-batch 8 --seq-len 1024 --accum 2 --lr 3e-4 \
      --warmup 2 --schedule constant
Example (H100, two ranks sharing the card, int8 cross-pod exchange):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --devices 2,1,1 --grad-reduction hierarchical --compression int8 \
      --bucket-mb 25 --capacities 2,1 --global-batch 8 --seq-len 1024 \
      --accum 2 --steps 4 --lr 3e-4 --warmup 2 --schedule constant
Example (CPU, smoke config, two ranks over gloo):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1,1 --grad-reduction hierarchical \
      --compression int8 --bucket-mb 0.05 --steps 10 --global-batch 8 \
      --seq-len 32
Example (CPU, two ranks, buckets flushed during the backward, LAMB):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1,1 --grad-reduction hierarchical \
      --compression int8 --bucket-mb 0.05 --overlap backward \
      --no-scan-layers --optimizer lamb --steps 4 --global-batch 8 \
      --seq-len 32
Example (CPU, two ranks, order-canonical weighting):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1 --weighting canonical \
      --steps 4 --global-batch 8 --seq-len 32
Example (H100, two pipeline stages in one process, the uniform cut):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --pipeline-stages 2 --no-scan-layers --steps 4 --global-batch 8 \
      --seq-len 1024 --accum 4
Example (CPU, two stages on their own ranks, two data-parallel ranks):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1 --pipeline-stages 2 --pipe-axis \
      --no-scan-layers --accum 2 --steps 4 --global-batch 8 --seq-len 32
Example (CPU, checkpoint then resume):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --steps 4 --ckpt-every 2 \
      --ckpt-dir "${TMPDIR:-.}/ck" --global-batch 8 --seq-len 32
  (the same command with --resume --steps 6 continues at step 5)
Example (CPU, pod 1 lost at step 3: re-mesh to one pod, accum x2):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1,1 --grad-reduction hierarchical \
      --compression int8 --bucket-mb 0.05 --steps 8 --ckpt-every 2 \
      --kill-pod 1@3 --ckpt-dir "${TMPDIR:-.}/ck2" --global-batch 8 \
      --seq-len 32
Example (CPU, four stage ranks, pod 1 lost at step 3: re-mesh to one
pod of two stage ranks from the step-4 checkpoint; at a global batch of
8 pod 0's buffer would take pod 1's rows and nothing would re-mesh):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --devices 2,1,1 --capacities 2,1 \
      --pipeline-stages 2 --pipe-axis --no-scan-layers --accum 2 \
      --steps 6 --ckpt-every 2 --kill-pod 1@3 \
      --ckpt-dir "${TMPDIR:-.}/ck3" --global-batch 16 --seq-len 32
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import resource
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import (HetConfig, ModelConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import capacity as cap
from repro_torch.core import chaos, elastic
from repro_torch.core.straggler import RemeshRequired, StragglerMonitor
from repro_torch.data.dataset import ShardedDataset
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.sampler import HetSampler
from repro_torch.data.synthetic import build_synthetic_corpus
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import build_model

CKPT_DIR = os.path.join(tempfile.gettempdir(), "hetseq_ckpt")


def build_config(args) -> Tuple[ModelConfig, TrainConfig]:
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    if cfg.frontend != "token":
        # the corpus is token ids, as the JAX driver's is; a stub model
        # trains through steps.build_train_step on embedding batches
        raise ValueError(
            f"--arch {args.arch}: frontend '{cfg.frontend}' takes "
            f"precomputed embeddings (B, S, d_model), and the driver's "
            f"synthetic corpus is token ids; train it through "
            f"launch.steps.build_train_step on embedding batches")
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
    if args.no_scan_layers:
        # the unrolled stack --overlap backward asks for (the port's
        # stack is a Python loop either way)
        cfg = dataclasses.replace(cfg, scan_layers=False)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    tcfg = TrainConfig(
        model=cfg, shape=shape,
        het=HetConfig(
            capacities=tuple(float(c) for c in args.capacities.split(","))
            if args.capacities else (),
            weighting=args.weighting,
            grad_reduction=args.grad_reduction,
            compression=args.compression,
            bucket_mb=args.bucket_mb,
            quantize_impl="pallas",             # the kernels (ops.impl_of)
            overlap=args.overlap,
            accum_steps=args.accum,
            replan_interval=args.replan_interval,
            pipeline_stages=args.pipeline_stages,
            pipeline_schedule=args.pipeline_schedule),
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  warmup_steps=args.warmup,
                                  total_steps=args.steps,
                                  schedule=args.schedule),
        seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    return cfg, tcfg


def make_plan(tcfg: TrainConfig, n_dp: int = 1) -> cap.CapacityPlan:
    """The JAX driver's plan: rows in proportion to capacity, headroom
    1.25 (the spare buffer rows are weight-0 dummies), buffers rounded
    to the accumulation steps."""
    caps = tcfg.het.capacities or tuple([1.0] * n_dp)
    if len(caps) != n_dp:
        raise SystemExit(f"--capacities needs {n_dp} entries (dp size)")
    return cap.plan_capacities(tcfg.shape.global_batch, caps,
                               headroom=1.25,
                               round_buffer_to=max(tcfg.het.accum_steps, 1))


def _parse_kill(spec: str) -> Optional[Tuple[int, int]]:
    """'P@S' -> (pod P, from global step S): a one-entry
    ``chaos.kill(pod=P, step=S)`` schedule."""
    if not spec:
        return None
    pod, at = spec.split("@")
    return int(pod), int(at)


def build_chaos_engine(args, tcfg: TrainConfig,
                       topo: elastic.MeshTopology) -> chaos.ChaosEngine:
    """Resolve --chaos (+ the --kill-pod alias) into one engine."""
    schedule = chaos.ChaosSchedule(seed=tcfg.seed)
    if args.chaos:
        try:
            schedule = chaos.load_schedule(
                args.chaos, num_ranks=topo.dp_size,
                data_per_pod=topo.data_per_pod,
                total_steps=args.steps, seed=tcfg.seed)
        except (ValueError, OSError) as e:
            raise SystemExit(f"[train] --chaos: {e}") from e
    kill = _parse_kill(args.kill_pod)
    if kill is not None:
        if topo.pods < 2:
            raise SystemExit(
                f"[train] --kill-pod {args.kill_pod}: losing a pod needs "
                f"a mesh of two pods or more (--devices pod,data,model); "
                f"this one has {topo.pods}")
        schedule = schedule.with_events(
            chaos.kill(pod=kill[0], step=kill[1]))
    try:
        return chaos.ChaosEngine(
            schedule, num_ranks=topo.dp_size,
            data_per_pod=topo.data_per_pod,
            speeds=tcfg.het.capacities or None)
    except ValueError as e:
        raise SystemExit(f"[train] {e}") from e


def _rank_rows(raw: Dict[str, np.ndarray], seq_len: int, rank: int,
               rows: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's rows of the packed global batch, on its device (the
    sampler pads the *labels*: inputs are the shifted view)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        raw[k][rank * rows:(rank + 1) * rows, :seq_len])).to(device)
        for k in ("inputs", "labels", "weights")}


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.cross_entropy import cross_entropy as ce
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.quantize import quantize as qz
    return {f.__name__: f.launches for f in (
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda,
        ce.cross_entropy_cuda, ce.ce_dlogits_cuda,
        qz.quantize_int8_cuda, qz.dequant_accum_cuda,
        qz.exchange_send_cuda, qz.exchange_receive_cuda,
        qz.exchange_decode_cuda)}


def _sent(mesh: mesh_mod.ProcessMesh) -> int:
    return sum(c.sent_bytes for c in {id(c): c for c in (
        mesh.world, mesh.pod, mesh.data, mesh.dp, mesh.pipe)}.values())


def _checksums(mesh: mesh_mod.ProcessMesh, params) -> List[int]:
    """Every rank's parameter checksum, gathered over the world (with a
    ``pipe`` axis, of what the rank's stage owns)."""
    mine = torch.tensor([steps_mod.params_checksum(params)],
                        dtype=torch.int64, device=mesh.device)
    return [int(x) for x in mesh.world.all_gather(mine).reshape(-1)]


def stage_groups(sums: Sequence[int], pipe_size: int) -> List[List[int]]:
    """The ranks' checksums by pipeline stage (every stage's
    data-parallel ranks must agree)."""
    n = len(sums) // pipe_size
    return [list(sums[s * n:(s + 1) * n]) for s in range(pipe_size)]


def model_checksum(sums: Sequence[int], pipe_size: int) -> int:
    """The whole model's checksum from the ranks' (each stage owns its
    part of the parameters once: the checksum is a sum over leaves)."""
    return sum(g[0] for g in stage_groups(sums, pipe_size))


def _slowest(mesh: mesh_mod.ProcessMesh, seconds: float) -> float:
    """The largest of every rank's ``seconds`` (the step's wall): one
    number, the same on every rank, for the straggler monitor."""
    t = torch.tensor([seconds], dtype=torch.float64, device=mesh.device)
    return float(mesh.world.all_reduce(t, op=dist.ReduceOp.MAX)[0])


def _modeled_pipe(cfg, tcfg: TrainConfig, splan, stage: int,
                  batch: Dict[str, torch.Tensor]) -> int:
    """``steps.modeled_pipe_bytes`` of one step on this batch: the
    tokens each microbatch touches counted from the batch itself."""
    M = max(1, tcfg.het.accum_steps)
    rows, seq = batch["inputs"].shape
    touched = [int(torch.unique(x).numel())
               for x in batch["inputs"].reshape(M, -1)]
    return steps_mod.modeled_pipe_bytes(
        cfg, splan, tcfg.optimizer, microbatches=M, mb_rows=rows // M,
        seq_len=seq, stage=stage, touched_rows=touched)


def restore_state(mgr: CheckpointManager, model, tcfg: TrainConfig,
                  mesh: mesh_mod.ProcessMesh, plan: cap.CapacityPlan,
                  fmt: Dict) -> Tuple[steps_mod.TrainState,
                                      Tuple[int, int, int]]:
    """The latest checkpoint that verifies, repacked into this config's
    layout and put on this rank's device, with its (step, epoch, batch
    in epoch). Refuses a checkpoint whose plan consumes another global
    record stream than ``plan``."""
    template = steps_mod.state_shapes(model, tcfg, mesh)
    host, meta = mgr.restore(template, expected_overlap=tcfg.het.overlap)
    saved_plan = meta.get("plan")
    if saved_plan is not None and not \
            elastic.validate_resume_equivalence(saved_plan, plan):
        raise SystemExit(
            f"[train] resume refused: checkpoint plan (rows "
            f"{list(saved_plan.rows_per_rank)}, global "
            f"{saved_plan.global_rows}) and the current plan (rows "
            f"{plan.rows_per_rank.tolist()}, global {plan.global_rows}) "
            f"consume different global record streams")
    saved_pipe = (meta.get("format") or {}).get("pipeline")
    if saved_pipe != fmt.get("pipeline") and mesh.rank == 0:
        # parameters are stored per leaf: the restore is exact under any
        # stage plan (a stage rank takes its part under the current cut),
        # so the change is logged, never adapted
        def desc(rec):
            if not rec:
                return "none"
            return (f"stages={len(rec['plan']['rows_per_rank'])} "
                    f"layers={rec['plan']['rows_per_rank']}")

        print(f"[train] restore: pipeline stage plan changed: "
              f"{desc(saved_pipe)} -> {desc(fmt.get('pipeline'))}",
              flush=True)
    state = steps_mod.state_from_host(host, model, tcfg, mesh)
    stream = meta.get("stream") or {}
    return state, (int(meta["step"]),
                   int(stream.get("epoch", meta.get("epoch", 0))),
                   int(stream.get("batch_in_epoch", 0)))


def run_rank(args, tcfg: TrainConfig, mesh: mesh_mod.ProcessMesh,
             data_dir: str, plan: cap.CapacityPlan,
             engine: chaos.ChaosEngine, resume: bool) -> Dict[str, Any]:
    """One rank's training loop (the whole run on one rank), from a
    fresh state or, with ``resume``, from the latest checkpoint. Ends at
    ``args.steps`` or at a ``RemeshRequired``, which every rank meets at
    the same step and reports under ``"remesh"``."""
    cfg = tcfg.model
    model = build_model(cfg, mesh.device)
    lead = mesh.rank == 0
    step_fn = steps_mod.build_train_step(model, tcfg, mesh)
    splan = steps_mod.stage_plan_for(model, tcfg)
    staged = mesh.pipe_size > 1

    def owned(params):
        """What this rank's stage owns (the whole tree without a pipe
        axis)."""
        return (steps_mod.owned_params(params, cfg, splan, mesh.pipe_index)
                if staged else params)
    corpus = build_synthetic_corpus(
        data_dir, num_seqs=max(4 * plan.global_rows, 256),
        seq_len=args.seq_len + 1, vocab=cfg.vocab_size, rows_per_shard=64,
        seed=tcfg.seed)
    canonical = tcfg.het.weighting == "canonical"
    sampler = HetSampler(ShardedDataset(corpus), plan, seed=tcfg.seed,
                         canonical_order=canonical)
    loader = PrefetchLoader(sampler, depth=args.prefetch)
    mgr = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep,
                             fault_hook=engine.ckpt_fault_hook())
           if tcfg.ckpt_every > 0 or resume else None)
    fmt = steps_mod.checkpoint_format(model, tcfg, mesh)
    step = epoch = batch_in_epoch = 0
    restored = None
    if resume and mgr.latest_step() is not None:
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(model.device)

        def host_peak():
            """The process's peak resident set (Linux reports KiB)."""
            return 1024 * resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

        before = host_peak()
        t0 = time.perf_counter()
        state, (step, epoch, batch_in_epoch) = restore_state(
            mgr, model, tcfg, mesh, plan, fmt)
        # the peaks before and by the end of the restore, and what it
        # allocated on the card
        restored = {**mgr.last_restore, "seconds": time.perf_counter() - t0,
                    "host_peak_before_bytes": before,
                    "host_peak_bytes": host_peak(),
                    "device_peak_bytes": (
                        torch.cuda.max_memory_allocated(model.device)
                        if model.device.type == "cuda" else None)}
        if lead:
            print(f"[train] resumed from step {step} (epoch {epoch}, batch "
                  f"{batch_in_epoch}) in {restored['seconds']:.1f} s "
                  f"(manifest check {restored['verify_s']:.1f} s)",
                  flush=True)
    else:
        state = steps_mod.init_train_state(model, tcfg, mesh=mesh)
    start_step = step
    start_sums = _checksums(mesh, owned(state.params))
    if any(len(set(g)) != 1 for g in stage_groups(start_sums,
                                                  mesh.pipe_size)):
        raise RuntimeError(f"ranks start from different parameters: "
                           f"checksums {start_sums}")
    monitor = StragglerMonitor(num_ranks=mesh.dp_size,
                               ema_decay=tcfg.het.straggler_ema,
                               replan_interval=tcfg.het.replan_interval)

    def save_meta():
        return {"epoch": epoch, "seed": tcfg.seed, "plan": plan,
                "format": fmt,
                "stream": {"epoch": epoch,
                           "batch_in_epoch": batch_in_epoch}}

    saves: List[Dict[str, Any]] = []

    def save():
        t0 = time.perf_counter()
        host = steps_mod.state_to_host(state, tcfg, mesh)  # collective
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0}
        if host is not None:
            mgr.save(step, host, meta=save_meta())
            rec["wait_s"] = mgr.last_save["wait_s"]
            print(f"[ckpt] step {step}: host snapshot {rec['snapshot_s']:.2f}"
                  f" s, the loop waited {rec['wait_s']:.2f} s for the "
                  f"previous write", flush=True)
        saves.append(rec)

    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    launches0 = _launch_counts()
    losses, step_s, records, link, during_save = [], [], [], [], []
    pipe_bytes: List[int] = []
    pipe_modeled: List[int] = []
    replans: List[Dict[str, Any]] = []
    remesh = None
    t_start = time.time()
    body_raised = False
    try:
        try:
            while step < args.steps:
                replanned = False
                consumed = batch_in_epoch
                for raw in loader.iter_epoch(epoch, start=batch_in_epoch):
                    if step >= args.steps:
                        break
                    consumed += 1
                    # canonical: the whole global batch on every rank,
                    # which runs its own share of the rows
                    batch = (_rank_rows(raw, args.seq_len, 0,
                                        plan.global_rows, model.device)
                             if canonical else
                             _rank_rows(raw, args.seq_len, mesh.dp_rank,
                                        plan.buffer_rows, model.device))
                    during_save.append(mgr is not None and mgr.busy())
                    t0 = time.time()
                    sent0 = _sent(mesh)
                    pipe0 = mesh.pipe.sent_bytes
                    state, metrics = step_fn(state, batch)
                    rec = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t0          # float() synchronized
                    step += 1
                    batch_in_epoch = consumed
                    losses.append(rec["loss"])
                    step_s.append(dt)
                    records.append(rec)
                    link.append(_sent(mesh) - sent0)
                    pipe_bytes.append(mesh.pipe.sent_bytes - pipe0)
                    if staged:
                        pipe_modeled.append(_modeled_pipe(
                            cfg, tcfg, splan, mesh.pipe_index, batch))
                    if lead and (step % args.log_every == 0
                                 or step == args.steps):
                        print(f"[train] step {step:5d} loss "
                              f"{rec['loss']:.4f} grad_norm "
                              f"{rec['grad_norm']:.4f} weight "
                              f"{rec['weight']:.0f} lr {rec['lr']:.3g} "
                              + (f"trust {rec['trust_ratio']:.4f} "
                                 if "trust_ratio" in rec else "")
                              + f"({dt * 1e3:.0f} ms)", flush=True)
                    # modelled per-rank times from the slowest rank's
                    # wall: killed ranks and flaky drops report None
                    monitor.observe(engine.step_times(
                        step, plan.rows_per_rank, _slowest(mesh, dt)))
                    if monitor.should_replan():
                        new_plan = monitor.replan(plan)
                        rows = new_plan.rows_per_rank.tolist()
                        if rows != plan.rows_per_rank.tolist():
                            if lead:
                                print(f"[train] replan at step {step}: "
                                      f"rows {plan.rows_per_rank.tolist()}"
                                      f" -> {rows}", flush=True)
                            replans.append({"step": step, "rows": rows})
                            replanned = True
                        plan = new_plan
                        sampler.set_plan(plan)
                    if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
                        save()
                    if replanned:
                        break    # re-open the epoch here under the plan
                if replanned:
                    continue
                if step >= args.steps:
                    break
                epoch += 1
                batch_in_epoch = 0
            if tcfg.ckpt_every and step > start_step and (
                    not saves or saves[-1]["step"] != step):
                save()
        except RemeshRequired as e:
            remesh = {"step": step, "dead": monitor.dead_ranks().tolist(),
                      "reason": str(e), "plan": cap.plan_record(plan)}
    except BaseException:
        body_raised = True
        raise
    finally:
        # join the writer on every exit path, or the run's last
        # checkpoint dies with the thread; a write error propagates on
        # a clean exit and is printed while another error unwinds
        if mgr is not None:
            try:
                mgr.wait()
            except BaseException as werr:
                if not body_raised:
                    raise
                print(f"[train] WARNING: checkpoint writer failed during "
                      f"shutdown: {werr!r}")
    wall = time.time() - t_start
    launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    end_sums = _checksums(mesh, owned(state.params))
    peak = (torch.cuda.max_memory_allocated(model.device)
            if model.device.type == "cuda" else None)
    return {"rank": mesh.rank, "start_step": start_step, "steps": step,
            "wall_s": wall, "losses": losses, "step_s": step_s,
            "metrics": records, "link_bytes": link, "launches": launches,
            "pipe_bytes": pipe_bytes, "pipe_bytes_modeled": pipe_modeled,
            "stage": mesh.pipe_index,
            "pipe_size": mesh.pipe_size,
            "model_checksum": model_checksum(end_sums, mesh.pipe_size),
            "ckpt_attempts": dict(engine.ckpt_attempts),
            "during_save": during_save, "replans": replans,
            "remesh": remesh, "saves": saves,
            "writes": list(mgr.writes) if mgr is not None and lead else [],
            "restore": restored, "plan": cap.plan_record(plan),
            "start_checksums": start_sums, "end_checksums": end_sums,
            "peak_memory_bytes": peak, "backend": mesh.backend,
            "transport": mesh.transport, "device": str(model.device),
            "state": state}


def _rank_main(rank: int, world: int, init_method: str, args,
               tcfg: TrainConfig, devices: str, data_dir: str,
               plan: cap.CapacityPlan, engine: chaos.ChaosEngine,
               resume: bool) -> Dict[str, Any]:
    mesh_mod.share_cpu(world)
    shape, axes = mesh_shape(args, devices)
    mesh = mesh_mod.init(shape, axes, rank, init_method,
                         torch.device(args.device).type)
    try:
        if rank == 0:
            print(f"[train] rank 0 of {world}: {mesh.describe()}",
                  flush=True)
        out = run_rank(args, tcfg, mesh, data_dir, plan, engine, resume)
    finally:
        mesh_mod.destroy(mesh)
    del out["state"]                    # stays in the rank's process
    return out


def _run_world(args, tcfg: TrainConfig, devices: str,
               plan: cap.CapacityPlan, engine: chaos.ChaosEngine,
               resume: bool, data_dir: str) -> List[Dict[str, Any]]:
    """Every rank of the mesh ``devices`` from start to end: one rank
    in this process, several spawned."""
    shape, axes = mesh_shape(args, devices)
    sizes = dict(zip(axes, shape))
    n_dp = (sizes.get("pod", 1) * sizes["data"]
            * sizes.get(mesh_mod.PIPE_AXIS, 1))
    dev = torch.device(args.device)
    if n_dp == 1:
        mesh = mesh_mod.local(shape, axes, dev)
        print(f"[train] {mesh.describe()}")
        return [run_rank(args, tcfg, mesh, data_dir, plan, engine, resume)]
    if dev.type == "cuda":
        # every rank loads the library; build it once, here
        from repro_torch.kernels import _build
        _build.build()
    ranks = mesh_mod.spawn(_rank_main, n_dp, (args, tcfg, devices, data_dir,
                                              plan, engine, resume))
    for key in ("replans", "remesh"):
        if any(r[key] != ranks[0][key] for r in ranks):
            raise RuntimeError(f"ranks disagree on {key}: "
                               f"{[r[key] for r in ranks]}")
    return ranks


def mesh_shape(args, devices: str) -> Tuple[Tuple[int, ...],
                                            Tuple[str, ...]]:
    """The mesh of ``--devices``, with ``--pipe-axis`` a leading ``pipe``
    axis of ``--pipeline-stages``."""
    shape, axes = mesh_mod.parse_devices(devices)
    if getattr(args, "pipe_axis", False):
        shape, axes = mesh_mod.with_pipe(shape, axes, args.pipeline_stages)
    return shape, axes


def _remesh(rec: Dict[str, Any], topo: elastic.MeshTopology,
            tcfg: TrainConfig, latest: Optional[int]
            ) -> Tuple[elastic.RemeshDecision, List[int]]:
    """The surviving pods' mesh and plan after ``RemeshRequired``, and
    the surviving pods: a pod is lost when every one of its ranks is
    dead (re-mesh granularity is whole pods). ``latest``: the newest
    committed checkpoint, which the new world restores."""
    if latest is None:
        raise SystemExit(
            f"[train] remesh required ({rec['reason']}) but no checkpoint "
            f"exists to restart from — set --ckpt-every")
    dead = set(rec["dead"])
    dpp = topo.data_per_pod
    alive = [p for p in range(topo.pods)
             if not all(r in dead for r in range(p * dpp, (p + 1) * dpp))]
    caps = tcfg.het.capacities
    caps_per_pod = ([float(np.mean(caps[p * dpp:(p + 1) * dpp]))
                     for p in range(topo.pods)] if caps else None)
    plan = cap.plan_from_record(rec["plan"])
    decision = elastic.plan_remesh(
        topo, alive, plan.global_rows, caps_per_pod,
        round_buffer_to=max(tcfg.het.accum_steps, 1))
    print(f"[train] remesh: {decision.reason}")
    if not decision.restart_required:
        raise SystemExit(
            f"[train] ranks {sorted(dead)} are dead but no whole pod is "
            f"lost, and soft replanning cannot absorb them "
            f"({rec['reason']}); shrink the global batch or drain the "
            f"affected pod")
    if not elastic.validate_resume_equivalence(plan, decision.plan):
        raise SystemExit("[train] remesh produced a plan that consumes a "
                         "different global record stream")
    return decision, alive


def _check_microbatches(tcfg: TrainConfig, plan: cap.CapacityPlan) -> None:
    """The re-meshed world's microbatches: its buffer must split into
    ``accum_steps`` of them, and with pipeline stages they must fill the
    pipe (``accum_steps >= pipeline_stages``, as ``HetConfig.validate``
    requires); the re-mesh fails here, before any rank starts."""
    het = tcfg.het
    try:
        het.validate()
    except ValueError as e:
        raise SystemExit(f"[train] re-mesh: accum_steps "
                         f"{het.accum_steps} does not fit the config: {e}")
    if plan.buffer_rows % max(het.accum_steps, 1):
        raise SystemExit(
            f"[train] re-mesh: the buffer of {plan.buffer_rows} rows does "
            f"not split into accum_steps={het.accum_steps} microbatches")


def train(args) -> Dict[str, Any]:
    topo = mesh_mod.topology_from_devices(args.devices)
    cfg, tcfg = build_config(args)
    plan = make_plan(tcfg, topo.dp_size)
    print(f"[train] {cfg.name}: {cfg.param_count():,} params on "
          f"{args.device}, {topo.dp_size} rank(s) (mesh "
          f"{dict(zip(topo.mesh_axes(), topo.mesh_shape()))}), plan rows "
          f"{plan.rows_per_rank.tolist()} buffer {plan.buffer_rows} "
          f"(efficiency {plan.efficiency():.2f}), reduction "
          f"{args.grad_reduction} compression {args.compression} "
          f"bucket_mb {args.bucket_mb} overlap {args.overlap} optimizer "
          f"{args.optimizer} weighting {args.weighting}; attention, cross entropy and the "
          f"int8 exchange through the kernels")
    splan = steps_mod.stage_plan_for(build_model(cfg, "cpu"), tcfg)
    if splan is not None:
        print(f"[train] pipeline: {splan.num_stages} stages, layers per "
              f"stage {splan.layers_per_stage.tolist()}, schedule "
              f"{args.pipeline_schedule}, "
              + (f"each stage on its own ranks (pipe axis: "
                 f"{splan.num_stages * topo.dp_size} ranks)"
                 if args.pipe_axis else "every stage in each rank's "
                 "process"))
    engine = build_chaos_engine(args, tcfg, topo)
    if engine.schedule.events:
        kinds = sorted({ev.kind for ev in engine.schedule.events})
        print(f"[train] chaos: {len(engine.schedule.events)} event(s) "
              f"{kinds} (seed {engine.schedule.seed})")
    shape, axes = mesh_shape(args, args.devices)
    steps_mod.validate_train_config(build_model(cfg, "cpu"), tcfg,
                                    mesh_mod.unjoined(shape, axes))
    if args.dry_run:
        print(f"[train] dry-run ok: grad_reduction="
              f"{tcfg.het.grad_reduction} overlap={tcfg.het.overlap} "
              f"bucket_mb={tcfg.het.bucket_mb} "
              f"compression={tcfg.het.compression} "
              f"accum={tcfg.het.accum_steps} "
              f"optimizer={tcfg.optimizer.name} "
              f"scan_layers={cfg.scan_layers} "
              f"pipeline_stages={tcfg.het.pipeline_stages}")
        return {"steps": 0, "wall_s": 0.0}
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but CUDA is "
                           f"not available; pass --device cpu to run on "
                           f"the CPU")
    print(f"[train] checkpoints: "
          + (f"every {args.ckpt_every} steps and at the end to "
             f"{args.ckpt_dir} (keep {tcfg.ckpt_keep})"
             if args.ckpt_every > 0 else "none (--ckpt-every 0)")
          + f"; straggler replans every {args.replan_interval} steps or "
            f"when a rank dies")
    devices = args.devices
    resume = args.resume
    worlds: List[Tuple[str, List[Dict[str, Any]]]] = []
    with contextlib.ExitStack() as stack:
        data_dir = args.data_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="hetseq_data_"))
        # every world's ranks read one corpus: write it before they start
        build_synthetic_corpus(
            data_dir, num_seqs=max(4 * plan.global_rows, 256),
            seq_len=args.seq_len + 1, vocab=cfg.vocab_size,
            rows_per_shard=64, seed=tcfg.seed)
        while True:
            ranks = _run_world(args, tcfg, devices, plan, engine, resume,
                               data_dir)
            worlds.append((devices, ranks))
            if any(len(set(g)) != 1 for g in stage_groups(
                    ranks[0]["end_checksums"], ranks[0]["pipe_size"])):
                raise RuntimeError(f"ranks end with different parameters: "
                                   f"checksums {ranks[0]['end_checksums']}")
            rec = ranks[0]["remesh"]
            if rec is None:
                break
            # read once every rank has returned: rank 0 joined its writer
            latest = (CheckpointManager(tcfg.ckpt_dir).latest_step()
                      if os.path.isdir(tcfg.ckpt_dir) else None)
            for r in ranks:
                r["remesh"]["checkpoint"] = latest
            decision, alive = _remesh(rec, topo, tcfg, latest)
            topo, plan = decision.topology, decision.plan
            # capacities were indexed by the old rank numbering, and the
            # plan from plan_remesh is the new one; accum_steps scales
            # with the lost width to keep the microbatch count
            tcfg = dataclasses.replace(tcfg, het=dataclasses.replace(
                tcfg.het, capacities=(),
                accum_steps=tcfg.het.accum_steps * decision.accum_scale))
            if decision.accum_scale > 1:
                print(f"[train] accum_steps scaled x{decision.accum_scale}"
                      f" to preserve the microbatch grid")
            _check_microbatches(tcfg, plan)
            # the writer's fault-hook attempts (rank 0's, which may be
            # another process) go on into the next world's engine
            engine.ckpt_attempts.update(ranks[0]["ckpt_attempts"])
            engine = engine.after_remesh(alive)
            devices = mesh_mod.devices_for_topology(topo)
            shape, axes = mesh_shape(args, devices)
            print(f"[train] re-meshed to {dict(zip(axes, shape))}: "
                  f"{int(np.prod(shape))} rank(s) restart from the "
                  f"checkpoint at step {rec['checkpoint']} (lost at step "
                  f"{rec['step']})")
            resume = True
    return _report(args, worlds, dev, splan)


def _report(args, worlds, dev, splan=None) -> Dict[str, Any]:
    """The run's record from its worlds: the steps that count (a world's
    restore drops what the one before trained past its checkpoint), the
    last world's ranks, and one ``[train] summary`` JSON line."""
    by_step: Dict[int, Tuple[float, Dict, float]] = {}
    for _, ranks in worlds:
        r0 = ranks[0]
        for k in [k for k in by_step if k > r0["start_step"]]:
            del by_step[k]
        for i, item in enumerate(zip(r0["losses"], r0["metrics"],
                                     r0["step_s"])):
            by_step[r0["start_step"] + 1 + i] = item
    kept = [by_step[k] for k in sorted(by_step)]
    last = worlds[-1][1]
    out = dict(last[0])
    out.update(losses=[k[0] for k in kept], metrics=[k[1] for k in kept],
               step_s=[k[2] for k in kept],
               wall_s=sum(ranks[0]["wall_s"] for _, ranks in worlds),
               plan=last[0]["plan"],
               ranks=[{k: v for k, v in r.items() if k != "state"}
                      for r in last],
               worlds=[{"devices": d, "ranks": [
                   {k: v for k, v in r.items() if k != "state"}
                   for r in ranks]} for d, ranks in worlds])
    first = worlds[0][1][0]["start_step"]
    summary = {"steps": out["steps"], "start_step": first,
               "losses": out["losses"], "end_checksums": out["end_checksums"],
               "model_checksum": out["model_checksum"],
               "stage_plan": (splan.layers_per_stage.tolist()
                              if splan is not None else None),
               "schedule": args.pipeline_schedule if splan is not None
               else None,
               "ckpt_attempts": sorted([*k, n] for k, n in
                                       out["ckpt_attempts"].items()),
               **({"trust_ratio": [m["trust_ratio"] for m in out["metrics"]]}
                  if out["metrics"] and "trust_ratio" in out["metrics"][0]
                  else {}),
               "worlds": [{"devices": w["devices"], "ranks": [
                   {k: r[k] for k in ("rank", "start_step", "steps",
                                      "losses", "step_s", "launches",
                                      "during_save", "replans", "remesh",
                                      "saves", "writes", "restore",
                                      "end_checksums", "peak_memory_bytes",
                                      "stage", "pipe_bytes",
                                      "pipe_bytes_modeled", "plan")}
                   for r in w["ranks"]]} for w in out["worlds"]]}
    if not out["losses"]:
        print(f"[train] nothing to do: checkpoint already at step "
              f"{out['steps']} >= --steps {args.steps}")
    else:
        out["first_loss"], out["last_loss"] = out["losses"][0], \
            out["losses"][-1]
        print(f"[train] done: {out['steps'] - first} steps in "
              f"{out['wall_s']:.1f}s, loss {out['first_loss']:.4f} -> "
              f"{out['last_loss']:.4f}; {len(last)} rank(s), backend "
              f"{out['backend']}, transport {out['transport']}; parameters "
              + ("identical on every rank" if out["pipe_size"] == 1 else
                 f"identical on every rank of each of the "
                 f"{out['pipe_size']} stages"))
    for w in out["worlds"]:
        for rec in w["ranks"][0]["writes"]:
            print(f"[ckpt] step {rec['step']} written: {rec['bytes']} bytes "
                  f"in {rec['seconds']:.2f} s (write and fsync "
                  f"{rec['write_s']:.2f} s, sha256 {rec['sha256_s']:.2f} s, "
                  f"attempt {rec['attempts']})")
    if dev.type == "cuda":
        print("[train] peak memory per rank (GiB): " + ", ".join(
            f"{r['peak_memory_bytes'] / 2**30:.2f}" for r in last))
    print("[train] summary " + json.dumps(summary), flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu when asked for)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--devices", default="1,1",
                    help="mesh shape data,model or pod,data,model (model "
                         "must be 1): one process per data-parallel rank")
    ap.add_argument("--capacities", default="",
                    help="per-DP-rank relative capacities")
    ap.add_argument("--weighting", default="tokens",
                    choices=list(cfgbase.WEIGHTING_MODES))
    ap.add_argument("--grad-reduction", default="allreduce",
                    choices=list(cfgbase.GRAD_REDUCTION_MODES))
    ap.add_argument("--compression", default="none",
                    choices=list(cfgbase.COMPRESSION_MODES))
    ap.add_argument("--bucket-mb", type=float, default=0.0)
    ap.add_argument("--overlap", default="none",
                    choices=list(cfgbase.OVERLAP_MODES))
    ap.add_argument("--no-scan-layers", action="store_true",
                    help="unrolled layer stack (ModelConfig.scan_layers="
                         "False), which --overlap backward requires")
    ap.add_argument("--pipeline-stages", type=int, default=1)
    ap.add_argument("--pipeline-schedule", default="1f1b",
                    choices=list(cfgbase.PIPELINE_MODES))
    ap.add_argument("--pipe-axis", action="store_true",
                    help="each pipeline stage on its own ranks: a leading "
                         "pipe axis of --pipeline-stages on --devices")
    ap.add_argument("--dry-run", action="store_true",
                    help="check the configuration, print the summary and "
                         "exit without training")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "lamb"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--schedule", default="inverse_sqrt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--replan-interval", type=int, default=100,
                    help="steps between straggler capacity replans")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="write a checkpoint every N steps and at the end "
                         "(0: none)")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--data-dir", default="",
                    help="where the synthetic corpus is written (default: "
                         "a temporary directory, removed at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--ckpt-dir that verifies (a fresh start if there "
                         "is none)")
    ap.add_argument("--chaos", default="",
                    help="fault injection: a schedule.json path or a "
                         f"preset ({', '.join(sorted(chaos.PRESETS))})")
    ap.add_argument("--kill-pod", default="",
                    help="'P@S': pod P stops reporting from step S (a "
                         "one-entry --chaos kill schedule; two pods or "
                         "more)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    return train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
