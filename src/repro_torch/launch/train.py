"""Heterogeneous data-parallel training driver
(port of ``repro/launch/train.py``).

Wires: synthetic corpus -> sharded dataset -> capacity plan -> het
sampler + prefetch loader -> train step (weighted objective sum and
weight sum, reduced over the ranks, divided once; clip; AdamW) -> log.
The plan's headroom leaves weight-0 dummy rows in every batch, and they
run forward and backward on the device like real rows (the paper's
dummy-batch path); a rank of capacity 0 runs only dummy rows.

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
versions on the CPU. Checkpointing (``--ckpt-every``, ``--resume``,
``--ckpt-dir``), fault injection (``--chaos``, ``--kill-pod``),
``--dry-run``, the straggler replans (``--replan-interval``) and
``--no-scan-layers`` are not ported yet: each raises when set away from
its default. The driver writes no checkpoint. The synthetic corpus goes
to ``--data-dir``, or to a temporary directory (under ``$TMPDIR``) that
is removed at the end.

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
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import (HetConfig, ModelConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import capacity as cap
from repro_torch.data.dataset import ShardedDataset
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.sampler import HetSampler
from repro_torch.data.synthetic import build_synthetic_corpus
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import build_model


def _check_flags(args) -> None:
    """Flags this port would accept and then ignore raise instead."""
    defaults = parser().parse_args([])
    unported = [flag for flag, on in (
        ("--ckpt-every", args.ckpt_every > 0), ("--resume", args.resume),
        ("--ckpt-dir", args.ckpt_dir != defaults.ckpt_dir),
        ("--chaos", bool(args.chaos)), ("--kill-pod", bool(args.kill_pod)),
        ("--dry-run", args.dry_run),
        ("--no-scan-layers", args.no_scan_layers),
        ("--replan-interval",
         args.replan_interval != defaults.replan_interval)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported yet (checkpoints, fault "
            f"injection, elastic restart and straggler replans come with "
            f"later slices; the layer stack is always a Python loop)")


def build_config(args) -> Tuple[ModelConfig, TrainConfig]:
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
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
        qz.quantize_int8_cuda, qz.dequant_accum_cuda)}


def _sent(mesh: mesh_mod.ProcessMesh) -> int:
    return sum(c.sent_bytes for c in {id(c): c for c in (
        mesh.world, mesh.pod, mesh.data)}.values())


def _checksums(mesh: mesh_mod.ProcessMesh, params) -> List[int]:
    """Every rank's parameter checksum, gathered over the world."""
    mine = torch.tensor([steps_mod.params_checksum(params)],
                        dtype=torch.int64, device=mesh.device)
    return [int(x) for x in mesh.world.all_gather(mine).reshape(-1)]


def run_rank(args, mesh: mesh_mod.ProcessMesh, data_dir: str,
             plan: cap.CapacityPlan) -> Dict[str, Any]:
    """One rank's training loop; the whole run on one rank."""
    cfg, tcfg = build_config(args)
    model = build_model(cfg, mesh.device)
    lead = mesh.rank == 0
    step_fn = steps_mod.build_train_step(model, tcfg, mesh)
    corpus = build_synthetic_corpus(
        data_dir, num_seqs=max(4 * plan.global_rows, 256),
        seq_len=args.seq_len + 1, vocab=cfg.vocab_size, rows_per_shard=64,
        seed=tcfg.seed)
    sampler = HetSampler(ShardedDataset(corpus), plan, seed=tcfg.seed)
    loader = PrefetchLoader(sampler, depth=args.prefetch)
    state = steps_mod.init_train_state(model, tcfg, mesh=mesh)
    start_sums = _checksums(mesh, state.params)
    if len(set(start_sums)) != 1:
        raise RuntimeError(f"ranks start from different parameters: "
                           f"checksums {start_sums}")
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    launches0 = _launch_counts()
    step, epoch = 0, 0
    losses, step_s, records, link = [], [], [], []
    t_start = time.time()
    while step < args.steps:
        for raw in loader.iter_epoch(epoch):
            if step >= args.steps:
                break
            batch = _rank_rows(raw, args.seq_len, mesh.rank,
                               plan.buffer_rows, model.device)
            t0 = time.time()
            sent0 = _sent(mesh)
            state, metrics = step_fn(state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0          # float() synchronized
            step += 1
            losses.append(rec["loss"])
            step_s.append(dt)
            records.append(rec)
            link.append(_sent(mesh) - sent0)
            if lead and (step % args.log_every == 0 or step == args.steps):
                print(f"[train] step {step:5d} loss {rec['loss']:.4f} "
                      f"grad_norm {rec['grad_norm']:.4f} weight "
                      f"{rec['weight']:.0f} lr {rec['lr']:.3g} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
        epoch += 1
    wall = time.time() - t_start
    launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    end_sums = _checksums(mesh, state.params)
    peak = (torch.cuda.max_memory_allocated(model.device)
            if model.device.type == "cuda" else None)
    return {"rank": mesh.rank, "steps": step, "wall_s": wall,
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "step_s": step_s, "metrics": records,
            "link_bytes": link, "launches": launches,
            "start_checksums": start_sums, "end_checksums": end_sums,
            "peak_memory_bytes": peak, "backend": mesh.backend,
            "transport": mesh.transport, "device": str(model.device),
            "state": state}


def _rank_main(rank: int, world: int, init_method: str, args,
               data_dir: str, plan: cap.CapacityPlan) -> Dict[str, Any]:
    mesh_mod.share_cpu(world)
    shape, axes = mesh_mod.parse_devices(args.devices)
    mesh = mesh_mod.init(shape, axes, rank, init_method,
                         torch.device(args.device).type)
    try:
        if rank == 0:
            print(f"[train] rank 0 of {world}: {mesh.describe()}",
                  flush=True)
        out = run_rank(args, mesh, data_dir, plan)
    finally:
        mesh_mod.destroy(mesh)
    del out["state"]                    # stays in the rank's process
    return out


def train(args) -> Dict[str, object]:
    _check_flags(args)
    shape, axes = mesh_mod.parse_devices(args.devices)
    sizes = dict(zip(axes, shape))
    n_dp = sizes.get("pod", 1) * sizes.get("data", 1)
    cfg, tcfg = build_config(args)
    plan = make_plan(tcfg, n_dp)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but CUDA is "
                           f"not available; pass --device cpu to run on "
                           f"the CPU")
    print(f"[train] {cfg.name}: {cfg.param_count():,} params on "
          f"{args.device}, {n_dp} rank(s) (mesh {sizes}), plan rows "
          f"{plan.rows_per_rank.tolist()} buffer {plan.buffer_rows} "
          f"(efficiency {plan.efficiency():.2f}), reduction "
          f"{args.grad_reduction} compression {args.compression} "
          f"bucket_mb {args.bucket_mb}; attention, cross entropy and the "
          f"int8 exchange through the kernels")
    print("[train] no checkpoints are written (not ported yet); no "
          "straggler replans")
    with contextlib.ExitStack() as stack:
        data_dir = args.data_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="hetseq_data_"))
        if n_dp == 1:
            mesh = mesh_mod.local(shape, axes, dev)
            print(f"[train] {mesh.describe()}")
            ranks = [run_rank(args, mesh, data_dir, plan)]
        else:
            if dev.type == "cuda":
                # every rank loads the library; build it once, here
                from repro_torch.kernels import _build
                _build.build()
            # the ranks read one corpus: write it before they start
            build_synthetic_corpus(
                data_dir, num_seqs=max(4 * plan.global_rows, 256),
                seq_len=args.seq_len + 1, vocab=cfg.vocab_size,
                rows_per_shard=64, seed=tcfg.seed)
            ranks = mesh_mod.spawn(_rank_main, n_dp,
                                   (args, data_dir, plan))
    out = dict(ranks[0])
    if len(set(out["end_checksums"])) != 1:
        raise RuntimeError(f"ranks end with different parameters: "
                           f"checksums {out['end_checksums']}")
    print(f"[train] done: {out['steps']} steps in {out['wall_s']:.1f}s, "
          f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}; "
          f"{n_dp} rank(s), backend {out['backend']}, transport "
          f"{out['transport']}; parameters identical on every rank")
    if dev.type == "cuda":
        print("[train] peak memory per rank (GiB): " + ", ".join(
            f"{r['peak_memory_bytes'] / 2**30:.2f}" for r in ranks))
    out["plan"] = cap.plan_record(plan)
    out["ranks"] = [{k: v for k, v in r.items() if k != "state"}
                    for r in ranks]
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
                    help="not ported yet: the port's layer stack is always "
                         "a Python loop")
    ap.add_argument("--pipeline-stages", type=int, default=1)
    ap.add_argument("--pipeline-schedule", default="1f1b",
                    choices=list(cfgbase.PIPELINE_MODES))
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "lamb"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--schedule", default="inverse_sqrt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--replan-interval", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/hetseq_ckpt",
                    help="not ported yet: no checkpoint is written")
    ap.add_argument("--data-dir", default="",
                    help="where the synthetic corpus is written (default: "
                         "a temporary directory, removed at the end)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--chaos", default="")
    ap.add_argument("--kill-pod", default="")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    return train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
