"""Single-device heterogeneous training driver
(port of ``repro/launch/train.py``).

Wires: synthetic corpus -> sharded dataset -> capacity plan -> het
sampler + prefetch loader -> train step (weighted objective sum and
weight sum, divided once; clip; AdamW) -> log. The plan's headroom
leaves weight-0 dummy rows in every batch, and they run forward and
backward on the device like real rows (the paper's dummy-batch path).

Runs on one device: ``--device`` defaults to ``cuda`` and the CPU runs
only when asked for; ``--devices`` takes only a one-device mesh.
Attention and cross entropy go through the kernels (``attention_impl=
"kernel"``, ``ce_impl="kernel"``): the CUDA kernels on the card, their
plain versions on the CPU.
Checkpointing (``--ckpt-every``, ``--resume``, ``--ckpt-dir``), fault
injection (``--chaos``, ``--kill-pod``), ``--dry-run``, bucketed
reduction (``--bucket-mb``), the straggler replans
(``--replan-interval``) and ``--no-scan-layers`` are not ported yet:
each raises when set away from its default. The driver writes no
checkpoint. The synthetic
corpus goes to ``--data-dir``, or to a temporary directory (under
``$TMPDIR``) that is removed at the end.

Example (H100):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 6 --global-batch 8 --seq-len 1024 --accum 2 --lr 3e-4 \
      --warmup 2 --schedule constant
Example (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --steps 10 --global-batch 8 --seq-len 32
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

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
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import Model, build_model


def build_everything(args) -> Tuple[ModelConfig, Model, TrainConfig]:
    dshape = tuple(int(x) for x in args.devices.split(","))
    if int(np.prod(dshape)) != 1:
        raise SystemExit(f"--devices {args.devices}: repro_torch trains on "
                         f"one device so far (mesh of size 1)")
    # flags this port would accept and then ignore raise instead
    defaults = parser().parse_args([])
    unported = [flag for flag, on in (
        ("--ckpt-every", args.ckpt_every > 0), ("--resume", args.resume),
        ("--ckpt-dir", args.ckpt_dir != defaults.ckpt_dir),
        ("--chaos", bool(args.chaos)), ("--kill-pod", bool(args.kill_pod)),
        ("--dry-run", args.dry_run),
        ("--no-scan-layers", args.no_scan_layers),
        ("--bucket-mb", args.bucket_mb != defaults.bucket_mb),
        ("--replan-interval",
         args.replan_interval != defaults.replan_interval)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported yet (checkpoints, fault "
            f"injection, elastic restart, bucketed reduction and straggler "
            f"replans come with later slices; the layer stack is always a "
            f"Python loop)")
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    cfg = dataclasses.replace(cfg, attention_impl="kernel")
    model = build_model(cfg, args.device)
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
    return cfg, model, tcfg


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


def _to_device(raw: Dict[str, np.ndarray], seq_len: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    # the sampler pads the *labels*: inputs are the shifted view
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k][:, :seq_len]))
            .to(device) for k in ("inputs", "labels", "weights")}


def train(args) -> Dict[str, object]:
    cfg, model, tcfg = build_everything(args)
    plan = make_plan(tcfg)
    print(f"[train] {cfg.name}: {cfg.param_count():,} params on "
          f"{model.device}, plan rows {plan.rows_per_rank.tolist()} buffer "
          f"{plan.buffer_rows} (efficiency {plan.efficiency():.2f}); "
          f"attention and cross entropy through the kernels")
    print("[train] no checkpoints are written (not ported yet); one "
          "device, so no straggler replans")
    step_fn = steps_mod.build_train_step(model, tcfg)

    with contextlib.ExitStack() as stack:
        data_dir = args.data_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="hetseq_data_"))
        corpus = build_synthetic_corpus(
            data_dir, num_seqs=max(4 * plan.global_rows, 256),
            seq_len=args.seq_len + 1, vocab=cfg.vocab_size,
            rows_per_shard=64, seed=tcfg.seed)
        sampler = HetSampler(ShardedDataset(corpus), plan, seed=tcfg.seed)
        loader = PrefetchLoader(sampler, depth=args.prefetch)
        state = steps_mod.init_train_state(model, tcfg)
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(model.device)

        step, epoch = 0, 0
        losses, step_s, records = [], [], []
        t_start = time.time()
        while step < args.steps:
            for raw in loader.iter_epoch(epoch):
                if step >= args.steps:
                    break
                batch = _to_device(raw, args.seq_len, model.device)
                t0 = time.time()
                state, metrics = step_fn(state, batch)
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0          # float() synchronized
                step += 1
                losses.append(rec["loss"])
                step_s.append(dt)
                records.append(rec)
                if step % args.log_every == 0 or step == args.steps:
                    print(f"[train] step {step:5d} loss {rec['loss']:.4f} "
                          f"grad_norm {rec['grad_norm']:.4f} weight "
                          f"{rec['weight']:.0f} lr {rec['lr']:.3g} "
                          f"({dt * 1e3:.0f} ms)", flush=True)
            epoch += 1
    wall = time.time() - t_start
    print(f"[train] done: {step} steps in {wall:.1f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"steps": step, "wall_s": wall, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses, "step_s": step_s,
            "metrics": records, "plan": cap.plan_record(plan),
            "state": state}


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
                    help="mesh shape; only a one-device mesh so far")
    ap.add_argument("--capacities", default="",
                    help="per-DP-rank relative capacities (one rank here)")
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
