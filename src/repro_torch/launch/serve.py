"""Continuous-batching serving driver (port of ``repro/launch/serve.py``).

Requests arrive open-loop, are routed across pods by capacity score
(slow pods hold proportionally fewer concurrent sequences), prefilled
in length buckets into a paged KV cache, and decoded one token per step
at per-sequence depths. Runs on one device: ``--device`` defaults to
``cuda`` and the CPU runs only when asked for. ``--devices`` takes only
a one-device mesh in this port so far.

The JAX driver's jitted step builders
(``launch/steps.py::build_paged_{prefill,decode}_step``) become the two
plain closures in :func:`build_engine`: without jit or shardings they
need no module of their own.

:func:`serve` resolves the config from the command line and hands it
to :func:`serve_config`, which runs the engine on any config, such as
one cut in depth (deepseek-v2-236b's 60 layers do not fit one card;
``chip_smoke.py`` serves it at full width with 8 layers). Before it
allocates, ``serve_config`` raises ``ValueError`` when the weights need
more bytes than the card has, and, as the JAX driver does, when the
config's stack is not the uniform plan the paged cache takes (zamba2).

:func:`static_generate` is the static-batch path (one shared prompt
length, every sequence decodes in lock-step over a contiguous cache):
the baseline the paged path is held to, and the path that serves the
Mamba2 hybrid (zamba2). Like the JAX package it has no command-line
flag; call it from Python:

  model = build_model(resolve("zamba2-2.7b"))        # on the card
  params = cast_params(model.init_params(0), torch.bfloat16)
  tokens = static_generate(model, params, prompts, gen=64)

Example (H100):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --slots 8 --requests 16 --pod-speeds 1,0.5
Example (CPU, smoke configs):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --slots 4 --requests 12 --pod-speeds 1,0.5
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tr
from repro_torch.models.blocks import dtype_of
from repro_torch.models.kvcache import PagedLayout
from repro_torch.models.model import Model, build_model
from repro_torch.serve import (CapacityRouter, EngineConfig, Request,
                               Scheduler, ServeEngine)


def build_engine(model: Model, params, layout: PagedLayout,
                 slots: int, prefill_batch: int,
                 pod_speeds: Sequence[float],
                 bucket_lens: Optional[Sequence[int]] = None
                 ) -> ServeEngine:
    """Wire the scheduler and the paged steps into a ServeEngine on the
    model's device. ``params`` are used as given (pass a copy in the
    compute dtype to spare every step the weight casts)."""
    router = CapacityRouter(slots, pod_speeds)
    sched = Scheduler(layout, router, slots, bucket_lens)

    def decode(tokens, cache, tables, kv_lens):
        return model.decode_paged(params, tokens, cache, tables, kv_lens)

    def prefill(prompts, lens, cache, tables):
        return model.prefill_paged(params, prompts, lens, cache, tables)

    return ServeEngine(EngineConfig(decode_slots=slots,
                                    prefill_batch=prefill_batch,
                                    attention_impl=model.cfg.attention_impl),
                       layout, sched, decode,
                       {b: prefill for b in sched.bucket_lens},
                       lambda: model.init_paged_cache(layout),
                       model.device)


def synthetic_requests(n: int, vocab: int, rate: float,
                       prompt_lens: Tuple[int, int],
                       gen_lens: Tuple[int, int], seed: int
                       ) -> List[Request]:
    """Open-loop Poisson arrivals with mixed prompt/gen lengths (the same
    numpy draws as the JAX driver, so one seed gives one trace)."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        glen = int(rng.integers(gen_lens[0], gen_lens[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, plen))
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=glen, arrival=t))
    return reqs


def static_generate(model: Model, params, prompts: np.ndarray,
                    gen: int) -> np.ndarray:
    """Static-batch reference path (the pre-engine serving loop): one
    shared prompt length, every sequence decodes ``gen`` tokens in
    lock-step, greedy, over a contiguous cache of ``prompt + gen``
    positions. ``prompts`` (B, S) token ids. Returns (B, gen) generated
    token ids."""
    batch, prompt_len = prompts.shape
    shape = cfgbase.ShapeConfig("serve-static", prompt_len + gen, batch,
                                "decode")
    prefill = steps_mod.build_prefill_step(model, shape)
    decode = steps_mod.build_decode_step(model, shape)
    logits, cache = prefill(params, torch.as_tensor(
        np.asarray(prompts), dtype=torch.int32, device=model.device))
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(params, tok, cache, prompt_len + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of the weights serving holds: the parameters in their dtype,
    plus the serving copy in the compute dtype where the two differ."""
    n = cfg.param_count()
    pdt, cdt = dtype_of(cfg.param_dtype), dtype_of(cfg.compute_dtype)
    return n * (pdt.itemsize + (cdt.itemsize if cdt != pdt else 0))


def check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise ``ValueError`` when the weights alone need more bytes than
    the card has (before anything is allocated)."""
    if device.type != "cuda":
        return
    need = weight_bytes(cfg)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name} with {cfg.num_layers} layers: the weights need "
            f"{need} bytes ({need / 2**30:.1f} GiB) and the card has "
            f"{have} bytes ({have / 2**30:.1f} GiB); serve fewer layers "
            f"(serve_config with dataclasses.replace(cfg, num_layers=...))")


def serve(args):
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    if cfg.frontend != "token":
        # as the JAX driver: the engine's requests are token ids
        # (chameleon and musicgen run through Model.prefill/decode)
        raise SystemExit(f"--arch {args.arch}: the serving engine "
                         f"requires a token frontend")
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    return serve_config(cfg, args)


def serve_config(cfg: ModelConfig, args):
    """Serve ``cfg`` (its ``attention_impl`` as given) with the settings
    of ``args`` (``parser()``'s namespace; ``--arch``, ``--smoke`` and
    ``--attention-impl`` are not read here)."""
    dshape = tuple(int(x) for x in args.devices.split(","))
    if int(np.prod(dshape)) != 1:
        raise SystemExit(f"--devices {args.devices}: repro_torch serves on "
                         f"one device so far (mesh of size 1)")
    tr.check_paged(cfg)
    model = build_model(cfg, args.device)
    check_fits(cfg, model.device)
    dp = int(np.prod(dshape[:-1]))
    pod_speeds = ([float(s) for s in args.pod_speeds.split(",")]
                  if args.pod_speeds else [1.0] * dp)
    mbs = -(-(args.max_prompt + args.max_gen) // args.block_size)
    layout = PagedLayout(block_size=args.block_size,
                         num_blocks=args.num_blocks or args.slots * mbs,
                         max_blocks_per_seq=mbs)
    # serving copy in the compute dtype; the param-dtype draw is dropped
    params = tr.cast_params(model.init_params(args.seed),
                            dtype_of(cfg.compute_dtype))
    reqs = synthetic_requests(
        args.requests, cfg.vocab_size, args.rate,
        (args.min_prompt, args.max_prompt), (args.min_gen, args.max_gen),
        args.seed)
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    engine = build_engine(model, params, layout, args.slots,
                          args.prefill_batch, pod_speeds)
    result = engine.run(reqs)

    s = result.stats
    print(f"[serve] {cfg.name} on {s['device']}: {s['requests']} requests, "
          f"{s['total_tokens']} tokens, pods {pod_speeds} "
          f"limits {s['pod_limits']}")
    print(f"[serve] modeled {s['modeled_tokens_per_sec']:.2f} tok/unit "
          f"(p50 {s['p50_time_per_token']:.3f} / "
          f"p99 {s['p99_time_per_token']:.3f} per token, "
          f"ttft {s['mean_ttft']:.3f})")
    print(f"[serve] {s['decode_steps']} decode steps, "
          f"{s['prefill_groups']} prefill groups, "
          f"{s['preemptions']} preemptions, block util "
          f"mean {s['block_util_mean']:.2f} peak {s['block_util_peak']:.2f},"
          f" wall {s['wall_seconds']:.3f}s "
          f"({s['total_tokens'] / max(s['wall_seconds'], 1e-9):.1f} tok/s)")
    print(f"[serve] attention_impl={s['attention_impl']} kernel launches "
          f"{s['kernel_launches']}")
    if model.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(model.device) / 2**30
        print(f"[serve] peak device memory {peak:.3f} GiB")
    rid0 = min(result.tokens)
    print(f"[serve] sample tokens[{rid0}]: {result.tokens[rid0][:12]}")
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--devices", default="1,1",
                    help="mesh shape; only a one-device mesh so far")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu when asked for)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (concurrent sequences)")
    ap.add_argument("--prefill-batch", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size (0 = slots x max blocks/seq)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="open-loop arrival rate (requests per unit)")
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--min-gen", type=int, default=4)
    ap.add_argument("--max-gen", type=int, default=32)
    ap.add_argument("--pod-speeds", default="",
                    help="comma list of modeled pod speeds "
                         "(default: 1.0 per DP rank)")
    ap.add_argument("--attention-impl", default="kernel",
                    choices=list(cfgbase.ATTENTION_IMPLS),
                    help="'kernel' runs the hand-written CUDA kernels on "
                         "CUDA tensors (their plain versions on CPU "
                         "tensors): prefill flash attention, and the GQA "
                         "paged decode or, for MLA (deepseek-v2), the "
                         "absorbed-MLA paged decode (csrc/mla_decode.cu); "
                         "'reference' materializes the window")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    return serve(parser().parse_args(argv))


if __name__ == "__main__":
    main()
