#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an error):

1. Prints the card's name and power limit (nvidia-smi), builds every
   CUDA kernel from ``src/repro_torch/csrc`` with nvcc (one nvcc per
   source, all started together) and prints the build time. Then the
   bf16 tensor-core kernels (the prefill forward at head dims 64, 80,
   128 and 192, the backward's dq and dk/dv passes at 64 and 128, the
   CE forward for both head layouts, the MLA decode's split kernel for
   the paged and the contiguous cache, the SSD scan's chunk-state and
   chunk-scan kernels, and their
   helpers: the CE and MLA merges, the SSD state passing): ptxas's
   registers and spills, the dynamic shared memory of each launch, and
   the count of ``wgmma.mma_async`` and ``cp.async`` in their PTX
   (``nvcc -ptx``) and of HGMMA in their SASS (cuobjdump, where the
   toolkit has it); every product kernel must have both instructions
   and no spill. The tiles the library reports (forward kv tiles, the
   backward's four tiles, the CE tiles, the decode's split length, the
   MLA decode's split, tile and partial length, the SSD scan's row
   tile) must be those the CPU models of the tests follow.
2. Serving kernel phase: the prefill and paged-decode kernels against
   their plain PyTorch versions on the card, in fp32 (tolerance 1e-4)
   and bf16 (tolerance 2e-2), at tinyllama-1.1b widths (H=32, Hkv=4,
   D=64). Prefill at buckets 16, 128 and 512 with B=2, plus Sq=Skv=200
   (not a tile multiple); paged decode with B=8, bs=16, ragged kv_lens
   up to 512, NULL holes, one all-NULL inactive slot and one sequence at
   exactly MB*bs; and a longer window (B=8, MB=128, kv_lens up to
   2048). TF32 is off for every fp32 comparison. Each prefill and
   decode case runs twice and must give bitwise-equal outputs. Times
   are CUDA-event medians of 20 runs after warm-up (the decode at both
   windows), and for the decode also the device time of a call (its
   kernels' time under torch.profiler over 20 calls: the call is
   host-bound), SDPA's likewise; ``library_ms`` is
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   dense inputs, a yardstick the port never calls.
3. Training kernel phase: the prefill forward with its lse and the
   attention backward at olmo-1b heads (H=Hkv=16, D=128) and tinyllama's
   (H=32, Hkv=4, D=64), B=2, S in {512, 1024, 200}; the fused
   cross-entropy forward at T=4096, D=2048, V=50304 with zero weights,
   eps in {0, 0.1}, the head as a (D, V) matrix and as a tied (V, D)
   table; the dlogits pass on a (4096, 50304) tile. Each output is
   held against the plain version's by its relative L2 error, with the
   limits of ``repro_torch.kernels.parity.RTOL`` (per kernel and dtype,
   about 10x the errors read on an H100); every case is printed before
   any is checked. The attention forward and backward and the CE
   forward each run twice and must give bitwise-equal outputs. Each
   kernel is timed at the shape the train phase gives it (B=5 rows of
   1024 tokens a microbatch, T=5120, a 4096-row dlogits chunk); the
   backward and its yardstick also by device time under torch.profiler
   (the kernels' time over 20 calls). Yardsticks: the
   autograd backward of SDPA(is_causal=True);
   ``F.linear`` then ``F.cross_entropy(reduction="none")``, two calls
   (no single PyTorch call fuses the head with the loss); none for the
   dlogits pass (no PyTorch call computes it).
4. Serve path phase: ``repro_torch.launch.serve`` serves tinyllama-1.1b
   at full width (random weights from seed 0, bf16 compute,
   attention_impl="kernel"): 8 slots, prefill batch 2, 16 requests,
   prompts 64-448, generations 16-64, pod speeds 1,0.5. The launch
   counters are zeroed just before and read just after; the run must
   finish every request, launch the prefill kernel once per layer per
   prefill group and the decode kernel once per layer per decode step.
   On the first prefill group and the first decode step the kernel
   path's logits are held against the "reference" path's on the same
   inputs and a copy of the same cache (bf16 tolerance below).
5. Train path phase: ``repro_torch.launch.train`` trains olmo-1b at full
   width (16 layers, d 2048, head dim 128, vocab 50304; random init from
   seed 0, bf16 compute, remat full, attention and cross entropy through
   the kernels) for 6 steps of 8 rows x 1024 tokens, accum 2, on the
   synthetic corpus; the capacity plan's headroom adds 2 weight-0 dummy
   rows to every batch. The counters are zeroed just before and read
   just after. Checks: every loss finite and the last below the first;
   per step, the forward kernel launched twice per layer per microbatch
   (once more under remat), the backward once, the CE forward once per
   microbatch and the dlogits pass once per 4096-token chunk; on the
   first batch, the loss, the grad norm and every gradient leaf (by its
   relative L2 error) agree with the reference path's; the
   HetSeq invariant on the card (the first batch's real rows packed for
   capacities 2,1,1,0 give the single-batch gradient, fp32); a repeated
   step from one state and batch gives bit-identical parameters. One
   more step runs under torch.profiler (device time by kernel), after
   the counters are read.
6. Exchange kernel phase: the int8 quantize and dequant-accumulate
   kernels (``csrc/quantize.cu``) against their plain versions, which
   must be bitwise equal (codes, scales, sums): 1, 7, 1001 and 4099
   rows (a partial last block of eight rows), all-zero blocks,
   stochastic rounding with noise from a seeded generator, 1 to 8
   ranks, and the whole olmo-1b gradient stack at bucket_mb 25 over 2
   ranks (4.6 M rows; 2 x 2.3 M for the accumulate). Timed (CUDA-event
   medians) at the multi-rank path's per-launch shapes, one exchange
   chunk of 40 buckets: the send-side quantize of 1,024,000 rows, the
   re-quantize and the accumulate of a shard of 512,000 rows. Bound by
   bytes at 3.35 TB/s. No single PyTorch call computes either function
   (library: none); ``q.float()`` + ``einsum`` is timed for
   information.
7. Multi-rank train path phase: ``repro_torch.launch.train --devices
   2,1,1 --grad-reduction hierarchical --compression int8 --bucket-mb
   25 --capacities 2,1`` trains full-width olmo-1b (bf16 compute) on two
   ranks that share the card (gloo), 4 steps of 8 rows x 1024 tokens,
   accum 2. The ranks start from fresh counters and report them back.
   Checks: every loss finite; both ranks end with bitwise-identical
   parameters (a checksum gathered over the group); per rank, launches
   of every kernel as expected (quantize twice and dequant-accumulate
   once per exchange chunk per step); the wire bytes per step per rank
   equal ``modeled_link_bytes``. Then the HetSeq invariant across two
   ranks at full width, depth cut to 2 layers, fp32: the two-rank
   reduced gradient (fp32 and int8 exchange) against one process's on
   the union of the real rows. Prints ms per step, real tokens/s, the
   peak memory of each rank, the backend and the transport.
8. MLA kernel phase: the absorbed-MLA decode kernels
   (``csrc/mla_decode.cu``) against their plain versions
   (``ref.mla_decode_online_plain`` and its paged twin, which follow the
   Pallas kernels step by step, p cast to the cache dtype) at
   deepseek-v2 widths (H=128, r=512, Dr=64), fp32 (tolerance 1e-4, TF32
   off) and bf16 (2e-2): the paged kernel with phase 2's tables (B=8,
   bs=16, ragged kv_lens up to 512, NULL holes, an all-NULL inactive
   slot whose output must be 0, one sequence at exactly MB*bs) and over
   the longer window (MB=128, kv_lens up to 2048), each run twice and
   bitwise equal; the contiguous kernel at B=8, S in {200, 512, 2048}
   and at the generate shape (B=4, S=1088, every kv_len at 1088, and a
   ragged set), each run twice and bitwise equal, the last sequence
   alone (over its own rows) bitwise equal to itself inside a batch of
   8, and in bf16 also within 2e-3 of its split model
   (``mla_decode_split_plain``); the prefill forward at head dim 192
   (B=2, S in {16, 512, 200}, H=Hkv=128, v zero-padded from 128; each
   run twice, bitwise equal). Timed in bf16 at the MLA paths' shapes
   (the paged decode at B=8, also at the longer window; the contiguous
   decode at the generate shape and at B=8, S=512; each with the device
   time of a call (the contiguous one by launch: split and merge) and of
   SDPA's under torch.profiler; the prefill at the 512 bucket).
   Yardsticks: SDPA as MQA over the (gathered) dense window (q = [q_abs
   | q_r], k = [ckv | kr], v = ckv, a boolean length mask) and SDPA
   causal at head dim 192.
9. MLA serve and generate path phase: ``launch.serve.serve_config``
   serves deepseek-v2-236b at full width (d 5120, 128 heads, 160 routed
   top-6 experts and 2 shared, vocab 102400), depth cut to 8 of 60 layers
   (65.6 GB of bf16 weights), random weights from seed 0, bf16 compute,
   attention_impl="kernel", with phase 4's settings. The counters are
   zeroed just before and read just after; every request must finish,
   every step's logits be finite, the D=192 prefill launch once per
   layer per prefill group and the paged MLA kernel once per layer per
   decode step (the GQA kernels never). On the first prefill group and
   the first decode step the reference path runs on the same inputs and
   a copy of the cache; in bf16 the logit difference and the number of
   tokens whose top-6 experts differ are printed for the record (the
   routing flips on near-ties). Three decode steps run under
   torch.profiler (device time by kernel). The engine and its pool are
   freed, and the same weights generate through
   ``launch.serve.static_generate`` (the contiguous MLA cache): 4
   sequences, a 1024-token prompt, 64 greedy tokens. Every counter (all
   eleven kernels) is zeroed just before and read just after: the
   contiguous MLA decode must launch exactly 8 x 63 = 504 times and the
   D=192 prefill 8 times, every other kernel 0; every step's logits
   finite; prints the prefill ms, the median decode-step ms (host clock
   between two syncs), tokens/s of wall and the peak memory; three
   decode steps and a second prefill run under torch.profiler (device
   time by kernel). Then the gate: the same serve at fp32 (TF32 off) on
   2 layers, where the kernel path's logits must be within 1e-3 of the
   reference path's (relative to the largest reference logit); and on
   its weights ``static_generate`` (B=4, prompt 300, 8 tokens) through
   the kernel path and the reference path gives identical greedy tokens
   with every step's logits within 1e-3 of the largest reference logit,
   and one sequence through the paged engine gives the static path's
   tokens. Each model is freed before the next is built.
10. Zamba2 kernel phase: the Mamba2 SSD chunked-scan kernel
   (``csrc/ssd_scan.cu``) against its plain version (``ref.ssd_chunked``)
   in fp32 (TF32 off) and bf16, by the relative L2 error of y and of the
   final state (``parity.RTOL``): zamba2's prefill shape (B=4, S=1024,
   H=80, P=64, N=64, one group, chunk 256, with D), a ragged tail
   (S=1000), S shorter than the chunk (S=100), two group layouts (G=2,
   H=8; G=3, H=6 at chunk 128) and no D; the prefill kernel at head dim
   80 (zamba2's shared attention block: B=4, S=1024, H=Hkv=32; and two
   small cases) likewise; every case of both runs twice and must be
   bitwise equal. Both timed in bf16 at the generate phase's shapes,
   with the bound, the plain version's time and the library's (SDPA
   causal for the attention; none for the scan, which no PyTorch call
   computes), beside the card's name and power limit; the scan also by
   the device time of each of its three launches (chunk states, state
   passing, chunk scan) under torch.profiler.
11. Zamba2 generate path phase: ``launch.serve.static_generate`` on
   zamba2-2.7b at full width and depth (54 Mamba2 layers, d 2560, 80
   SSM heads of 64, state 64, the shared attention and MLP block after
   every 6 layers; random bf16 weights from seed 0,
   attention_impl="kernel"): 4 sequences, a 1024-token prompt, 64
   generated tokens, after every earlier model is freed. Every counter
   is zeroed just before and read just after: the SSD kernel must
   launch exactly 54 times and the D=80 prefill 9 times (one prefill;
   decode runs neither, as in the JAX package), every other kernel 0.
   Every step's logits finite; prints the prefill ms and the median
   decode-step ms (host clock between two syncs), tokens/s of wall and
   the peak memory; three decode steps and a second prefill run under
   torch.profiler (device time by kernel). Then the fp32 gate (TF32
   off) on 6 layers (one group), prompt 300 (a full chunk and a ragged
   tail), 8 tokens: the kernel path and the reference path give
   identical greedy tokens and every step's logits agree within 1e-3
   of the largest reference logit.
12. xLSTM kernel phase: the mLSTM chunked-scan kernel
   (``csrc/mlstm_scan.cu``) against its plain version
   (``ref.mlstm_chunked``) in fp32 (TF32 off) and bf16, by the relative
   L2 error of h, C, n and m, the largest of the four held to
   ``parity.RTOL``; every case is printed before any is checked:
   xlstm-125m's prefill shape (B=4, S=1024, H=4, dk=dv=384, chunk 256),
   a ragged tail (S=1000), S shorter than the chunk (S=100), the Pallas
   wrapper's chunk of 128, and the smoke widths (dk=dv=64). Timed in
   bf16 at the path's shape, with the bound, the plain version's time
   and library none (no PyTorch call computes the scan), beside the
   card's name and power limit.
13. xLSTM generate path phase: ``launch.serve.static_generate`` on
   xlstm-125m at full width and depth (12 layers: 6 mLSTM blocks with 4
   heads of 384 and 6 sLSTM blocks, d 768, vocab 50304; random bf16
   weights from seed 0, attention_impl="kernel"): 4 sequences, a
   1024-token prompt (four chunks), 64 generated tokens, after every
   earlier model is freed. Every counter (all eleven kernels) is zeroed
   just before and read just after: the mLSTM kernel must launch
   exactly 6 times (one prefill; decode is the plain recurrence, as in
   the JAX package), every other kernel 0. Every step's logits finite;
   prints the prefill ms and the median decode-step ms (host clock
   between two syncs), tokens/s of wall and the peak memory; three
   decode steps and a second prefill run under torch.profiler (device
   time by kernel), the prefill with its mLSTM and sLSTM blocks timed
   between syncs. Then the fp32 gate (TF32 off) at full depth, prompt
   300 (a full chunk and a ragged tail), 8 tokens: the kernel path and
   the reference path give identical greedy tokens and every step's
   logits agree within 1e-3 of the largest reference logit.
14. Prints the seconds of each phase, then one ``{"kernels": [...]}``
   line (eleven kernels, each with its launches on its path, which must
   be above 0; the prefill kernel's D=64 (phase 2's S=512 bucket), D=192
   and D=80 cases ride in its entry as ``at_d64``, ``at_d192`` and
   ``at_d80``, the GQA and MLA paged decodes' longer windows as
   ``at_long_window``, the contiguous MLA decode's B=8, S=512 case as
   ``at_b8_s512``), then, last, ``{"ok": true, "device": {...}}``.
   Details go to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --cards 4`` (a machine with four cards) runs
only the multi-rank path with one card per rank over NCCL: the phase-7
command on ``--devices 2,1,1`` and on ``--devices 2,2,1`` with
capacities 2,1,1,0 (a dead rank), each with phase 7's checks, then the
invariant and exchange probe on two cards. Details go to
``chiprun_out/chip_smoke_cards.json``; the last line is the same.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

FP32_TOL = 1e-4
BF16_TOL = 2e-2
# the bf16 contiguous MLA decode against its split model, which follows
# the kernel's tiles, splits and rounding: about 4x the largest gap read
# on the card (5.4e-4)
SPLIT_MODEL_TOL = 2e-3
# Kernel path vs reference path logits of the whole 22-layer model in
# bf16: the two paths round attention at different points, and the
# difference compounds through the layers. Relative to the largest
# reference logit (at least 1).
LOGIT_TOL = 5e-2
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16
REPS = 20
# rows x tokens of one train-phase microbatch: 8 rows + 2 dummy rows of
# headroom, accum 2
TRAIN_MICROBATCH = (5, 1024)

SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--device", "cuda",
              "--attention-impl", "kernel", "--seed", "0",
              "--slots", "8", "--prefill-batch", "2", "--requests", "16",
              "--min-prompt", "64", "--max-prompt", "448",
              "--min-gen", "16", "--max-gen", "64",
              "--pod-speeds", "1,0.5"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = REPS):
    """Median ms of ``reps`` calls, each between two CUDA events, after
    three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS):
    """Device time of one call: the kernels torch.profiler sees over
    ``reps`` calls after three warm-up calls, summed, over ``reps``. Where
    a call is host-bound, :func:`cuda_ms` reads the host's time and this
    the card's. The profiler's trace can come back without kernels: then
    it is taken once more, and a second empty trace gives None (not
    measured)."""
    by_kernel = device_ms_by_kernel(fn, reps)
    return by_kernel and sum(by_kernel.values())


def device_ms_by_kernel(fn, reps: int = REPS):
    """:func:`device_ms` by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = _kernel_times(prof)
        if by_name:
            return {n: us / reps / 1e3 for n, (_, us) in by_name.items()}
    return None


def _ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


# --------------------------------------------------------------------------
# the bf16 tensor-core kernels: what the compiler made of them
# --------------------------------------------------------------------------

SM90_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
                "cross_entropy.cu", "mla_decode.cu", "ssd_scan.cu")
# the bf16 kernels' entry points that run no product: merges and the
# SSD state passing
SM90_HELPERS = ("ce_merge", "mla_merge", "ssd_state_pass")


def _sm90_name(mangled: str):
    """A short name for the bf16 tensor-core kernels' entry points (the
    product kernels and their helpers: the CE and MLA merges, the SSD
    state passing), None for any other."""
    import re
    for name in ("ssd_chunk_state_sm90",
                 "ssd_chunk_scan_sm90") + SM90_HELPERS[1:]:
        if name in mangled:
            return name
    m = re.search(r"mla_split_sm90ILb([01])E", mangled)
    if m:
        return "mla_split_sm90<" + ("paged" if m.group(1) == "1"
                                    else "contiguous") + ">"
    m = re.search(r"flash_fwd_sm90ILi(\d+)E", mangled)
    if m:
        return f"flash_fwd_sm90<D={m.group(1)}>"
    m = re.search(r"flash_bwd_(dq|dkv)_sm90ILi(\d+)E", mangled)
    if m:
        return f"flash_bwd_{m.group(1)}_sm90<D={m.group(2)}>"
    m = re.search(r"ce_fwd_sm90ILi(\d)E", mangled)
    if m:
        return "ce_fwd_sm90<" + ("(D, V) head" if m.group(1) == "1"
                                 else "tied (V, D) head") + ">"
    return "ce_merge" if "ce_merge" in mangled else None


def _by_entry(text: str, start_re: str):
    """Split compiler output into {short name: body} at each entry point
    that ``start_re`` (one group: the mangled name) finds."""
    import re
    marks = [(m.start(), m.group(1)) for m in re.finditer(start_re, text)]
    out = {}
    for i, (pos, mangled) in enumerate(marks):
        name = _sm90_name(mangled)
        if name:
            end = marks[i + 1][0] if i + 1 < len(marks) else len(text)
            out[name] = out.get(name, "") + text[pos:end]
    return out


def sm90_report(build, lib, fa, ce, md, sk):
    """ptxas's registers and spills of the bf16 tensor-core kernels, the
    dynamic shared memory each launch asks for, the tiles each takes
    (held equal to those the CPU models of the tests follow: ``KV_TILES``,
    ``BWD_TILES``, ``TOKEN_TILE``, ``VOCAB_TILE``, the decode's
    ``DECODE_SPLIT``, the MLA decode's ``SPLIT``, ``TILE`` and ``PART``,
    the SSD scan's ``ROW_TILE``), and the instructions
    their PTX (``nvcc -ptx``) and, where the toolkit has cuobjdump, their
    SASS hold: every product kernel must issue ``wgmma.mma_async``
    (HGMMA) on operands that ``cp.async`` brought to shared memory."""
    import re
    import shutil
    rows = {}
    for name, body in _by_entry(build.ptxas_log(),
                                r"Compiling entry function '(\S+)'").items():
        regs = re.findall(r"Used (\d+) registers", body)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", body)
        rows[name] = {"registers": int(regs[0]),
                      "spill_bytes": sum(int(a) + int(b) for a, b in spills)}
    for d in (64, 80, 128, 192):
        rows[f"flash_fwd_sm90<D={d}>"]["dynamic_smem"] = \
            lib.flash_attention_fwd_sm90_smem(d)
        kv_tile = lib.flash_attention_fwd_sm90_kv_tile(d)
        check(kv_tile == fa.KV_TILES[d], f"D={d}: the kernel's kv tile is "
              f"{kv_tile}, KV_TILES says {fa.KV_TILES[d]}")
    for d in fa.BWD_HEAD_DIMS:
        tiles = tuple(lib.flash_attention_bwd_sm90_tile(d, a)
                      for a in range(4))
        check(tiles == fa.BWD_TILES[d], f"backward D={d}: the kernels' "
              f"tiles are {tiles}, BWD_TILES says {fa.BWD_TILES[d]}")
        for pass_, part in ((0, "dq"), (1, "dkv")):
            rows[f"flash_bwd_{part}_sm90<D={d}>"]["dynamic_smem"] = \
                lib.flash_attention_bwd_sm90_smem(d, pass_)
    split = lib.paged_decode_split_len()
    check(split == fa.DECODE_SPLIT, f"the decode kernel splits by {split} "
          f"positions, DECODE_SPLIT says {fa.DECODE_SPLIT}")
    ce_tiles = (lib.ce_fwd_sm90_tile(0), lib.ce_fwd_sm90_tile(1))
    check(ce_tiles == (ce.TOKEN_TILE, ce.VOCAB_TILE),
          f"ce_fwd's tiles are {ce_tiles}, the wrapper says "
          f"{(ce.TOKEN_TILE, ce.VOCAB_TILE)}")
    mla = (lib.mla_decode_paged_split_len(), lib.mla_decode_paged_tile(),
           lib.mla_decode_paged_part_len())
    check(mla == (md.SPLIT, md.TILE, md.PART), f"the MLA decode's split, "
          f"tile and partial are {mla}, the wrapper says "
          f"{(md.SPLIT, md.TILE, md.PART)}")
    ssd = lib.ssd_scan_sm90_tile()
    check(ssd == sk.ROW_TILE, f"the SSD scan's row tile is {ssd}, the "
          f"wrapper says {sk.ROW_TILE}")
    print(f"[sm90] tiles as the CPU models take them: kv {fa.KV_TILES}, "
          f"backward (dq rows, kv, dk/dv keys, q) {fa.BWD_TILES}, "
          f"CE {ce_tiles[0]} tokens x {ce_tiles[1]} vocab columns, "
          f"decode split {split} positions, MLA decode split {mla[0]} "
          f"positions in tiles of {mla[1]} (partials of {mla[2]} floats), "
          f"SSD chunk scan tiles of {ssd} rows",
          flush=True)
    for name in rows:
        if name.startswith("ce_fwd_sm90"):
            rows[name]["dynamic_smem"] = lib.ce_fwd_sm90_smem()
    for cache in ("paged", "contiguous"):
        rows[f"mla_split_sm90<{cache}>"]["dynamic_smem"] = \
            lib.mla_decode_paged_sm90_smem()
    rows["ssd_chunk_state_sm90"]["dynamic_smem"] = lib.ssd_scan_sm90_smem(0)
    rows["ssd_chunk_scan_sm90"]["dynamic_smem"] = lib.ssd_scan_sm90_smem(1)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    have_sass = Path(cuobjdump).exists()
    objs = {o.stem.rsplit("_", 1)[0]: o for o in build.objects()}
    for src in SM90_SOURCES:
        path = build.CSRC / src
        for name, body in _by_entry(build.ptx(path),
                                    r"\.entry\s+(\w+)\(").items():
            rows[name]["ptx_wgmma"] = body.count("wgmma.mma_async")
            rows[name]["ptx_cp_async"] = body.count("cp.async.cg")
        if have_sass:
            sass = subprocess.run([cuobjdump, "-sass", str(
                objs[path.stem])], capture_output=True,
                text=True, check=True, timeout=300).stdout
            for name, body in _by_entry(sass, r"Function : (\S+)").items():
                rows[name]["sass_hgmma"] = body.count("HGMMA")
    for name, r in rows.items():
        print(f"[sm90] {name}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled, "
              f"{r.get('dynamic_smem', 0)} B dynamic shared memory; PTX "
              f"{r.get('ptx_wgmma', 0)} wgmma.mma_async, "
              f"{r.get('ptx_cp_async', 0)} cp.async"
              + (f"; SASS {r.get('sass_hgmma', 0)} HGMMA" if have_sass
                 else "; no cuobjdump: SASS not read"), flush=True)
    products = [n for n in rows if n not in SM90_HELPERS]
    check(len(products) == 14, f"bf16 tensor-core kernels found: {products}")
    for n in products:
        r = rows[n]
        check(r["spill_bytes"] == 0, f"{n}: ptxas spilled")
        check(r.get("ptx_wgmma", 0) > 0 and r.get("ptx_cp_async", 0) > 0,
              f"{n}: no wgmma.mma_async or cp.async in its PTX")
        check(not have_sass or r.get("sass_hgmma", 0) > 0,
              f"{n}: no HGMMA in its SASS")
    return rows


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def _sdpa(q, k, v, causal, mask=None):
    """SDPA on (B, H, S, D) inputs with grouped kv heads. Where SDPA has
    no ``enable_gqa`` (torch < 2.5) the caller repeats the kv heads
    before timing."""
    import torch.nn.functional as F
    if q.shape[1] == k.shape[1]:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


def _sdpa_layout(q, k, v):
    """(B, S, H, D) -> SDPA's (B, H, S, D), made before timing."""
    import torch
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) < (2, 5):
        g = qt.shape[1] // kt.shape[1]
        kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    return qt, kt, vt


def prefill_case(fa, b, s, dtype, gen, dev):
    import torch
    h, hkv, d = 32, 4, 64
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(fa.flash_attention_cuda(q, k, v, causal=True), got),
          f"prefill {dtype} at S={s}: two runs differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype),
           "B": b, "Sq": s, "Skv": s, "H": h, "Hkv": hkv, "D": d,
           "max_abs_err": err, "bitwise_repeat": True}
    if dtype == torch.bfloat16:
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        flops = 2.0 * b * h * s * s * d        # causal: half of 4*B*H*S*S*D
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec


# kv_lens of the serve shape (MB=32: up to 512, one exactly 512) and of
# the longer window (MB=128: up to 2048, one exactly 2048); slot 1 is
# inactive in both
SERVE_LENS = [512, 1, 37, 200, 16, 301, 455, 129]
LONG_LENS = [2048, 1, 150, 800, 64, 1203, 1820, 517]


def paged_tables(dev, b=8, bs=16, mb=32, lens=SERVE_LENS):
    """Block tables of B=8 sequences over a pool of B*MB blocks of 16
    tokens: ragged kv_lens up to MB*bs (one exactly MB*bs), NULL holes
    inside live windows and one all-NULL inactive slot with kv_len 1."""
    import torch
    n = b * mb
    tables = torch.full((b, mb), n, dtype=torch.int32)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    used = 0
    for i, ln in enumerate(lens):
        if i == 1:
            continue
        nb = -(-ln // bs)
        tables[i, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
        if nb > 2 and i % 2 == 0:
            tables[i, nb // 2] = n                # NULL hole
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    return tables.to(dev), kv_lens.to(dev)


def paged_inputs(gen, dev, dtype, mb=32, lens=SERVE_LENS):
    """GQA decode inputs at tinyllama widths over :func:`paged_tables`."""
    import torch
    b, bs, hkv, h, d = 8, 16, 4, 32, 64
    n = b * mb
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    return (q, kp, vp) + paged_tables(dev, b, bs, mb, lens)


def decode_case(fa, gen, dev, dtype, mb=32, lens=SERVE_LENS):
    import torch
    q, kp, vp, tables, kv_lens = paged_inputs(gen, dev, dtype, mb, lens)
    got = fa.flash_decode_paged_cuda(q, kp, vp, tables, kv_lens)
    want = fa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(not got[1].any().item(), "decode: inactive slot output is not 0")
    check(torch.equal(fa.flash_decode_paged_cuda(q, kp, vp, tables,
                                                 kv_lens), got),
          f"decode {dtype} at MB={mb}: two runs differ")
    b, _, h, d = q.shape
    n, bs, hkv, _ = kp.shape
    rec = {"kernel": "flash_decode_paged_cuda", "dtype": str(dtype),
           "B": b, "H": h, "Hkv": hkv, "D": d, "bs": bs, "N": n,
           "MB": tables.shape[1], "kv_lens": kv_lens.tolist(),
           "max_abs_err": err, "bitwise_repeat": True,
           "window": "serve" if lens is SERVE_LENS else "long"}
    if dtype == torch.bfloat16:
        rec["ms"] = cuda_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, tables, kv_lens))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_decode_paged_plain(
            q, kp, vp, tables, kv_lens))
        # SDPA on the same window, gathered densely before timing
        idx = torch.where(tables < n, tables, 0).long()
        keep = (tables < n)[:, :, None, None, None]
        win_k = torch.where(keep, kp[idx], 0).reshape(b, -1, hkv, d)
        win_v = torch.where(keep, vp[idx], 0).reshape(b, -1, hkv, d)
        pos = torch.arange(win_k.shape[1], device=dev)
        mask = (pos[None, :] < kv_lens[:, None].long())[:, None, None, :]
        qt, kt, vt = _sdpa_layout(q, win_k, win_v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, False, mask))
        rec["device_ms"] = device_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, tables, kv_lens))
        rec["library_device_ms"] = device_ms(
            lambda: _sdpa(qt, kt, vt, False, mask))
        # bytes this data needs: the K/V rows below kv_len in mapped
        # blocks, each read once, plus q, tables, lens and the output
        pos_ok = (torch.arange(tables.shape[1] * bs, device=dev)[None, :]
                  < kv_lens[:, None].long())
        mapped = (tables < n).repeat_interleave(bs, dim=1)
        rows = int((pos_ok & mapped).sum().item())
        nbytes = (rows * hkv * d * 2 * 2 + 2 * q.numel() * 2
                  + tables.numel() * 4 + kv_lens.numel() * 4)
        flops = 4.0 * int(kv_lens.sum().item()) * h * d
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec


def kernel_phase(fa, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = []
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for s in (16, 128, 200, 512):
            recs.append(prefill_case(fa, 2, s, dtype, gen, dev))
        recs.append(decode_case(fa, gen, dev, dtype, 128, LONG_LENS))
        recs.append(decode_case(fa, gen, dev, dtype))
        for r in recs[-6:]:
            shape = r.get("Sq", r.get("kv_lens"))
            print(f"[kernels] {r['kernel']} {r['dtype']} at {shape}: max "
                  f"abs err {r['max_abs_err']:.3e} (tol {tol:g})"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"SDPA {r['library_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, SDPA's "
                     f"{_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else ""), flush=True)
            check(r["max_abs_err"] <= tol,
                  f"{r['kernel']} {r['dtype']} at {shape}: error "
                  f"{r['max_abs_err']} > {tol}")
    return recs


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------

def reference_checked_build(orig_build, compare, check_s, router_log=None,
                            all_finite=False):
    """A ``build_engine`` that, on the first prefill group and the first
    decode step, first runs the model's "reference" path on the same
    inputs and a copy of the cache, then the engine's own step, and hands
    both logits to ``compare(what, got, want)``; the reference's time
    goes to ``check_s[0]``. ``router_log["target"]`` names the path that
    is running (for a caller recording MoE routing); ``all_finite``
    checks the logits of every step."""
    import torch
    from repro_torch.models.model import build_model

    def build_checked(model, params, layout, *a, **k):
        eng = orig_build(model, params, layout, *a, **k)
        ref = build_model(dataclasses.replace(model.cfg,
                                              attention_impl="reference"),
                          model.device)
        first = {"prefill": True, "decode": True}
        labels = {"prefill": "first prefill group",
                  "decode": "first decode step"}

        def checked(kind, fn, ref_fn, cache_at):
            def run(*args):
                if not first[kind]:
                    got, cache = fn(*args)
                else:
                    first[kind] = False
                    t0 = time.monotonic()
                    ref_args = list(args)
                    ref_args[cache_at] = {n: c.clone() for n, c in
                                          args[cache_at].items()}
                    if router_log is not None:
                        router_log["target"] = "reference"
                    want, _ = ref_fn(params, *ref_args)
                    del ref_args
                    torch.cuda.synchronize()
                    check_s[0] += time.monotonic() - t0
                    if router_log is not None:
                        router_log["target"] = "kernel"
                    got, cache = fn(*args)
                    if router_log is not None:
                        router_log["target"] = None
                    compare(labels[kind], got, want)
                if all_finite:
                    check(bool(torch.isfinite(got).all()),
                          f"non-finite logits in a {kind} step")
                return got, cache
            return run

        eng.prefill_fns = {b: checked("prefill", f, ref.prefill_paged, 2)
                           for b, f in eng.prefill_fns.items()}
        eng.decode_fn = checked("decode", eng.decode_fn, ref.decode_paged,
                                1)
        return eng
    return build_checked


def path_phase(fa, md, dev):
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve

    full = resolve("tinyllama-1.1b")

    checks = {}
    check_s = [0.0]
    orig_build = tserve.build_engine

    def compare(what, got, want):
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite logits")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                        "tol": LOGIT_TOL * scale,
                        "argmax_agree": float(
                            (g.argmax(-1) == w.argmax(-1)).float().mean())}
        print(f"[path] {what}: kernel vs reference logits max abs err "
              f"{err:.4e} (tol {LOGIT_TOL * scale:.4e})", flush=True)
        check(err <= LOGIT_TOL * scale, f"{what}: logits differ by {err}")

    tserve.build_engine = reference_checked_build(orig_build, compare,
                                                  check_s)
    try:
        fa.flash_attention_cuda.launches = 0
        fa.flash_decode_paged_cuda.launches = 0
        md.mla_decode_paged_cuda.launches = 0
        result = tserve.main(SERVE_ARGV)
        launches = {"flash_attention_cuda": fa.flash_attention_cuda.launches,
                    "flash_decode_paged_cuda":
                        fa.flash_decode_paged_cuda.launches,
                    "mla_decode_paged_cuda":
                        md.mla_decode_paged_cuda.launches}
    finally:
        tserve.build_engine = orig_build

    st = result.stats
    args = tserve.parser().parse_args(SERVE_ARGV)
    reqs = tserve.synthetic_requests(
        args.requests, full.vocab_size, args.rate, (args.min_prompt, args.max_prompt),
        (args.min_gen, args.max_gen), args.seed)
    for r in reqs:
        toks = result.tokens[r.rid]
        check(len(toks) == r.max_new_tokens,
              f"request {r.rid}: {len(toks)} of {r.max_new_tokens} tokens")
        check(all(0 <= t < full.vocab_size for t in toks),
              f"request {r.rid}: token id out of vocab")
    check(len(checks) == 2, f"reference checks ran: {sorted(checks)}")
    layers = full.num_layers
    check(launches["flash_attention_cuda"] > 0
          and launches["flash_decode_paged_cuda"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(launches["flash_attention_cuda"] == layers * st["prefill_groups"],
          f"prefill launches {launches} != {layers} x "
          f"{st['prefill_groups']} groups")
    check(launches["flash_decode_paged_cuda"] == layers * st["decode_steps"],
          f"decode launches {launches} != {layers} x "
          f"{st['decode_steps']} steps")
    check(launches["mla_decode_paged_cuda"] == 0,
          f"the MLA decode kernel launched on a GQA model: {launches}")
    check(st["kernel_launches"] == launches,
          f"engine stats {st['kernel_launches']} != counters {launches}")
    wall = st["wall_seconds"] - check_s[0]
    path = {"stats": st, "launches": launches, "logit_checks": checks,
            "check_seconds": check_s[0],
            "tokens_per_s_wall": st["total_tokens"] / wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[path] {st['total_tokens']} tokens in {wall:.3f} s of wall "
          f"(reference checks excluded): {path['tokens_per_s_wall']:.1f} "
          f"tok/s, peak memory {path['peak_memory_gib']:.3f} GiB, "
          f"launches {launches}", flush=True)
    return path


# --------------------------------------------------------------------------
# training kernel phase
# --------------------------------------------------------------------------

def _errs(got, want):
    """(max abs error, relative L2 error) of one output, or the largest
    of each over matching tuples of outputs."""
    import torch
    from repro_torch.kernels.parity import rel_l2
    if isinstance(got, (tuple, list)):
        pairs = [_errs(g, w) for g, w in zip(got, want)]
        return max(a for a, _ in pairs), max(r for _, r in pairs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err, rel_l2(got, want)


def _attn_bound(b, s, h, hkv, d, factor, tensors_in, tensors_out):
    """Least time of causal attention work: ``factor`` x 2*B*H*S*S*D
    operations (the causal forward's), or the bytes of the inputs read
    once and the outputs written once."""
    flops = factor * 2.0 * b * h * s * s * d
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_in, *tensors_out))
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_train_case(fa, b, s, h, hkv, d, dtype, gen, dev, timed):
    import torch
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    e_fwd, r_fwd = _errs((out, lse), fa.flash_attention_plain(
        q, k, v, return_lse=True))
    again = fa.flash_attention_cuda(q, k, v, return_lse=True)
    check(torch.equal(again[0], out) and torch.equal(again[1], lse),
          "attention forward differs between two runs")
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    e_bwd, r_bwd = _errs(grads, fa.flash_attention_bwd_plain(
        q, k, v, out, lse, dout))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          "attention backward differs between two runs")
    shape = {"dtype": str(dtype), "B": b, "S": s, "H": h, "Hkv": hkv,
             "D": d}
    fwd = {"kernel": "flash_attention_cuda", **shape, "with_lse": True,
           "max_abs_err": e_fwd, "rel_l2": r_fwd, "bitwise_repeat": True}
    bwd = {"kernel": "flash_attention_bwd_cuda", **shape,
           "max_abs_err": e_bwd, "rel_l2": r_bwd, "bitwise_repeat": True}
    if timed:
        fwd["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
            q, k, v, return_lse=True))
        fwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, return_lse=True))
        qt, kt, vt = _sdpa_layout(q, k, v)
        fwd["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        fwd["bound_ms"], fwd["bound_by"] = _attn_bound(
            b, s, h, hkv, d, 1.0, (q, k, v), (out, lse))
        bwd["ms"] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, dout))
        bwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout))
        qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        o_t = _sdpa(qt, kt, vt, True)
        do_t = dout.transpose(1, 2).contiguous()
        bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do_t, retain_graph=True))
        bwd["device_ms"] = device_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, dout))
        bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do_t, retain_graph=True))
        # five products of the forward's size (2.5x its operations)
        bwd["bound_ms"], bwd["bound_by"] = _attn_bound(
            b, s, h, hkv, d, 2.5, (q, k, v, out, lse, dout), grads)
    return [fwd, bwd]


def ce_case(ce, ce_ref, t, d, v, eps, tied, dtype, gen, dev, timed):
    import torch
    import torch.nn.functional as F
    hid = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    table = (torch.randn((v, d), generator=gen, device=dev)
             * d ** -0.5).to(dtype)
    head = table.t() if tied else table.t().contiguous()
    labels = torch.randint(0, v, (t,), generator=gen, device=dev)
    weights = (torch.rand((t,), generator=gen, device=dev) > 0.2).float()
    got = ce.cross_entropy_cuda(hid, head, labels, weights,
                                label_smoothing=eps, return_lse=True)
    want = ce.cross_entropy_plain(hid, head, labels, weights,
                                  label_smoothing=eps, return_lse=True)
    e, r = _errs(got, want)
    again = ce.cross_entropy_cuda(hid, head, labels, weights,
                                  label_smoothing=eps, return_lse=True)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          "cross entropy forward differs between two runs")
    rec = {"kernel": "cross_entropy_cuda", "dtype": str(dtype), "T": t,
           "D": d, "V": v, "eps": eps, "tied_rows": tied,
           "zero_weights": int((weights == 0).sum().item()),
           "max_abs_err": e, "rel_l2": r, "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(lambda: ce.cross_entropy_cuda(
            hid, head, labels, weights, label_smoothing=eps), reps=5)
        rec["plain_ms"] = cuda_ms(lambda: ce.cross_entropy_plain(
            hid, head, labels, weights, label_smoothing=eps), reps=5)
        # two calls: no single PyTorch call fuses the head with the loss
        rec["library_ms"] = cuda_ms(lambda: F.cross_entropy(
            F.linear(hid, table).float(), labels, reduction="none",
            label_smoothing=eps), reps=5)
        flops = 2.0 * t * d * v
        nbytes = (hid.numel() + table.numel()) * hid.element_size() + \
            t * (8 + 4) + 2 * t * 4
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rec, (hid, head, labels, weights, want[2])


def dlogits_case(ce, ce_ref, inputs, eps, dtype, timed):
    import torch
    hid, head, labels, weights, lse = inputs
    logits = ce_ref.mm_f32(hid, head)
    dloss = torch.tensor(0.7, device=hid.device)
    got = ce.ce_dlogits_cuda(logits, lse, labels, weights, dloss,
                             label_smoothing=eps, dtype=dtype)
    want = ce_ref.ce_dlogits(logits, lse, labels, weights, dloss,
                             label_smoothing=eps, dtype=dtype)
    e, r = _errs(got, want)
    check(got.dtype == dtype and not got[weights == 0].any().item(),
          "dlogits: dummy rows are not exactly 0")
    rec = {"kernel": "ce_dlogits_cuda", "dtype": str(dtype),
           "R": logits.shape[0], "V": logits.shape[1], "eps": eps,
           "max_abs_err": e, "rel_l2": r, "library_ms": None}
    if timed:
        rec["ms"] = cuda_ms(lambda: ce.ce_dlogits_cuda(
            logits, lse, labels, weights, dloss, label_smoothing=eps,
            dtype=dtype))
        rec["plain_ms"] = cuda_ms(lambda: ce_ref.ce_dlogits(
            logits, lse, labels, weights, dloss, label_smoothing=eps,
            dtype=dtype))
        nbytes = logits.numel() * (4 + got.element_size()) + \
            logits.shape[0] * (4 + 8 + 4) + 4
        rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
    return rec


def train_kernel_phase(fa, ce, ce_ref, dev, main_rows, main_seq):
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(1)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        new = []
        for h, hkv, d in ((16, 16, 128), (32, 4, 64)):
            for s in (512, 1024, 200):
                new += attention_train_case(fa, 2, s, h, hkv, d, dtype, gen,
                                            dev, timed=False)
        for eps, tied in ((0.0, False), (0.1, True)):
            rec, inputs = ce_case(ce, ce_ref, 4096, 2048, 50304, eps, tied,
                                  dtype, gen, dev, timed=False)
            new += [rec, dlogits_case(ce, ce_ref, inputs, eps, dtype,
                                      timed=False)]
            del inputs
        if dtype == torch.bfloat16:     # the train phase's shapes, timed
            new += attention_train_case(fa, main_rows, main_seq, 16, 16,
                                        128, dtype, gen, dev, timed=True)
            rec, inputs = ce_case(ce, ce_ref, main_rows * main_seq, 2048,
                                  50304, 0.0, True, dtype, gen, dev,
                                  timed=True)
            hid, head, lab, wts, lse = inputs     # one backward chunk
            chunk = (hid[:4096], head, lab[:4096], wts[:4096], lse[:4096])
            new += [rec, dlogits_case(ce, ce_ref, chunk, 0.0, dtype,
                                      timed=True)]
            del inputs, chunk, hid, head, lab, wts, lse
        bad = []
        for r in new:
            shape = {k: r[k] for k in ("B", "S", "H", "D", "T", "V", "eps",
                                       "R") if k in r}
            r["tol"] = RTOL[(r["kernel"], dtype)]
            print(f"[train-kernels] {r['kernel']} {r['dtype']} {shape}: "
                  f"relative L2 error {r['rel_l2']:.3e} (tol {r['tol']:g}),"
                  f" max abs err {r['max_abs_err']:.3e}"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"library {r['library_ms']} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, the "
                     f"library's {_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else ""), flush=True)
            if not r["rel_l2"] <= r["tol"]:
                bad.append(f"{r['kernel']} {r['dtype']} {shape}: "
                           f"{r['rel_l2']} > {r['tol']}")
        check(not bad, "kernel vs plain: " + "; ".join(bad))
        recs += new
    return recs


# --------------------------------------------------------------------------
# train path phase
# --------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "olmo-1b", "--device", "cuda", "--seed", "0",
              "--steps", "6", "--global-batch", "8", "--seq-len", "1024",
              "--accum", "2", "--lr", "3e-4", "--warmup", "2",
              "--schedule", "constant", "--log-every", "1"]
# kernel path vs reference path on the first batch through 16 layers,
# in the run's bf16 and again in fp32 (TF32 off), where the two paths
# differ only in summation order: loss and grad norm relative to the
# reference value, and the relative L2 error of the worst gradient leaf.
# About 10x the readings on an H100 (bf16: 3.0e-5, 1.6e-4, 2.5e-2;
# fp32: 0, 0, 6.8e-6). The bf16 paths round at different points, so
# their worst leaf only catches gross faults; the fp32 one is tight.
TRAIN_RTOL = {"bfloat16": {"loss": 3e-4, "grad_norm": 2e-3, "leaf": 0.25},
              "float32": {"loss": 1e-6, "grad_norm": 1e-6, "leaf": 7e-5}}
# capacity-split vs single-batch gradient, fp32 (TF32 off): relative L2
# of the whole gradient; the two runs differ only in batch shapes, so
# in the order of a few sums (5.3e-6 on an H100)
INVARIANT_RTOL = 5e-5
INVARIANT_CAPS = (2.0, 1.0, 1.0, 0.0)


def _counters(fa, ce):
    fns = {"flash_attention_cuda": fa.flash_attention_cuda,
           "flash_attention_bwd_cuda": fa.flash_attention_bwd_cuda,
           "cross_entropy_cuda": ce.cross_entropy_cuda,
           "ce_dlogits_cuda": ce.ce_dlogits_cuda,
           "flash_decode_paged_cuda": fa.flash_decode_paged_cuda}
    return fns


def _tree_rel_l2(got, want):
    import torch
    from repro_torch.models.transformer import tree_leaves
    num = sum(torch.sum((a.float() - b.float()) ** 2)
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    den = sum(torch.sum(b.float() ** 2) for b in tree_leaves(want))
    return float(torch.sqrt(num / den))


def _leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def train_phase(fa, ce, dev, argv=None):
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy, weighting
    from repro_torch.core.accumulate import value_and_grad
    from repro_torch.kernels.cross_entropy.cross_entropy import BWD_CHUNK
    from repro_torch.kernels.parity import rel_l2
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import adam

    argv = list(argv or TRAIN_ARGV)
    fns = _counters(fa, ce)
    checks = {}
    check_s = [0.0]
    seen = {"first": None, "last": None}
    orig_build = tsteps.build_train_step

    def first_batch_checks(model, tcfg, state, batch):
        params = state.params
        # kernel vs reference path, same params and batch, leaf by leaf:
        # in the run's compute dtype and in fp32
        for dt in TRAIN_RTOL:
            cfg = dataclasses.replace(model.cfg, compute_dtype=dt)
            kern = build_model(cfg, model.device)
            ref = build_model(dataclasses.replace(
                cfg, attention_impl="reference"), model.device)
            k_loss, _, k_grads = tsteps.loss_and_grads(kern, tcfg, params,
                                                       batch)
            loss, w, grads = tsteps.loss_and_grads(ref, tcfg, params, batch,
                                                   ce_impl="reference")
            leaves = {n: rel_l2(a, b) for n, a, b in zip(
                _leaf_names(params), tree_leaves(k_grads),
                tree_leaves(grads))}
            attn = {n: e for n, e in leaves.items() if ".attn." in n}
            checks[f"reference_{dt}"] = {
                "loss": float(loss),
                "grad_norm": float(adam.global_norm(grads)),
                "weight": float(w), "kernel_loss": float(k_loss),
                "kernel_grad_norm": float(adam.global_norm(k_grads)),
                "leaf_rel_l2": leaves,
                "worst_leaf": max(leaves, key=leaves.get),
                "worst_attention_leaf": max(attn, key=attn.get)}
            del grads, k_grads
        # the HetSeq invariant, fp32: the batch's real rows as one batch
        # vs packed for capacities 2,1,1,0 (a dummy-only worker included)
        f32 = build_model(dataclasses.replace(
            model.cfg, compute_dtype="float32"), model.device)
        rows = batch["weights"].shape[0]
        real = batch["weights"].sum(dim=1) > 0
        samples = {k: batch[k][real].cpu().numpy()
                   for k in ("inputs", "labels")}
        tok_w = batch["weights"][real].cpu().numpy()
        (o, w1), g = value_and_grad(f32.loss_fn, params, {
            k: batch[k][real] for k in ("inputs", "labels", "weights")})
        want = weighting.scale_grads(g, w1)
        del g
        plan = cap.plan_capacities(int(real.sum()), INVARIANT_CAPS,
                                   headroom=1.25)
        packed = dummy.pack_global_batch(samples, plan, tok_w)
        b = plan.buffer_rows
        workers = [{k: torch.from_numpy(v[r * b:(r + 1) * b]).to(dev)
                    for k, v in packed.items()}
                   for r in range(plan.num_ranks)]
        loss_w, got = weighting.simulate_workers(f32.loss_fn, params,
                                                 workers)
        checks["invariant"] = {
            "capacities": list(INVARIANT_CAPS),
            "rows_per_rank": plan.rows_per_rank.tolist(),
            "buffer_rows": b, "batch_rows": rows,
            "loss_single": float(weighting.finalize(o, w1)),
            "loss_workers": float(loss_w),
            "grad_rel_l2": _tree_rel_l2(got, want), "tol": INVARIANT_RTOL}
        del got, want

    def build_checked(model, tcfg, mesh=None):
        step = orig_build(model, tcfg, mesh)

        def run(state, batch):
            if seen["first"] is None:
                t0 = time.monotonic()
                saved = {n: f.launches for n, f in fns.items()}
                first_batch_checks(model, tcfg, state, batch)
                for n, f in fns.items():         # checks do not count
                    f.launches = saved[n]
                torch.cuda.synchronize()
                check_s[0] += time.monotonic() - t0
                seen["first"] = True
            seen["last"] = (step, batch)
            return step(state, batch)
        return run

    tsteps.build_train_step = build_checked
    try:
        for f in fns.values():
            f.launches = 0
        result = ttrain.main(argv)
        launches = {n: f.launches for n, f in fns.items()}
    finally:
        tsteps.build_train_step = orig_build

    args = ttrain.parser().parse_args(argv)
    cfg = (cfgbase.smoke_config(args.arch) if args.smoke
           else cfgbase.resolve(args.arch))
    losses = result["losses"]
    n = result["steps"]
    check(n == args.steps and all(map(_finite, losses)),
          f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    plan = result["plan"]
    rows_mb = plan["buffer_rows"] // args.accum
    chunks = -(-rows_mb * args.seq_len // BWD_CHUNK)
    L = cfg.num_layers
    fwd_per_layer = 2 if cfg.remat == "full" else 1   # remat: once more
    expect = {"flash_attention_cuda": fwd_per_layer * L * args.accum * n,
              "flash_attention_bwd_cuda": L * args.accum * n,
              "cross_entropy_cuda": args.accum * n,
              "ce_dlogits_cuda": chunks * args.accum * n,
              "flash_decode_paged_cuda": 0}
    check(launches == expect, f"train launches {launches} != {expect}")

    first = result["metrics"][0]
    for dt, tol in TRAIN_RTOL.items():
        ref = checks[f"reference_{dt}"]
        ref["loss_rel"] = abs(ref["kernel_loss"] - ref["loss"]) / abs(
            ref["loss"])
        ref["grad_norm_rel"] = abs(ref["kernel_grad_norm"]
                                   - ref["grad_norm"]) / ref["grad_norm"]
        leaves = ref["leaf_rel_l2"]
        worst, worst_attn = ref["worst_leaf"], ref["worst_attention_leaf"]
        print(f"[train] first batch, kernel vs reference path, {dt}: loss "
              f"{ref['kernel_loss']:.6f} vs {ref['loss']:.6f} (rel "
              f"{ref['loss_rel']:.2e}, tol {tol['loss']:g}), grad norm "
              f"{ref['kernel_grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
              f"{ref['grad_norm_rel']:.2e}, tol {tol['grad_norm']:g}); "
              f"gradient leaves, relative L2: worst {worst} "
              f"{leaves[worst]:.3e}, worst attention {worst_attn} "
              f"{leaves[worst_attn]:.3e}, embed {leaves['embed']:.3e} (tol "
              f"{tol['leaf']:g})", flush=True)
        check(first["weight"] == ref["weight"], "train: weights differ")
        check(ref["loss_rel"] <= tol["loss"]
              and ref["grad_norm_rel"] <= tol["grad_norm"]
              and leaves[worst] <= tol["leaf"],
              f"train: kernel and reference paths disagree on the first "
              f"batch in {dt}")
    check(first["loss"] == checks["reference_bfloat16"]["kernel_loss"],
          "train: the step's first loss differs from the same batch's "
          "kernel-path loss in the check")
    inv = checks["invariant"]
    print(f"[train] HetSeq invariant (fp32), capacities "
          f"{inv['capacities']} -> rows {inv['rows_per_rank']} buffer "
          f"{inv['buffer_rows']}: loss {inv['loss_workers']:.6f} vs "
          f"{inv['loss_single']:.6f}, gradient relative L2 "
          f"{inv['grad_rel_l2']:.3e} (tol {INVARIANT_RTOL:g})", flush=True)
    check(inv["grad_rel_l2"] <= INVARIANT_RTOL,
          "train: capacity-split gradient differs from single-batch")

    # determinism: one more step from one state and one batch, twice
    t0 = time.monotonic()
    step, batch = seen["last"]
    state = result["state"]
    twin = tsteps.TrainState(
        params=tree_map(torch.clone, state.params),
        opt=adam.AdamState(step=state.opt.step.clone(),
                           m=tree_map(torch.clone, state.opt.m),
                           v=tree_map(torch.clone, state.opt.v)),
        err=state.err)
    a, _ = step(state, batch)
    b, _ = step(twin, batch)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))
    repeat_s = time.monotonic() - t0
    print(f"[train] repeated step bitwise identical: {same}", flush=True)
    check(same, "train: a repeated step gave different parameters")
    del b, twin, state, result["state"]

    # one more step under torch.profiler: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c, _ = step(a, batch)
        torch.cuda.synchronize()
    step_profile = _profile_rec(prof, (time.monotonic() - t0) * 1e6)
    del a, c, prof
    busy, win = step_profile["device_busy_us"], step_profile["window_us"]
    print(f"[train] torch.profiler over 1 step: kernels {busy / 1e3:.3f} ms "
          f"of device time in {win / 1e3:.3f} ms of wall; by kernel: "
          + "; ".join(f"{k['name'][:60]} x{k['count']} {k['us'] / 1e3:.3f} "
                      f"ms" for k in step_profile["kernels"][:12]),
          flush=True)

    step_s = result["step_s"][1:]
    ms = statistics.median(step_s) * 1e3
    tokens = args.global_batch * args.seq_len
    processed = plan["buffer_rows"] * args.seq_len
    n_params = cfg.param_count()
    attn = 3 * 2.0 * plan["buffer_rows"] * L * cfg.num_heads * \
        args.seq_len ** 2 * cfg.head_dim
    flops = 6.0 * n_params * processed + attn
    train = {
        "losses": losses, "metrics": result["metrics"], "plan": plan,
        "launches": launches, "expected_launches": expect,
        "checks": checks, "check_seconds": check_s[0],
        "repeat_step_seconds": repeat_s, "step_profile": step_profile,
        "ms_per_step_median_2_to_n": ms,
        "tokens_per_s": tokens / (ms / 1e3),
        "processed_tokens_per_s": processed / (ms / 1e3),
        "model_flops_per_step": flops,
        "mfu_vs_989_tflops": flops / (ms / 1e3) / H100_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "wall_s": result["wall_s"] - check_s[0]}
    print(f"[train] {cfg.name}: {ms:.1f} ms/step (median of steps 2..{n}),"
          f" {train['tokens_per_s']:.0f} real tokens/s "
          f"({processed} processed a step, {tokens} real), model FLOPs "
          f"{flops:.3e}/step = {100 * train['mfu_vs_989_tflops']:.2f}% of "
          f"989 TFLOP/s, peak memory {train['peak_memory_gib']:.2f} GiB, "
          f"launches {launches}", flush=True)
    return train


# --------------------------------------------------------------------------
# exchange kernel phase
# --------------------------------------------------------------------------

# the multi-rank phase's layout: olmo-1b's gradient stream in buckets of
# 25 MiB over 2 ranks (multiple of 2 x 256)
EXCHANGE_BUCKET_MB = 25.0
EXCHANGE_RANKS = 2


def exchange_layout(cfg):
    """The bucket grid of ``cfg``'s gradient stream at the multi-rank
    phase's settings (it depends only on the element count)."""
    import torch
    from repro_torch.core import buckets as bkt
    return bkt.build_layout(
        {"stream": torch.empty(cfg.param_count(), device="meta")},
        bucket_mb=EXCHANGE_BUCKET_MB, multiple_of=EXCHANGE_RANKS * 256)


def exchange_shapes(cfg):
    """Rows (blocks of 256) of each kernel launch on the multi-rank path:
    the first chunk's send-side quantize, its dequant-accumulate (R, rows
    of one shard) and the re-quantize of its shard sum; and the whole
    stack's, as one unchunked exchange would give them."""
    from repro_torch.core import buckets as bkt
    lo = exchange_layout(cfg)
    rows = bkt.chunk_buckets(lo) * lo.bucket_elems // 256
    total_rows = -(-lo.total // 256)
    return {"chunk_send": rows, "chunk_shard": rows // EXCHANGE_RANKS,
                "stack_send": total_rows,
                "stack_shard": lo.num_buckets * lo.bucket_elems // 256
                // EXCHANGE_RANKS}


def quantize_case(qz, q_ref, rows, gen, dev, *, noise, timed):
    import torch
    x = torch.randn((rows, 256), generator=gen, device=dev)
    x *= torch.rand((rows, 1), generator=gen, device=dev) * 10
    x[:2] = 0.0                                  # all-zero blocks
    nz = (torch.rand((rows, 256), generator=gen, device=dev)
          if noise else None)
    q, s = qz.quantize_int8_cuda(x, nz)
    qr, sr = q_ref.quantize_blocks(x, nz)
    torch.cuda.synchronize()
    same = torch.equal(q, qr) and torch.equal(s.view(torch.int32),
                                              sr.view(torch.int32))
    err = max((q.int() - qr.int()).abs().max().item(),
              (s - sr).abs().max().item())
    rec = {"kernel": "quantize_int8_cuda", "dtype": "float32", "rows": rows,
           "noise": noise, "bitwise_equal": same, "max_abs_err": err,
           "rel_l2": 0.0 if same else float("inf")}
    if timed:
        nbytes = rows * 256 * (4 + 1 + (4 if noise else 0)) + rows * 4
        rec.update(
            ms=cuda_ms(lambda: qz.quantize_int8_cuda(x, nz)),
            plain_ms=cuda_ms(lambda: q_ref.quantize_blocks(x, nz)),
            library_ms=None,
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes")
    del x, nz, q, s, qr, sr
    return rec


def dequant_case(qz, q_ref, ranks, rows, gen, dev, *, timed):
    import torch
    q = torch.randint(-127, 128, (ranks, rows, 256), generator=gen,
                      device=dev, dtype=torch.int8)
    s = torch.rand((ranks, rows), generator=gen, device=dev) * 0.1
    got = qz.dequant_accum_cuda(q, s)
    want = q_ref.dequant_accum(q, s)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    rec = {"kernel": "dequant_accum_cuda", "dtype": "float32", "R": ranks,
           "rows": rows, "bitwise_equal": same,
           "max_abs_err": (got - want).abs().max().item(),
           "rel_l2": 0.0 if same else float("inf")}
    if timed:
        nbytes = ranks * rows * (256 + 4) + rows * 256 * 4
        rec.update(
            ms=cuda_ms(lambda: qz.dequant_accum_cuda(q, s)),
            plain_ms=cuda_ms(lambda: q_ref.dequant_accum(q, s)),
            library_ms=None,
            two_call_ms=cuda_ms(lambda: torch.einsum(
                "rbk,rb->bk", q.float(), s)),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes")
    del q, s, got, want
    return rec


def exchange_kernel_phase(dev):
    """Both kernels bitwise against their plain versions: odd row counts
    (a partial last block of eight rows), all-zero blocks, stochastic
    rounding with noise from a seeded generator, the multi-rank path's
    per-launch shapes (timed) and the whole olmo-1b stack's."""
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.quantize import ref as q_ref
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = exchange_shapes(cfgbase.resolve("olmo-1b"))
    recs = []
    for rows, noise in ((1, False), (7, False), (1001, False),
                        (4099, True), (shapes["stack_send"], False)):
        recs.append(quantize_case(qz, q_ref, rows, gen, dev, noise=noise,
                                  timed=False))
    for ranks, rows in ((1, 9), (3, 1001), (8, 4099),
                        (EXCHANGE_RANKS, shapes["stack_shard"])):
        recs.append(dequant_case(qz, q_ref, ranks, rows, gen, dev,
                                 timed=False))
    # the path's launches: the send side, the re-quantize, the receive
    recs.append(quantize_case(qz, q_ref, shapes["chunk_shard"], gen, dev,
                              noise=False, timed=True))
    recs.append(quantize_case(qz, q_ref, shapes["chunk_send"], gen, dev,
                              noise=False, timed=True))
    recs.append(dequant_case(qz, q_ref, EXCHANGE_RANKS,
                             shapes["chunk_shard"], gen, dev, timed=True))
    for r in recs:
        shape = {k: r[k] for k in ("R", "rows", "noise") if k in r}
        print(f"[exchange-kernels] {r['kernel']} {shape}: bitwise equal "
              f"{r['bitwise_equal']}, max abs err {r['max_abs_err']:.3e}"
              + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                 + (f", q.float() + einsum {r['two_call_ms']:.4f} ms"
                    if "two_call_ms" in r else "")
                 if "ms" in r else ""), flush=True)
    bad = [f"{r['kernel']} rows {r['rows']}" for r in recs
           if not r["bitwise_equal"]]
    check(not bad, "exchange kernels differ from their plain versions: "
          + "; ".join(bad))
    return recs


# --------------------------------------------------------------------------
# multi-rank train path phase
# --------------------------------------------------------------------------

MULTI_ARGV = ["--arch", "olmo-1b", "--device", "cuda", "--seed", "0",
              "--devices", "2,1,1", "--grad-reduction", "hierarchical",
              "--compression", "int8", "--bucket-mb", "25",
              "--capacities", "2,1", "--global-batch", "8", "--seq-len",
              "1024", "--accum", "2", "--steps", "4", "--lr", "3e-4",
              "--warmup", "2", "--schedule", "constant", "--log-every", "1"]
# the HetSeq invariant across two ranks at full width, depth cut to 2
# layers, fp32 (TF32 off): the reduced gradient against one process on
# the union of the real rows, by relative L2 of the whole gradient. fp32
# exchange: the limit of the single-process invariant (4.9e-6 on an
# H100). int8: each element off by up to half a quantization step of its
# block, twice (9.7e-3 on an H100); the limit is about 10x that reading.
MULTI_INVARIANT_RTOL = {"none": 5e-5, "int8": 0.1}
MULTI_INVARIANT_LAYERS = 2


def probe_rank(rank, world, init_method, seq_len):
    """One rank of the multi-rank probe. (1) The invariant: the reduced
    gradient of a 2-layer full-width olmo-1b at fp32 over ``world`` ranks
    of capacities 2,1, with the fp32 and with the int8 exchange; rank 0
    also computes one process's gradient over the union of the real
    rows and returns both relative L2 errors. (2) The exchange alone: a
    random stack of full olmo-1b size exchanged three times each way
    (int8, fp32), host clock around a synchronized call; rank 0 returns
    the medians."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import capacity as cap
    from repro_torch.core import dummy
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.init((world, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cuda")
    try:
        cfg = dataclasses.replace(
            cfgbase.resolve("olmo-1b"), num_layers=MULTI_INVARIANT_LAYERS,
            compute_dtype="float32", attention_impl="kernel")
        model = build_model(cfg, mesh.device)
        plan = cap.plan_capacities(8, (2.0, 1.0), headroom=1.25)
        rng = np.random.default_rng(3)
        samples = {k: rng.integers(0, cfg.vocab_size, (8, seq_len)).astype(
            np.int32) for k in ("inputs", "labels")}
        packed = dummy.pack_global_batch(samples, plan)
        b = plan.buffer_rows
        mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(
            mesh.device) for k, v in packed.items()}
        out = {}
        for comp in ("none", "int8"):
            tcfg = cfgbase.TrainConfig(
                model=cfg, het=cfgbase.HetConfig(
                    grad_reduction="hierarchical", compression=comp,
                    bucket_mb=EXCHANGE_BUCKET_MB, quantize_impl="pallas"))
            state = tsteps.init_train_state(model, tcfg, mesh=mesh)
            layout = tsteps.bucket_layout(tcfg, mesh, state.params)
            loss_r, w, g, _ = tsteps.reduce_grads(model, tcfg, mesh,
                                                  layout, state, mine)
            if rank == 0:
                real = packed["weights"].sum(axis=1) > 0
                union = {k: torch.from_numpy(v[real]).to(mesh.device)
                         for k, v in packed.items()}
                loss, w1, want = tsteps.loss_and_grads(
                    model, tcfg, state.params, union)
                out[comp] = {"grad_rel_l2": _tree_rel_l2(g, want),
                             "loss": float(loss_r), "loss_single":
                             float(loss), "weight": float(w),
                             "weight_single": float(w1)}
                del want
            del g, state
        del model
        from repro_torch.core import buckets as bkt
        lo = exchange_layout(cfgbase.resolve("olmo-1b"))
        gen = torch.Generator(device=mesh.device).manual_seed(rank)
        stack = torch.randn((lo.num_buckets, lo.bucket_elems),
                            generator=gen, device=mesh.device)
        err = torch.zeros_like(stack)
        out["exchange_ms"] = {}
        for comp in ("int8", "none"):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                bkt.exchange_buckets(stack, err, comm=mesh.pod,
                                     compress=comp == "int8",
                                     total=lo.total, impl="kernel")
                torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
            out["exchange_ms"][comp] = statistics.median(times) * 1e3
    finally:
        mesh_mod.destroy(mesh)
    return out


def multi_rank_train(dev, argv, smi):
    """The driver's multi-rank run with its checks: finite losses, equal
    parameters on every rank, each rank's launches and wire bytes."""
    import gc
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import buckets as bkt
    from repro_torch.kernels.cross_entropy.cross_entropy import BWD_CHUNK
    from repro_torch.launch import train as ttrain
    gc.collect()
    torch.cuda.empty_cache()
    args = ttrain.parser().parse_args(argv)
    cfg = cfgbase.resolve(args.arch)
    print(f"[multi] parent holds {torch.cuda.memory_reserved(dev) / 2**30:.2f}"
          f" GiB on the card before the ranks start", flush=True)
    result = ttrain.main(argv)
    ranks = result["ranks"]
    n = result["steps"]
    losses = result["losses"]
    check(n == args.steps and all(map(_finite, losses)),
          f"multi-rank: losses {losses}")
    sums = result["end_checksums"]
    check(len(sums) == len(ranks) > 1 and len(set(sums)) == 1,
          f"multi-rank: parameters differ across ranks: {sums}")
    lo = exchange_layout(cfg)
    chunks = bkt.exchange_chunks(lo)
    plan = result["plan"]
    rows_mb = plan["buffer_rows"] // args.accum
    ce_chunks = -(-rows_mb * args.seq_len // BWD_CHUNK)
    L = cfg.num_layers
    fwd_per_layer = 2 if cfg.remat == "full" else 1
    expect = {"flash_attention_cuda": fwd_per_layer * L * args.accum * n,
              "flash_attention_bwd_cuda": L * args.accum * n,
              "cross_entropy_cuda": args.accum * n,
              "ce_dlogits_cuda": ce_chunks * args.accum * n,
              "quantize_int8_cuda": 2 * chunks * n,
              "dequant_accum_cuda": chunks * n}
    modeled = bkt.modeled_link_bytes(lo, 2, compress=True)
    for r in ranks:
        check(r["launches"] == expect,
              f"multi-rank: rank {r['rank']} launches {r['launches']} != "
              f"{expect}")
        check(r["link_bytes"] == [modeled] * n,
              f"multi-rank: rank {r['rank']} wire bytes {r['link_bytes']} "
              f"!= modeled {modeled} a step")
    ms = statistics.median(result["step_s"][1:]) * 1e3
    tokens = args.global_batch * args.seq_len
    peaks = [r["peak_memory_bytes"] / 2**30 for r in ranks]
    print(f"[multi] {cfg.name}, {len(ranks)} ranks (--devices "
          f"{args.devices}, capacities {args.capacities}) on "
          f"{torch.cuda.device_count()} card(s), backend "
          f"{result['backend']}, transport {result['transport']}: "
          f"{ms:.1f} ms/step (median of steps 2..{n}), "
          f"{tokens / (ms / 1e3):.0f} real tokens/s, peak memory per rank "
          f"{', '.join(f'{p:.2f}' for p in peaks)} GiB, {chunks} exchange "
          f"chunks, {modeled} wire bytes a step per rank (modeled "
          f"{modeled}), launches per rank {ranks[0]['launches']} [{smi}]",
          flush=True)
    return {"devices": args.devices, "losses": losses,
            "metrics": result["metrics"], "plan": plan,
            "launches": ranks[0]["launches"], "expected_launches": expect,
            "launches_by_rank": [r["launches"] for r in ranks],
            "exchange_chunks": chunks, "link_bytes_per_step": modeled,
            "ms_per_step_median_2_to_n": ms,
            "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_gib_by_rank": peaks,
            "backend": result["backend"], "transport": result["transport"],
            "end_checksums": sums, "wall_s": result["wall_s"]}


def multi_rank_probe(seq_len, smi):
    """:func:`probe_rank` on two ranks, with its checks."""
    from repro_torch.core import buckets as bkt
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import mesh as mesh_mod
    chunks = bkt.exchange_chunks(exchange_layout(cfgbase.resolve("olmo-1b")))
    t0 = time.monotonic()
    inv = mesh_mod.spawn(probe_rank, 2, (seq_len,), timeout_s=600)[0]
    inv_s = time.monotonic() - t0
    exchange_ms = inv.pop("exchange_ms")
    print(f"[multi] one exchange of the full olmo-1b stack between the 2 "
          f"ranks ({chunks} chunks): int8 {exchange_ms['int8']:.1f} ms, "
          f"fp32 {exchange_ms['none']:.1f} ms (median of 3) [{smi}]",
          flush=True)
    for comp, rec in inv.items():
        rec["tol"] = MULTI_INVARIANT_RTOL[comp]
        print(f"[multi] HetSeq invariant across 2 ranks ({comp} exchange, "
              f"{MULTI_INVARIANT_LAYERS} layers, fp32): loss "
              f"{rec['loss']:.6f} vs {rec['loss_single']:.6f}, gradient "
              f"relative L2 {rec['grad_rel_l2']:.3e} (tol {rec['tol']:g})",
              flush=True)
        check(rec["weight"] == rec["weight_single"],
              f"multi-rank invariant ({comp}): weights differ")
        check(rec["grad_rel_l2"] <= rec["tol"],
              f"multi-rank invariant ({comp}): reduced gradient differs "
              f"from the single process's")
    return {"invariant": inv, "exchange_ms": exchange_ms,
            "seconds": inv_s}


def multi_rank_phase(dev, smi):
    train = multi_rank_train(dev, MULTI_ARGV, smi)
    return {**train, "probe": multi_rank_probe(1024, smi)}


# the multi-card run (``--cards 4``): the same path with one card per
# rank (NCCL), on two ranks and on four with a dead rank
CARDS_DEVICES = (("2,1,1", "2,1"), ("2,2,1", "2,1,1,0"))


def cards_main(dev, smi, cards):
    import torch
    from repro_torch.kernels import _build
    check(torch.cuda.device_count() >= cards,
          f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    t0 = time.monotonic()
    _build.build()
    phases = {"build": time.monotonic() - t0}
    runs = {}
    for devices, caps in CARDS_DEVICES:
        argv = [a for a in MULTI_ARGV]
        argv[argv.index("--devices") + 1] = devices
        argv[argv.index("--capacities") + 1] = caps
        t0 = time.monotonic()
        runs[devices] = multi_rank_train(dev, argv, smi)
        check(runs[devices]["backend"] == "nccl",
              f"{devices}: backend {runs[devices]['backend']}, not nccl")
        phases[devices] = time.monotonic() - t0
    t0 = time.monotonic()
    probe = multi_rank_probe(1024, smi)
    phases["probe"] = time.monotonic() - t0
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_cards.json").write_text(json.dumps(
        {"nvidia_smi": smi, "phase_seconds": phases, "runs": runs,
         "probe": probe}, indent=1, default=str))



# --------------------------------------------------------------------------
# MLA serving: kernel phase and path phase (deepseek-v2)
# --------------------------------------------------------------------------

MLA_H, MLA_R, MLA_DR, MLA_DQK = 128, 512, 64, 192
MLA_SCALE = MLA_DQK ** -0.5
MLA_LAYERS = 8            # depth cut: 8 of 60 layers fit one 80 GB card
MLA_GATE_LAYERS = 2       # the fp32 kernel-vs-reference gate's depth
# kernel path vs reference path logits of the fp32 gate (TF32 off):
# the two differ in attention's summation order only. Relative to the
# largest reference logit (at least 1).
MLA_GATE_TOL = 1e-3
MLA_SERVE_ARGV = [a if a != "tinyllama-1.1b" else "deepseek-v2-236b"
                  for a in SERVE_ARGV]


def _bound(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _mla_sdpa(qa, qr, ckv_win, kr_win, lens):
    """The yardstick: SDPA as MQA over the dense window, q = [q_abs |
    q_r] (B, H, 1, 576), k = [ckv | kr] (B, 1, S, 576), v = ckv (B, 1, S,
    512), a boolean length mask (made before timing)."""
    import torch
    import torch.nn.functional as F
    q = torch.cat([qa, qr], dim=-1)[:, :, None, :].contiguous()
    k = torch.cat([ckv_win, kr_win], dim=-1)[:, None].contiguous()
    v = ckv_win[:, None].contiguous()
    pos = torch.arange(k.shape[2], device=k.device)
    mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)


def mla_paged_case(md, mla_ref, gen, dev, dtype, timed, mb=32,
                   lens=SERVE_LENS):
    """The serve phase's decode shape: B=8 slots, bs=16, MB=32, ragged
    lengths (one at MB*bs, an inactive all-NULL slot), NULL holes; or
    the longer window (MB=128, lengths up to 2048). Two runs must give
    equal bits; timed, it also reads the device time of a call and of
    the yardstick's (the call is host-bound)."""
    import torch
    tables, kv_lens = paged_tables(dev, mb=mb, lens=lens)
    b, mb = tables.shape
    n, bs = b * mb, 16
    qa = torch.randn((b, MLA_H, MLA_R), generator=gen, device=dev).to(dtype)
    qr = torch.randn((b, MLA_H, MLA_DR), generator=gen, device=dev).to(dtype)
    cp = torch.randn((n, bs, MLA_R), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, bs, MLA_DR), generator=gen, device=dev).to(dtype)
    args = (qa, qr, cp, kp, tables, kv_lens, MLA_SCALE)
    got = md.mla_decode_paged_cuda(*args)
    want = mla_ref.mla_decode_paged_online_plain(*args)
    torch.cuda.synchronize()
    check(not got[1].any().item(), "MLA decode: inactive slot is not 0")
    check(torch.equal(md.mla_decode_paged_cuda(*args), got),
          f"MLA decode {dtype} at MB={mb}: two runs differ")
    rec = {"kernel": "mla_decode_paged_cuda", "dtype": str(dtype), "B": b,
           "H": MLA_H, "r": MLA_R, "Dr": MLA_DR, "bs": bs, "N": n, "MB": mb,
           "kv_lens": kv_lens.tolist(),
           "max_abs_err": (got - want).abs().max().item(),
           "bitwise_repeat": True,
           "window": "serve" if lens is SERVE_LENS else "long"}
    if timed:
        rec["ms"] = cuda_ms(lambda: md.mla_decode_paged_cuda(*args))
        rec["plain_ms"] = cuda_ms(
            lambda: mla_ref.mla_decode_paged_online_plain(*args))
        win = (mla_ref.gather_blocks(cp, tables),
               mla_ref.gather_blocks(kp, tables))
        sdpa = _mla_sdpa(qa, qr, *win, kv_lens)
        rec["library_ms"] = cuda_ms(sdpa)
        rec["device_ms"] = device_ms(lambda: md.mla_decode_paged_cuda(*args))
        rec["library_device_ms"] = device_ms(sdpa)
        # the latent rows below kv_len in mapped blocks, read once; q, the
        # tables and lengths; the fp32 output
        pos_ok = (torch.arange(mb * bs, device=dev)[None, :]
                  < kv_lens[:, None].long())
        mapped = ((tables >= 0) & (tables < n)).repeat_interleave(bs, dim=1)
        rows = int((pos_ok & mapped).sum().item())
        el = qa.element_size()
        nbytes = (rows * (MLA_R + MLA_DR) * el + b * MLA_H * (MLA_R + MLA_DR)
                  * el + tables.numel() * 4 + b * 4 + got.numel() * 4)
        flops = (2.0 * (MLA_R + MLA_DR) + 2.0 * MLA_R) * MLA_H * int(
            kv_lens.sum().item())
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


# the MLA generate phase's decode shape: B=4 sequences over a contiguous
# cache of S = 1024 + 64 positions; the last step's lengths (all at S)
# and a ragged set
MLA_GEN_B, MLA_GEN_S = 4, 1088
MLA_GEN_LENS = {"full": [MLA_GEN_S] * 4, "ragged": [MLA_GEN_S, 1, 513, 700]}
# the contiguous kernel's continuity row (PERF.md's B=8, S=512)
MLA_CONT_AT = (8, 512)


def _mla_contiguous_inputs(gen, dev, dtype, b, s, lens):
    """(q_abs, q_r, ckv, kr, kv_len, scale) of B sequences at S
    positions, lengths ``lens`` or drawn in [1, S] with one at S."""
    import torch
    qa = torch.randn((b, MLA_H, MLA_R), generator=gen, device=dev).to(dtype)
    qr = torch.randn((b, MLA_H, MLA_DR), generator=gen, device=dev).to(dtype)
    ckv = torch.randn((b, s, MLA_R), generator=gen, device=dev).to(dtype)
    kr = torch.randn((b, s, MLA_DR), generator=gen, device=dev).to(dtype)
    if lens is None:
        kv = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
        kv[0] = s
    else:
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    return qa, qr, ckv, kr, kv, MLA_SCALE


def mla_contiguous_case(md, mla_ref, s, gen, dev, dtype, timed, b=8,
                        lens=None):
    """:func:`_mla_contiguous_inputs`' case. Two runs must give equal
    bits, and the last sequence alone (over its own rows: fewer splits)
    the bits it gets inside a batch of 8; bf16 is also held to the split
    model. Timed, it also reads the device time of a call by launch
    (bf16: split and merge) and of the yardstick's (the call is
    host-bound)."""
    import torch
    args = _mla_contiguous_inputs(gen, dev, dtype, b, s, lens)
    qa, qr, ckv, kr, kv, _ = args
    got = md.mla_decode_cuda(*args)
    want = mla_ref.mla_decode_online_plain(*args)
    torch.cuda.synchronize()
    what = f"MLA contiguous decode {dtype} at B={b}, S={s}"
    check(torch.equal(md.mla_decode_cuda(*args), got),
          f"{what}: two runs differ")
    wide = [t.repeat((8 // b,) + (1,) * (t.ndim - 1)) for t in args[:5]]
    batched = md.mla_decode_cuda(*wide, MLA_SCALE)
    seq, n = b - 1, int(kv[b - 1].item())
    alone = md.mla_decode_cuda(
        qa[seq:seq + 1].contiguous(), qr[seq:seq + 1].contiguous(),
        ckv[seq:seq + 1, :n].contiguous(), kr[seq:seq + 1, :n].contiguous(),
        kv[seq:seq + 1].contiguous(), MLA_SCALE)
    check(torch.equal(batched[:b], got) and torch.equal(alone[0], got[seq]),
          f"{what}: a sequence's bits depend on the batch")
    rec = {"kernel": "mla_decode_cuda", "dtype": str(dtype), "B": b,
           "H": MLA_H, "r": MLA_R, "Dr": MLA_DR, "S": s,
           "kv_lens": kv.tolist(),
           "max_abs_err": (got - want).abs().max().item(),
           "bitwise_repeat": True, "batch_invariant": True}
    if dtype == torch.bfloat16:
        rec["max_abs_err_split_model"] = (
            got - md.mla_decode_split_plain(*args)).abs().max().item()
    if (b, s) == MLA_CONT_AT:
        rec["continuity"] = "at_b8_s512"
    if timed:
        run = lambda: md.mla_decode_cuda(*args)
        rec["ms"] = cuda_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: mla_ref.mla_decode_online_plain(
            *args))
        sdpa = _mla_sdpa(qa, qr, ckv, kr, kv)
        rec["library_ms"] = cuda_ms(sdpa)
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in ("mla_split_sm90", "mla_merge",
                              "mla_decode_kernel") if k in n), n[:60]): ms
            for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["library_device_ms"] = device_ms(sdpa)
        el = qa.element_size()
        live = int(kv.sum().item())
        nbytes = (live * (MLA_R + MLA_DR) * el + b * MLA_H * (MLA_R + MLA_DR)
                  * el + b * 4 + got.numel() * 4)
        flops = (2.0 * (MLA_R + MLA_DR) + 2.0 * MLA_R) * MLA_H * live
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def prefill192_case(fa, b, s, dtype, gen, dev, timed):
    """The MLA prefill's attention: H = Hkv = 128, head dim 192 (v
    zero-padded from 128 as the model pads it)."""
    import torch
    shape = (b, s, MLA_H, MLA_DQK)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v[..., 128:] = 0
    run = lambda: fa.flash_attention_cuda(q, k, v, causal=True,
                                          softmax_scale=MLA_SCALE)
    got = run()
    want = fa.flash_attention_plain(q, k, v, causal=True,
                                    softmax_scale=MLA_SCALE)
    torch.cuda.synchronize()
    check(torch.equal(run(), got), f"D=192 prefill {dtype} at S={s}: two "
          f"runs differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": MLA_H, "Hkv": MLA_H, "D": MLA_DQK,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(run)
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, softmax_scale=MLA_SCALE))
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        rec["bound_ms"], rec["bound_by"] = _attn_bound(
            b, s, MLA_H, MLA_H, MLA_DQK, 1.0, (q, k, v), (got,))
    return rec


def mla_kernel_phase(fa, md, mla_ref, dev):
    """Both MLA decode kernels and the D=192 prefill against their plain
    versions at deepseek-v2 widths, fp32 (TF32 off) and bf16; timed in
    bf16 at the serve phase's shapes (decode: B=8 over the paged pool;
    prefill: B=2 at the 512 bucket) and the contiguous kernel at the
    generate phase's (B=4, S=1088, every length at S) and at B=8,
    S=512."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(8)
    recs = []
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        bf16 = dtype == torch.bfloat16
        new = [mla_paged_case(md, mla_ref, gen, dev, dtype, timed=bf16),
               mla_paged_case(md, mla_ref, gen, dev, dtype, timed=bf16,
                              mb=128, lens=LONG_LENS)]
        new += [mla_contiguous_case(md, mla_ref, s, gen, dev, dtype,
                                    timed=bf16 and s == 512)
                for s in (200, 512, 2048)]
        new += [mla_contiguous_case(md, mla_ref, MLA_GEN_S, gen, dev, dtype,
                                    timed=bf16 and kind == "full",
                                    b=MLA_GEN_B, lens=lens)
                for kind, lens in MLA_GEN_LENS.items()]
        new += [prefill192_case(fa, 2, s, dtype, gen, dev,
                                timed=bf16 and s == 512)
                for s in (16, 512, 200)]
        for r in new:
            shape = {k: r[k] for k in ("B", "S", "H", "D", "MB") if k in r}
            print(f"[mla-kernels] {r['kernel']} {r['dtype']} {shape}: max "
                  f"abs err {r['max_abs_err']:.3e} (tol {tol:g})"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"SDPA {r['library_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])}, SDPA's "
                     f"{_ms_or_not(r['library_device_ms'])}"
                     if "device_ms" in r else "")
                  + (f" (by launch {r['device_ms_by_launch']})"
                     if r.get("device_ms_by_launch") else "")
                  + (f"; split model {r['max_abs_err_split_model']:.3e} "
                     f"(tol {SPLIT_MODEL_TOL:g})"
                     if "max_abs_err_split_model" in r else ""), flush=True)
            r["tol"] = tol
            if "max_abs_err_split_model" in r:
                r["tol_split_model"] = SPLIT_MODEL_TOL
        bad = [f"{r['kernel']} {r['dtype']}: {r['max_abs_err']}"
               for r in new if not r["max_abs_err"] <= tol]
        bad += [f"{r['kernel']} {r['dtype']} vs the split model: "
                f"{r['max_abs_err_split_model']}" for r in new
                if not r.get("max_abs_err_split_model", 0.0)
                <= SPLIT_MODEL_TOL]
        check(not bad, "MLA kernels vs plain: " + "; ".join(bad))
        recs += new
    return recs


# steps of the 8-layer run traced with torch.profiler, [first, last):
# decode steps 10..12 and prefill group 2 (step and group 0 hold the
# reference check and the first allocations)
MLA_PROFILE = {"decode": (10, 13), "prefill": (2, 3)}


def _kernel_times(prof):
    """Device time of each kernel a profiler saw, summed by name."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


def _profile_rec(prof, wall_us, steps=1):
    """A profiler window's record: its wall time, the device time of its
    kernels and the top 20 kernels by device time."""
    by_name = _kernel_times(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"steps": steps, "window_us": wall_us,
            "device_busy_us": sum(us for _, us in by_name.values()),
            "kernels": [{"name": n[:160], "count": c, "us": us}
                        for n, (c, us) in top[:20]]}


def step_timed_build(build, times, profiles):
    """Wrap ``build``'s prefill and decode steps: host clock between two
    device synchronisations into ``times[kind]`` (and each prefill
    group's bucket into ``times["prefill_bucket"]``); the steps in
    ``MLA_PROFILE`` run under torch.profiler, and ``profiles[kind]`` gets
    the window's wall time, the device time of its kernels and the top
    kernels by device time. Starting and reading the profiler costs host
    seconds outside the steps; they go to ``times["profiler_s"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    def timed(kind, fns):
        lo, hi = MLA_PROFILE[kind]
        prof = {}

        def wrap(fn):
            def run(*args):
                step = len(times[kind])
                if step == lo:
                    t0 = time.monotonic()
                    prof["p"] = tprofile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                    prof["p"].__enter__()
                    prof["t0"] = time.monotonic()
                    times["profiler_s"] += prof["t0"] - t0
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args)
                torch.cuda.synchronize()
                times[kind].append(time.monotonic() - t0)
                if kind == "prefill":
                    times["prefill_bucket"].append(int(args[0].shape[1]))
                if step == hi - 1:
                    t0 = time.monotonic()
                    wall_us = (t0 - prof["t0"]) * 1e6
                    prof["p"].__exit__(None, None, None)
                    profiles[kind] = _profile_rec(prof["p"], wall_us,
                                                  hi - lo)
                    times["profiler_s"] += time.monotonic() - t0
                return out
            return run
        return {key: wrap(fn) for key, fn in fns.items()}

    def build_timed(model, params, layout, *a, **k):
        eng = build(model, params, layout, *a, **k)
        eng.prefill_fns = timed("prefill", eng.prefill_fns)
        eng.decode_fn = timed("decode", {0: eng.decode_fn})[0]
        return eng
    return build_timed


def _serve_mla(cfg, args, build, counters):
    """``serve_config`` on ``cfg``, its engine made by ``build``,
    with every kernel counter zeroed just before and read just after;
    frees the model when done."""
    import gc
    import torch
    from repro_torch.launch import serve as tserve
    orig = tserve.build_engine
    tserve.build_engine = build
    try:
        for f in counters.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats(torch.device("cuda", 0))
        t0 = time.monotonic()
        result = tserve.serve_config(cfg, args)
        seconds = time.monotonic() - t0
        launches = {n: f.launches for n, f in counters.items()}
    finally:
        tserve.build_engine = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches, peak, seconds


def mla_path_phase(fa, md, dev, smi, every):
    """deepseek-v2-236b served through ``serve_config`` at full width, 8
    layers, bf16, attention_impl="kernel" (phase 4's settings): every
    request finishes, launch counts, finite logits; the bf16 kernel vs
    reference difference and the routing choices that differ on the
    first prefill group and first decode step, for the record. The same
    weights then generate through the static path (:func:`mla_generate`,
    with every counter in ``every``). Then the gate: the same serve at
    fp32 (TF32 off) on 2 layers, where the kernel and reference paths
    must agree, and on its weights the static path's gate
    (:func:`mla_generate_gate`)."""
    import gc
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import blocks as tblocks

    full = resolve("deepseek-v2-236b")
    args = tserve.parser().parse_args(MLA_SERVE_ARGV)
    counters = {"flash_attention_cuda": fa.flash_attention_cuda,
                "flash_decode_paged_cuda": fa.flash_decode_paged_cuda,
                "mla_decode_paged_cuda": md.mla_decode_paged_cuda}
    log = {"target": None, "reference": [], "kernel": []}
    orig_router = tblocks._router

    def router(params, x2d, cfg):
        out = orig_router(params, x2d, cfg)
        if log["target"] is not None:
            log[log["target"]].append(out[1].sort(dim=-1).values)
        return out

    def run(cfg, gate, then):
        """The serve, then ``then(model, params)`` on its weights."""
        checks, check_s = {}, [0.0]
        log.update(reference=[], kernel=[])

        def compare(what, got, want):
            g, w = got.float(), want.float()
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            ks, rs = log["kernel"], log["reference"]
            differ = sum(int((k != r).any(dim=-1).sum())
                         for k, r in zip(ks, rs))
            checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                            "argmax_agree": float(
                                (g.argmax(-1) == w.argmax(-1)).float()
                                .mean()),
                            "routed_tokens": sum(len(r) for r in rs),
                            "routing_differs": differ}
            log.update(reference=[], kernel=[])
            tol = f" (tol {MLA_GATE_TOL * scale:.4e})" if gate else ""
            print(f"[mla-path] {cfg.num_layers} layers {cfg.compute_dtype} "
                  f"{what}: kernel vs reference logits max abs err "
                  f"{err:.4e}{tol}, argmax agree "
                  f"{checks[what]['argmax_agree']:.3f}, tokens routed "
                  f"differently {differ} of "
                  f"{checks[what]['routed_tokens']} (over the layers)",
                  flush=True)
            if gate:
                checks[what]["tol"] = MLA_GATE_TOL * scale
                check(err <= MLA_GATE_TOL * scale,
                      f"MLA gate {what}: logits differ by {err}")

        build = reference_checked_build(tserve.build_engine, compare,
                                        check_s, router_log=log,
                                        all_finite=True)
        if not gate:
            build = step_timed_build(build, step_s, profiles)
        held = {}

        def capture(model, params, *a, **k):
            held.update(model=model, params=params)
            return build(model, params, *a, **k)
        result, launches, peak, secs = _serve_mla(cfg, args, capture,
                                                  counters)
        check(len(checks) == 2, f"reference checks ran: {sorted(checks)}")
        t0 = time.monotonic()
        then_out = then(held.pop("model"), held.pop("params"))
        gc.collect()
        torch.cuda.empty_cache()
        then_out["seconds"] = time.monotonic() - t0
        return result, launches, peak, secs, checks, check_s[0], then_out

    step_s = {"prefill": [], "decode": [], "prefill_bucket": [],
              "profiler_s": 0.0}
    profiles = {}

    tblocks._router = router
    try:
        held = torch.cuda.memory_allocated(dev) / 2**30
        print(f"[mla-path] before: {held:.2f} GiB allocated on the card",
              flush=True)
        cfg = dataclasses.replace(full, num_layers=MLA_LAYERS,
                                  attention_impl="kernel")
        result, launches, peak, secs, checks, check_s, generate = run(
            cfg, False, lambda m, p: mla_generate(m, p, every, smi))
        gate_cfg = dataclasses.replace(
            full, num_layers=MLA_GATE_LAYERS, compute_dtype="float32",
            attention_impl="kernel")
        _, gate_launches, gate_peak, gate_secs, gate_checks, _, gen_gate = \
            run(gate_cfg, True, lambda m, p: mla_generate_gate(m, p, every))
    finally:
        tblocks._router = orig_router

    st = result.stats
    reqs = tserve.synthetic_requests(
        args.requests, full.vocab_size, args.rate,
        (args.min_prompt, args.max_prompt), (args.min_gen, args.max_gen),
        args.seed)
    for r in reqs:
        toks = result.tokens[r.rid]
        check(len(toks) == r.max_new_tokens,
              f"MLA request {r.rid}: {len(toks)} of {r.max_new_tokens}")
        check(all(0 <= t < full.vocab_size for t in toks),
              f"MLA request {r.rid}: token id out of vocab")
    expect = {"flash_attention_cuda": MLA_LAYERS * st["prefill_groups"],
              "flash_decode_paged_cuda": 0,
              "mla_decode_paged_cuda": MLA_LAYERS * st["decode_steps"]}
    check(launches == expect, f"MLA launches {launches} != {expect}")
    check(st["kernel_launches"] == launches,
          f"engine stats {st['kernel_launches']} != counters {launches}")
    gate_st = gate_launches["mla_decode_paged_cuda"]
    check(gate_st > 0 and gate_launches["flash_attention_cuda"] > 0,
          f"the fp32 gate did not run the kernels: {gate_launches}")
    wall = st["wall_seconds"] - check_s - step_s["profiler_s"]
    out = {"layers": MLA_LAYERS, "stats": st, "launches": launches,
           "expected_launches": expect, "bf16_checks": checks,
           "check_seconds": check_s, "seconds": secs,
           "profiler_seconds": step_s["profiler_s"],
           "tokens_per_s_wall": st["total_tokens"] / wall,
           "ms_per_decode_step_median": statistics.median(
               step_s["decode"][1:]) * 1e3,
           "prefill_group_ms": [(bkt, t * 1e3) for bkt, t in zip(
               step_s["prefill_bucket"], step_s["prefill"])],
           "profiles": profiles,
           "peak_memory_gib": peak, "weights_gib": tserve.weight_bytes(
               cfg) / 2**30,
           "gate": {"layers": MLA_GATE_LAYERS, "checks": gate_checks,
                    "launches": gate_launches, "peak_memory_gib": gate_peak,
                    "seconds": gate_secs},
           "generate": {**generate, "gate": gen_gate}}
    print(f"[mla-path] deepseek-v2-236b, {MLA_LAYERS} of 60 layers at full "
          f"width, bf16: {st['requests']} requests, {st['total_tokens']} "
          f"tokens in {wall:.3f} s of wall (reference checks and the "
          f"profiler's start and stop excluded): "
          f"{out['tokens_per_s_wall']:.1f} tok/s, {st['decode_steps']} decode "
          f"steps (median {out['ms_per_decode_step_median']:.2f} ms, "
          f"reference check excluded), {st['prefill_groups']} prefill "
          f"groups, peak memory "
          f"{peak:.2f} GiB (weights {out['weights_gib']:.2f} GiB), launches "
          f"{launches}; fp32 gate on {MLA_GATE_LAYERS} layers: peak "
          f"{gate_peak:.2f} GiB [{smi}]", flush=True)
    print("[mla-path] prefill groups (bucket, ms; group 0 holds the "
          "reference check): " + ", ".join(
              f"({bkt}, {ms:.1f})" for bkt, ms in out["prefill_group_ms"]),
          flush=True)
    for kind, prof in profiles.items():
        busy, win = prof["device_busy_us"], prof["window_us"]
        print(f"[mla-path] torch.profiler over {prof['steps']} {kind} "
              f"step(s): kernels {busy / 1e3:.3f} ms of device time in "
              f"{win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof["kernels"][:10]), flush=True)
    return out


# the MLA generate phase on phase 9's weights: batch, prompt, generated
# tokens (8 layers, bf16); its profiled decode steps [first, last); the
# fp32 gate's prompt and tokens (phase 9's 2-layer gate weights)
MLA_GEN_RUN = (MLA_GEN_B, 1024, MLA_GEN_S - 1024)
MLA_GEN_PROFILE = (10, 13)
MLA_GEN_GATE = (300, 8)


def mla_generate(model, params, counters, smi):
    """deepseek-v2's 8-layer cut at full width on phase 9's bf16 weights
    (attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``: the
    contiguous MLA decode launches once a layer a decode step, the D=192
    prefill once a layer, every other kernel never; finite logits;
    timings; a profile of three decode steps and of a second prefill."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = model.cfg
    batch, plen, ngen = MLA_GEN_RUN
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    profiler = lambda: tprofile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0, "profiler": profiler,
              "profile": {"lo": MLA_GEN_PROFILE[0],
                          "hi": MLA_GEN_PROFILE[1]}}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                 ngen, counters, record)
    expect = {n: 0 for n in counters}
    expect.update(mla_decode_cuda=cfg.num_layers * (ngen - 1),
                  flash_attention_cuda=cfg.num_layers)
    check(launches == expect, f"MLA generate launches {launches} != "
          f"{expect}")
    check(toks.shape == (batch, ngen), f"MLA generate tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "MLA generate: token id out of vocab")
    check(record["finite"], "MLA generate: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"MLA generate steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = MLA_GEN_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    with profiler() as prof:              # the prefill once more, traced
        t0 = time.monotonic()
        model.prefill(params, torch.as_tensor(prompts, device=model.device),
                      max_len=plen + ngen)
        torch.cuda.synchronize()
        pre_wall = (time.monotonic() - t0) * 1e6
    record["profiles"]["prefill"] = _profile_rec(prof, pre_wall)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds_generate": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[mla-generate] deepseek-v2-236b, {cfg.num_layers} of 60 layers "
          f"at full width, bf16, static_generate: batch {batch}, prompt "
          f"{plen}, {ngen} tokens: prefill {out['prefill_ms']:.2f} ms, "
          f"decode step median {out['decode_step_ms_median']:.2f} ms "
          f"(profiled steps excluded), {out['tokens_per_s_wall']:.1f} tok/s "
          f"of wall (the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB, launches {launches} [{smi}]", flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[mla-generate] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    return out


def mla_generate_gate(kern, params, counters):
    """The static path's fp32 gate (TF32 off) on phase 9's 2-layer gate
    weights, prompt 300, 8 tokens: the kernel path and the reference path
    give identical greedy tokens and every step's logits agree within
    ``MLA_GATE_TOL`` of the largest reference logit; one sequence through
    the paged engine gives the static path's tokens."""
    import numpy as np
    from repro_torch.launch import serve as tserve
    from repro_torch.models.kvcache import PagedLayout
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request
    cfg = kern.cfg
    plen, ngen = MLA_GEN_GATE
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (MLA_GEN_B, plen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(cfg, attention_impl="reference"),
            kern.device)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        toks, launched, _, peak = _counted_generate(model, params, prompts,
                                                    ngen, counters, rec)
        check(rec["finite"], f"MLA generate gate {name}: non-finite logits")
        runs[name] = (toks, rec["logits"], launched, peak)
    want = {"kernel": (cfg.num_layers * (ngen - 1), cfg.num_layers),
            "reference": (0, 0)}
    got = {n: (r[2]["mla_decode_cuda"], r[2]["flash_attention_cuda"])
           for n, r in runs.items()}
    check(got == want and not any(
        r[2][k] for r in runs.values() for k in r[2]
        if k not in ("mla_decode_cuda", "flash_attention_cuda")),
          f"MLA generate gate launches: {[r[2] for r in runs.values()]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": MLA_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    # one sequence alone: the MoE's eval capacity, and so which tokens
    # it drops, depends on the batch
    single = tserve.static_generate(kern, params, prompts[:1], ngen)
    mbs = -(-(plen + ngen) // 16)
    eng = tserve.build_engine(
        kern, params, PagedLayout(block_size=16, num_blocks=mbs,
                                  max_blocks_per_seq=mbs),
        slots=1, prefill_batch=1, pod_speeds=[1.0])
    paged = eng.run([Request(rid=0, prompt=tuple(int(t) for t in prompts[0]),
                             max_new_tokens=ngen, arrival=0.0)]).tokens[0]
    same_paged = [int(t) for t in single[0]] == list(paged)
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[mla-generate] fp32 gate, {cfg.num_layers} layers, prompt "
          f"{plen}, {ngen} tokens: greedy tokens identical {same}, equal to "
          f"the paged engine's on one sequence {same_paged}; logits max abs "
          f"err by step " + ", ".join(f"{s_['max_abs_err']:.3e}"
                                      for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "MLA generate gate: kernel and reference tokens differ")
    check(same_paged, "MLA generate gate: the static path and the paged "
          "engine differ on one sequence")
    check(len(steps) == ngen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"MLA generate gate: logits differ beyond {MLA_GATE_TOL}")
    return {"layers": cfg.num_layers, "prompt": plen, "generated": ngen,
            "tokens_identical": same, "paged_engine_identical": same_paged,
            "steps": steps, "launches": {n: r[2] for n, r in runs.items()},
            "peak_memory_gib": runs["kernel"][3]}


# --------------------------------------------------------------------------
# zamba2 (Mamba2 hybrid): SSD kernel phase and generate path phase
# --------------------------------------------------------------------------

ZAMBA_P, ZAMBA_N = 64, 64           # SSM head dim P and state dim N
ZAMBA_HEADS, ZAMBA_DH = 32, 80      # the shared attention block
ZAMBA_RUN = (4, 1024, 64)           # batch, prompt, generated tokens
ZAMBA_GATE = (6, 300, 8)            # the fp32 gate: layers, prompt, tokens
# kernel path vs reference path logits of the fp32 gate (TF32 off): they
# differ in the SSD scan's and the prefill attention's summation order.
# Relative to the largest reference logit of the step (at least 1).
ZAMBA_GATE_TOL = 1e-3
# (B, S, H, G, chunk, with D): the path's shape first (zamba2's prefill:
# 80 heads, one group, chunk 256), then a ragged tail, S shorter than the
# chunk, two group layouts, and no D
SSD_CASES = [(4, 1024, 80, 1, 256, True), (4, 1000, 80, 1, 256, True),
             (2, 100, 80, 1, 256, True), (2, 512, 8, 2, 256, True),
             (2, 300, 6, 3, 128, True), (2, 700, 16, 1, 256, False)]
# decode steps of the 64-token run traced with torch.profiler, [first,
# last); the median decode step leaves them out
ZAMBA_PROFILE = (10, 13)


def ssd_flops_bytes(b, s, h, g, chunk, tensors):
    """The SSD scan's operations and bytes for these shapes: per (b, h)
    and chunk of q rows, C B^T and its product with dt x on the causal
    half (q (q + 1) / 2 pairs, N and P multiply-adds each), the carried
    state's term and the state update (q N P each); every input read
    once and every output written once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (ZAMBA_N + ZAMBA_P)
                           + 2 * s * ZAMBA_N * ZAMBA_P)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def ssd_case(sk, b, s, h, g, chunk, use_d, dtype, gen, dev, timed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = r(b, s, h, ZAMBA_P).to(dtype)
    dt = F.softplus(r(b, s, h) - 2.0)
    A = -torch.exp(r(h) * 0.5)
    Bm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    Cm = (r(b, s, g, ZAMBA_N) * 0.3).to(dtype)
    D = r(h) if use_d else None
    args = (x, dt, A, Bm, Cm, D)
    y, fin = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    yw, fw = sk.ssd_scan_plain(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    check(y.dtype == dtype and fin.dtype == torch.float32
          and y.shape == x.shape and fin.shape == (b, h, ZAMBA_P, ZAMBA_N),
          f"SSD kernel: y {y.dtype} {tuple(y.shape)}, final {fin.dtype} "
          f"{tuple(fin.shape)}")
    y2, fin2 = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    check(torch.equal(y2, y) and torch.equal(fin2, fin),
          f"SSD kernel {dtype} at {(b, s, h, g, chunk)}: two runs differ")
    rec = {"kernel": "ssd_scan_cuda", "dtype": str(dtype), "B": b, "S": s,
           "H": h, "G": g, "P": ZAMBA_P, "N": ZAMBA_N, "chunk": chunk,
           "with_D": use_d,
           "rel_l2": max(rel_l2(y, yw), rel_l2(fin, fw)),
           "rel_l2_y": rel_l2(y, yw), "rel_l2_final": rel_l2(fin, fw),
           "max_abs_err": max((y.float() - yw.float()).abs().max().item(),
                              (fin - fw).abs().max().item()),
           "bitwise_repeat": True}
    if timed:
        run = lambda: sk.ssd_scan_cuda(*args, chunk_size=chunk)
        rec["ms"] = cuda_ms(run)
        # the device time of each launch of a call (bf16: chunk states,
        # state passing, chunk scan), and their sum
        by_kernel = device_ms_by_kernel(run)
        rec["device_ms_by_launch"] = by_kernel and {
            next((k for k in ("ssd_chunk_state_sm90", "ssd_state_pass",
                              "ssd_chunk_scan_sm90", "ssd_scan_kernel")
                  if k in n), n[:60]): ms for n, ms in by_kernel.items()}
        rec["device_ms"] = by_kernel and sum(by_kernel.values())
        rec["plain_ms"] = cuda_ms(lambda: sk.ssd_scan_plain(
            *args, chunk_size=chunk))
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = ssd_flops_bytes(
            b, s, h, g, chunk, [t for t in args if t is not None]
            + [y, fin])
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def prefill80_case(fa, b, s, h, hkv, dtype, gen, dev, timed):
    """The shared attention block's prefill: head dim 80, causal."""
    import torch
    from repro_torch.kernels.parity import rel_l2
    q = torch.randn((b, s, h, ZAMBA_DH), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, ZAMBA_DH), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((b, s, hkv, ZAMBA_DH), generator=gen,
                    device=dev).to(dtype)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(fa.flash_attention_cuda(q, k, v, causal=True), got),
          f"D=80 prefill {dtype} at S={s}: two runs differ")
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype), "B": b,
           "S": s, "H": h, "Hkv": hkv, "D": ZAMBA_DH,
           "rel_l2": rel_l2(got, want),
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "bitwise_repeat": True}
    if timed:
        rec["ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
        qt, kt, vt = _sdpa_layout(q, k, v)
        rec["library_ms"] = cuda_ms(lambda: _sdpa(qt, kt, vt, True))
        rec["bound_ms"], rec["bound_by"] = _attn_bound(
            b, s, h, hkv, ZAMBA_DH, 1.0, (q, k, v), (got,))
    return rec


def zamba_kernel_phase(fa, sk, dev, smi):
    """The SSD kernel and the D=80 prefill against their plain versions,
    fp32 (TF32 off) and bf16, by relative L2 (``parity.RTOL``); timed in
    bf16 at the generate phase's shapes (B=4, S=1024)."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, _ = ZAMBA_RUN
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        new = [ssd_case(sk, *c, dtype, gen, dev, timed=bf16 and i == 0)
               for i, c in enumerate(SSD_CASES)]
        new += [prefill80_case(fa, bb, ss, h, hkv, dtype, gen, dev,
                               timed=bf16 and i == 0)
                for i, (bb, ss, h, hkv) in enumerate(
                    [(b, s, ZAMBA_HEADS, ZAMBA_HEADS), (2, 200, 8, 2),
                     (1, 16, ZAMBA_HEADS, ZAMBA_HEADS)])]
        for r in new:
            r["tol"] = RTOL[(r["kernel"], dtype)]
            shape = {k: r[k] for k in ("B", "S", "H", "G", "Hkv", "D",
                                       "chunk", "with_D") if k in r}
            print(f"[zamba-kernels] {r['kernel']} {r['dtype']} {shape}: "
                  f"rel L2 {r['rel_l2']:.3e} (tol {r['tol']:g}), max abs "
                  f"err {r['max_abs_err']:.3e}"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"library "
                     + ("none" if r["library_ms"] is None
                        else f"{r['library_ms']:.4f} ms (SDPA)")
                     + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']}) "
                       f"[{smi}]" if "ms" in r else "")
                  + (f"; device time {_ms_or_not(r['device_ms'])} by "
                     f"launch {r['device_ms_by_launch']}"
                     if "device_ms_by_launch" in r else ""), flush=True)
        bad = [f"{r['kernel']} {r['dtype']}: {r['rel_l2']}"
               for r in new if not r["rel_l2"] <= r["tol"]]
        check(not bad, "zamba kernels vs plain: " + "; ".join(bad))
        recs += new
    return recs


def _wrap_steps(model, record):
    """Wrap ``model.prefill`` / ``model.decode`` (what the static steps
    call): each call between two device syncs on the host clock, its
    logits kept (``record["logits"]``) when asked and checked finite."""
    import torch
    orig = {"prefill": model.prefill, "decode": model.decode}

    def wrap(kind):
        def run(*args, **kwargs):
            step = len(record[kind])
            prof = record.get("profile") if kind == "decode" else None
            if prof is not None and step == prof["lo"]:
                t0 = time.monotonic()
                prof["p"] = record["profiler"]()
                prof["p"].__enter__()
                prof["t0"] = time.monotonic()
                record["profiler_s"] += prof["t0"] - t0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cache = orig[kind](*args, **kwargs)
            torch.cuda.synchronize()
            record[kind].append(time.monotonic() - t0)
            if prof is not None and step == prof["hi"] - 1:
                t0 = time.monotonic()
                wall_us = (t0 - prof["t0"]) * 1e6
                prof["p"].__exit__(None, None, None)
                record["profiles"]["decode"] = _profile_rec(
                    prof["p"], wall_us, prof["hi"] - prof["lo"])
                record["profiler_s"] += time.monotonic() - t0
            if "logits" in record:
                record["logits"].append(logits.float().cpu())
            record["finite"] &= bool(torch.isfinite(logits).all())
            return logits, cache
        return run
    model.prefill = wrap("prefill")
    model.decode = wrap("decode")


def _counted_generate(model, params, prompts, gen, counters, record):
    """``static_generate`` with every kernel counter zeroed just before
    and read just after."""
    import torch
    from repro_torch.launch import serve as tserve
    _wrap_steps(model, record)
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    toks = tserve.static_generate(model, params, prompts, gen)
    seconds = time.monotonic() - t0
    launches = {n: f.launches for n, f in counters.items()}
    return toks, launches, seconds, torch.cuda.max_memory_allocated() / 2**30


def zamba_path_phase(fa, md, sk, dev, smi):
    """zamba2-2.7b at full width and depth (bf16, seed 0,
    attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``:
    exact launch counts, finite logits, timings, a profile of three
    decode steps. Then the fp32 gate on 6 layers: kernel path against
    reference path, identical greedy tokens and logits within
    ``ZAMBA_GATE_TOL``."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import build_model

    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[zamba-path] before: {held:.2f} GiB allocated on the card",
          flush=True)
    full = resolve("zamba2-2.7b")
    counters = {"ssd_scan_cuda": sk.ssd_scan_cuda,
                "flash_attention_cuda": fa.flash_attention_cuda,
                "flash_decode_paged_cuda": fa.flash_decode_paged_cuda,
                "mla_decode_paged_cuda": md.mla_decode_paged_cuda,
                "mla_decode_cuda": md.mla_decode_cuda}
    batch, plen, ngen = ZAMBA_RUN
    cfg = dataclasses.replace(full, attention_impl="kernel")
    model = build_model(cfg, dev)
    params = tr.cast_params(model.init_params(0), torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    weights = sum(t.numel() * t.element_size()
                  for t in tr.tree_leaves(params)) / 2**30
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0,
              "profile": {"lo": ZAMBA_PROFILE[0], "hi": ZAMBA_PROFILE[1]},
              "profiler": lambda: tprofile(activities=[
                  ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                 ngen, counters, record)
    groups = cfg.num_layers // cfg.hybrid.attn_every
    expect = {"ssd_scan_cuda": cfg.num_layers,
              "flash_attention_cuda": groups,
              "flash_decode_paged_cuda": 0, "mla_decode_paged_cuda": 0,
              "mla_decode_cuda": 0}
    check(launches == expect, f"zamba launches {launches} != {expect}")
    check(toks.shape == (batch, ngen), f"zamba tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "zamba token id out of vocab")
    check(record["finite"], "zamba: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"zamba steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = ZAMBA_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    # the prefill once more under the profiler (after the counted run)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      max_len=plen + ngen)
        torch.cuda.synchronize()
        pre_wall = (time.monotonic() - t0) * 1e6
    record["profiles"]["prefill"] = _profile_rec(prof, pre_wall)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak, "weights_gib": weights,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[zamba-path] zamba2-2.7b, {cfg.num_layers} layers at full width, "
          f"bf16, batch {batch}, prompt {plen}, {ngen} tokens: prefill "
          f"{out['prefill_ms']:.2f} ms, decode step median "
          f"{out['decode_step_ms_median']:.2f} ms (profiled steps "
          f"excluded), {out['tokens_per_s_wall']:.1f} tok/s of wall "
          f"(the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB), launches "
          f"{launches} [{smi}]", flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[zamba-path] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    del model, params, prof
    gc.collect()
    torch.cuda.empty_cache()

    # the fp32 gate: 6 layers (one group), prompt 300 (a full chunk and
    # a ragged tail), 8 tokens; kernel path against reference path
    layers, gplen, ggen = ZAMBA_GATE
    gcfg = dataclasses.replace(full, num_layers=layers,
                               compute_dtype="float32",
                               attention_impl="kernel")
    kern = build_model(gcfg, dev)
    gparams = kern.init_params(0)
    gprompts = np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (batch, gplen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(gcfg, attention_impl="reference"), dev)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        gtoks, glaunch, _, gpeak = _counted_generate(
            model, gparams, gprompts, ggen, counters, rec)
        check(rec["finite"], f"zamba gate {name}: non-finite logits")
        runs[name] = (gtoks, rec["logits"], glaunch, gpeak)
    check(runs["kernel"][2]["ssd_scan_cuda"] == layers
          and runs["kernel"][2]["flash_attention_cuda"] == 1
          and runs["reference"][2]["ssd_scan_cuda"] == 0
          and runs["reference"][2]["flash_attention_cuda"] == 0,
          f"zamba gate launches: kernel {runs['kernel'][2]}, reference "
          f"{runs['reference'][2]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": ZAMBA_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[zamba-path] fp32 gate, {layers} layers, prompt {gplen}, {ggen} "
          f"tokens: greedy tokens identical {same}; logits max abs err by "
          f"step " + ", ".join(f"{s_['max_abs_err']:.3e}" for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "zamba gate: kernel and reference tokens differ")
    check(len(steps) == ggen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"zamba gate: logits differ beyond {ZAMBA_GATE_TOL}")
    out["gate"] = {"layers": layers, "prompt": gplen, "generated": ggen,
                   "tokens_identical": same, "steps": steps,
                   "launches": {n: r[2] for n, r in runs.items()},
                   "peak_memory_gib": runs["kernel"][3]}
    del kern, model, gparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# xLSTM: mLSTM kernel phase and generate path phase
# --------------------------------------------------------------------------

XLSTM_RUN = (4, 1024, 64)           # batch, prompt, generated tokens
XLSTM_GATE = (300, 8)               # the fp32 gate at full depth: prompt,
                                    # tokens
# kernel path vs reference path logits of the fp32 gate (TF32 off): they
# differ in the mLSTM scan's summation order only. Relative to the
# largest reference logit of the step (at least 1).
XLSTM_GATE_TOL = 1e-3
# (B, S, H, dk, dv, chunk): the path's shape first (xlstm-125m's prefill:
# 4 heads of 384, chunk 256), then a ragged tail, S shorter than the
# chunk, the Pallas wrapper's chunk of 128, and the smoke widths
MLSTM_CASES = [(4, 1024, 4, 384, 384, 256), (4, 1000, 4, 384, 384, 256),
               (2, 100, 4, 384, 384, 256), (2, 300, 4, 384, 384, 128),
               (2, 300, 2, 64, 64, 256)]
# decode steps of the 64-token run traced with torch.profiler, [first,
# last); the median decode step leaves them out
XLSTM_PROFILE = (10, 13)


def mlstm_flops_bytes(b, s, h, dk, dv, chunk, tensors):
    """The mLSTM scan's operations and bytes for these shapes: per (b, h)
    and chunk of q rows, q k^T and the weighted sum of v on the causal
    half (q (q + 1) / 2 pairs, dk and dv multiply-adds each); q C and
    q.n for every row after the first chunk (the state is zero before
    it); the state update C and n over every row; every input read once
    and every output written once."""
    q_full = min(chunk, s)
    rows = [min(q_full, s - t0) for t0 in range(0, s, q_full)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    flops = 2.0 * b * h * (pairs * (dk + dv)
                           + (s - rows[0]) * dk * (dv + 1)
                           + s * dk * (dv + 1))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops, nbytes


def mlstm_case(mk, b, s, h, dk, dv, chunk, dtype, gen, dev, timed):
    import torch
    from repro_torch.kernels.parity import rel_l2

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = (r(b, s, h, dk).to(dtype), r(b, s, h, dk).to(dtype),
               r(b, s, h, dv).to(dtype))
    # the gate pre-activations as xlstm-125m's init sets them up: i~
    # about N(0, 1), f~ shifted by its bias of 3..6
    i_pre, f_pre = r(b, s, h), r(b, s, h) + 3.0
    args = (q, k, v, i_pre, f_pre)
    hout, state = mk.mlstm_scan_cuda(*args, chunk_size=chunk)
    hw, state_w = mk.mlstm_scan_plain(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    check(hout.dtype == dtype and hout.shape == (b, s, h, dv)
          and tuple(x.shape for x in state) == ((b, h, dk, dv), (b, h, dk),
                                                (b, h))
          and all(x.dtype == torch.float32 for x in state),
          f"mLSTM kernel: h {hout.dtype} {tuple(hout.shape)}, state "
          f"{[(x.dtype, tuple(x.shape)) for x in state]}")
    outs = list(zip(("h", "C", "n", "m"), (hout,) + state, (hw,) + state_w))
    errs = {name: rel_l2(g, w) for name, g, w in outs}
    rec = {"kernel": "mlstm_scan_cuda", "dtype": str(dtype), "B": b, "S": s,
           "H": h, "dk": dk, "dv": dv, "chunk": chunk,
           "rel_l2": max(errs.values()), "rel_l2_by_output": errs,
           "max_abs_err": max((g.float() - w.float()).abs().max().item()
                              for _, g, w in outs)}
    if timed:
        rec["ms"] = cuda_ms(lambda: mk.mlstm_scan_cuda(*args,
                                                       chunk_size=chunk))
        rec["plain_ms"] = cuda_ms(lambda: mk.mlstm_scan_plain(
            *args, chunk_size=chunk))
        rec["library_ms"] = None        # no PyTorch call computes it
        flops, nbytes = mlstm_flops_bytes(b, s, h, dk, dv, chunk,
                                          list(args) + [hout, *state])
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def xlstm_kernel_phase(mk, dev, smi):
    """The mLSTM kernel against its plain version, fp32 (TF32 off) and
    bf16, by relative L2 (``parity.RTOL``; the largest over h, C, n and
    m); every case printed before any is checked; timed in bf16 at the
    generate phase's shape (B=4, S=1024)."""
    import torch
    from repro_torch.kernels.parity import RTOL
    gen = torch.Generator(device=dev).manual_seed(12)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        recs += [mlstm_case(mk, *c, dtype, gen, dev, timed=bf16 and i == 0)
                 for i, c in enumerate(MLSTM_CASES)]
    for r in recs:
        r["tol"] = RTOL[(r["kernel"], {"torch.float32": torch.float32,
                                       "torch.bfloat16": torch.bfloat16}[
                                           r["dtype"]])]
        shape = {k: r[k] for k in ("B", "S", "H", "dk", "dv", "chunk")}
        print(f"[xlstm-kernels] {r['kernel']} {r['dtype']} {shape}: rel L2 "
              f"{r['rel_l2']:.3e} (tol {r['tol']:g}; "
              + ", ".join(f"{k} {v:.3e}"
                          for k, v in r["rel_l2_by_output"].items())
              + f"), max abs err {r['max_abs_err']:.3e}"
              + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"library none, bound {r['bound_ms']:.6f} ms "
                 f"({r['bound_by']}) [{smi}]" if "ms" in r else ""),
              flush=True)
    bad = [f"{r['kernel']} {r['dtype']} S={r['S']}: {r['rel_l2']}"
           for r in recs if not r["rel_l2"] <= r["tol"]]
    check(not bad, "mLSTM kernel vs plain: " + "; ".join(bad))
    return recs


def _block_timed_prefill(model, params, prompts, max_len):
    """One prefill under torch.profiler with every mLSTM and sLSTM block
    between two device syncs on the host clock: the blocks' wall time by
    kind, and the window's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.models import transformer as tr
    orig = {"mlstm": tr.mlstm_block, "slstm": tr.slstm_block}
    wall = {"mlstm": 0.0, "slstm": 0.0}

    def timed(kind):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = orig[kind](*args, **kwargs)
            torch.cuda.synchronize()
            wall[kind] += time.monotonic() - t0
            return out
        return run
    tr.mlstm_block, tr.slstm_block = timed("mlstm"), timed("slstm")
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.prefill(params,
                          torch.as_tensor(prompts, device=model.device),
                          max_len=max_len)
            torch.cuda.synchronize()
            pre_wall = time.monotonic() - t0
    finally:
        tr.mlstm_block, tr.slstm_block = orig["mlstm"], orig["slstm"]
    rec = _profile_rec(prof, pre_wall * 1e6)
    rec["block_wall_ms"] = {k: v * 1e3 for k, v in wall.items()}
    return rec


def xlstm_path_phase(counters, dev, smi):
    """xlstm-125m at full width and depth (bf16, seed 0,
    attention_impl="kernel") generates 64 tokens after a 1024-token
    prompt for 4 sequences through ``launch.serve.static_generate``:
    exact launch counts, finite logits, timings, a profile of three
    decode steps and of a prefill. Then the fp32 gate at full depth:
    kernel path against reference path, identical greedy tokens and
    logits within ``XLSTM_GATE_TOL``."""
    import gc
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs.base import resolve
    from repro_torch.models import transformer as tr
    from repro_torch.models.model import build_model

    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[xlstm-path] before: {held:.2f} GiB allocated on the card",
          flush=True)
    full = resolve("xlstm-125m")
    pairs = full.num_layers // 2
    batch, plen, ngen = XLSTM_RUN
    cfg = dataclasses.replace(full, attention_impl="kernel")
    model = build_model(cfg, dev)
    params = tr.cast_params(model.init_params(0), torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    weights = sum(t.numel() * t.element_size()
                  for t in tr.tree_leaves(params)) / 2**30
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    record = {"prefill": [], "decode": [], "finite": True, "profiles": {},
              "profiler_s": 0.0,
              "profile": {"lo": XLSTM_PROFILE[0], "hi": XLSTM_PROFILE[1]},
              "profiler": lambda: tprofile(activities=[
                  ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    toks, launches, secs, peak = _counted_generate(model, params, prompts,
                                                   ngen, counters, record)
    expect = {n: (pairs if n == "mlstm_scan_cuda" else 0) for n in counters}
    check(launches == expect, f"xlstm launches {launches} != {expect}")
    check(toks.shape == (batch, ngen), f"xlstm tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "xlstm token id out of vocab")
    check(record["finite"], "xlstm: non-finite logits")
    check(len(record["prefill"]) == 1 and len(record["decode"]) == ngen - 1,
          f"xlstm steps {len(record['prefill'])} prefill, "
          f"{len(record['decode'])} decode")
    lo, hi = XLSTM_PROFILE
    decode_s = record["decode"][:lo] + record["decode"][hi:]
    wall = secs - record["profiler_s"]
    # the prefill once more under the profiler (after the counted run),
    # its blocks timed by kind
    record["profiles"]["prefill"] = _block_timed_prefill(
        model, params, prompts, plen + ngen)
    out = {"layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "generated": ngen, "launches": launches,
           "expected_launches": expect, "seconds": secs,
           "profiler_seconds": record["profiler_s"],
           "prefill_ms": record["prefill"][0] * 1e3,
           "decode_step_ms_median": statistics.median(decode_s) * 1e3,
           "decode_step_ms": [t * 1e3 for t in record["decode"]],
           "tokens_per_s_wall": batch * ngen / wall,
           "peak_memory_gib": peak, "weights_gib": weights,
           "profiles": record["profiles"], "tokens_head": toks[:, :8].tolist()}
    print(f"[xlstm-path] xlstm-125m, {cfg.num_layers} layers at full width, "
          f"bf16, batch {batch}, prompt {plen}, {ngen} tokens: prefill "
          f"{out['prefill_ms']:.2f} ms, decode step median "
          f"{out['decode_step_ms_median']:.2f} ms (profiled steps "
          f"excluded), {out['tokens_per_s_wall']:.1f} tok/s of wall "
          f"(the profiler's start and stop excluded), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB), launches "
          f"{launches} [{smi}]", flush=True)
    blocks = record["profiles"]["prefill"]["block_wall_ms"]
    print(f"[xlstm-path] profiled prefill, blocks between syncs: mLSTM "
          f"{blocks['mlstm']:.2f} ms, sLSTM {blocks['slstm']:.2f} ms of "
          f"{record['profiles']['prefill']['window_us'] / 1e3:.2f} ms",
          flush=True)
    for kind, prof_rec in record["profiles"].items():
        busy, win = prof_rec["device_busy_us"], prof_rec["window_us"]
        print(f"[xlstm-path] torch.profiler over {prof_rec['steps']} "
              f"{kind} step(s): kernels {busy / 1e3:.3f} ms of device time "
              f"in {win / 1e3:.3f} ms of wall; by kernel: " + "; ".join(
                  f"{k['name'][:48]} x{k['count']} {k['us'] / 1e3:.3f} ms"
                  for k in prof_rec["kernels"][:10]), flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the fp32 gate at full depth: prompt 300 (a full chunk and a ragged
    # tail), 8 tokens; kernel path against reference path
    gplen, ggen = XLSTM_GATE
    gcfg = dataclasses.replace(full, compute_dtype="float32",
                               attention_impl="kernel")
    kern = build_model(gcfg, dev)
    gparams = kern.init_params(0)
    gprompts = np.random.default_rng(1).integers(
        0, gcfg.vocab_size, (batch, gplen)).astype(np.int32)
    runs = {}
    for name in ("kernel", "reference"):
        model = kern if name == "kernel" else build_model(
            dataclasses.replace(gcfg, attention_impl="reference"), dev)
        rec = {"prefill": [], "decode": [], "finite": True, "logits": []}
        gtoks, glaunch, _, gpeak = _counted_generate(
            model, gparams, gprompts, ggen, counters, rec)
        check(rec["finite"], f"xlstm gate {name}: non-finite logits")
        runs[name] = (gtoks, rec["logits"], glaunch, gpeak)
    check(runs["kernel"][2]["mlstm_scan_cuda"] == pairs
          and runs["reference"][2]["mlstm_scan_cuda"] == 0,
          f"xlstm gate launches: kernel {runs['kernel'][2]}, reference "
          f"{runs['reference'][2]}")
    steps = []
    for i, (g, w) in enumerate(zip(runs["kernel"][1], runs["reference"][1])):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        steps.append({"step": i, "max_abs_err": err, "ref_max_abs": scale,
                      "tol": XLSTM_GATE_TOL * scale})
    same = bool(np.array_equal(runs["kernel"][0], runs["reference"][0]))
    worst = max(s_["max_abs_err"] / s_["tol"] for s_ in steps)
    print(f"[xlstm-path] fp32 gate, {gcfg.num_layers} layers, prompt "
          f"{gplen}, {ggen} tokens: greedy tokens identical {same}; logits "
          f"max abs err by step "
          + ", ".join(f"{s_['max_abs_err']:.3e}" for s_ in steps)
          + f" (largest err/tol {worst:.3f}); peak "
          f"{runs['kernel'][3]:.2f} GiB", flush=True)
    check(same, "xlstm gate: kernel and reference tokens differ")
    check(len(steps) == ggen and all(s_["max_abs_err"] <= s_["tol"]
                                     for s_ in steps),
          f"xlstm gate: logits differ beyond {XLSTM_GATE_TOL}")
    out["gate"] = {"layers": gcfg.num_layers, "prompt": gplen,
                   "generated": ggen, "tokens_identical": same,
                   "steps": steps,
                   "launches": {n: r[2] for n, r in runs.items()},
                   "peak_memory_gib": runs["kernel"][3]}
    del kern, model, gparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _finite(x):
    return x == x and abs(x) != float("inf")


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of "
                                 "repro_torch (no arguments: one card)")
    ap.add_argument("--cards", type=int, default=1,
                    help="above 1: only the multi-rank path with one card "
                         "per rank (NCCL), on 2 and 4 ranks")
    opts = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if opts.cards > 1:
        cards_main(dev, smi, opts.cards)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from repro_torch.kernels import _build
    from repro_torch.kernels.cross_entropy import cross_entropy as ce
    from repro_torch.kernels.cross_entropy import ref as ce_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mla_decode import mla_decode as md
    from repro_torch.kernels.mla_decode import ref as mla_ref
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mk
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    t0 = time.monotonic()
    lib_path = _build.build(verbose=True)
    _build.load()
    build_s = time.monotonic() - t0
    print(f"[build] {lib_path.name} from "
          f"{[s.name for s in _build.sources()]} and "
          f"{[s.name for s in _build.headers()]} in {build_s:.1f} s",
          flush=True)
    t0 = time.monotonic()
    sm90 = sm90_report(_build, _build.load(), fa, ce, md, sk)

    phases = {"build": build_s, "sm90_report": time.monotonic() - t0}
    t0 = time.monotonic()
    recs = kernel_phase(fa, dev)
    phases["serve_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    rows_mb, seq = TRAIN_MICROBATCH
    recs += train_kernel_phase(fa, ce, ce_ref, dev, rows_mb, seq)
    phases["train_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    path = path_phase(fa, md, dev)
    phases["serve_path"] = time.monotonic() - t0
    t0 = time.monotonic()
    train = train_phase(fa, ce, dev)
    phases["train_path"] = time.monotonic() - t0
    t0 = time.monotonic()
    recs += exchange_kernel_phase(dev)
    phases["exchange_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    multi = multi_rank_phase(dev, smi)
    phases["multi_rank_path"] = time.monotonic() - t0
    t0 = time.monotonic()
    recs += mla_kernel_phase(fa, md, mla_ref, dev)
    phases["mla_kernels"] = time.monotonic() - t0
    every = {**_counters(fa, ce),
             "quantize_int8_cuda": qz.quantize_int8_cuda,
             "dequant_accum_cuda": qz.dequant_accum_cuda,
             "mla_decode_paged_cuda": md.mla_decode_paged_cuda,
             "mla_decode_cuda": md.mla_decode_cuda,
             "ssd_scan_cuda": sk.ssd_scan_cuda,
             "mlstm_scan_cuda": mk.mlstm_scan_cuda}
    t0 = time.monotonic()
    mla = mla_path_phase(fa, md, dev, smi, every)
    gen_s = mla["generate"]["seconds"] + mla["generate"]["gate"]["seconds"]
    phases["mla_serve_path"] = time.monotonic() - t0 - gen_s
    phases["mla_generate_path"] = gen_s
    t0 = time.monotonic()
    recs += zamba_kernel_phase(fa, sk, dev, smi)
    phases["zamba_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    zamba = zamba_path_phase(fa, md, sk, dev, smi)
    phases["zamba_generate_path"] = time.monotonic() - t0
    t0 = time.monotonic()
    recs += xlstm_kernel_phase(mk, dev, smi)
    phases["xlstm_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    xlstm = xlstm_path_phase(every, dev, smi)
    phases["xlstm_generate_path"] = time.monotonic() - t0
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()), flush=True)

    root = "src/repro/kernels/"
    src = {"flash_attention_cuda": (
               "src/repro_torch/csrc/flash_attention.cu",
               root + "flash_attention/flash_attention.py:88"),
           "flash_decode_paged_cuda": (
               "src/repro_torch/csrc/paged_decode.cu",
               root + "flash_attention/flash_attention.py:210"),
           "flash_attention_bwd_cuda": (
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               root + "flash_attention/ref.py:115"),
           "cross_entropy_cuda": (
               "src/repro_torch/csrc/cross_entropy.cu",
               root + "cross_entropy/cross_entropy.py:90"),
           "ce_dlogits_cuda": (
               "src/repro_torch/csrc/cross_entropy.cu",
               root + "cross_entropy/ref.py:90"),
           "quantize_int8_cuda": (
               "src/repro_torch/csrc/quantize.cu",
               root + "quantize/quantize.py:50"),
           "dequant_accum_cuda": (
               "src/repro_torch/csrc/quantize.cu",
               root + "quantize/quantize.py:107"),
           "mla_decode_paged_cuda": (
               "src/repro_torch/csrc/mla_decode.cu",
               root + "mla_decode/mla_decode.py:178"),
           "mla_decode_cuda": (
               "src/repro_torch/csrc/mla_decode.cu",
               root + "mla_decode/mla_decode.py:80"),
           "ssd_scan_cuda": (
               "src/repro_torch/csrc/ssd_scan.cu",
               root + "ssd_scan/ssd_scan.py:86"),
           "mlstm_scan_cuda": (
               "src/repro_torch/csrc/mlstm_scan.cu",
               root + "mlstm_scan/mlstm_scan.py:95")}
    # launches: the path each kernel serves (GQA decode: serve; the MLA
    # paged decode: the MLA serve path; the contiguous MLA decode: the
    # MLA generate path; the exchange kernels: the multi-rank train path,
    # rank 0's counts; the SSD scan: the zamba2 generate path; the mLSTM
    # scan: the xLSTM generate path; the rest: the one-rank train path);
    # every path's counts go to the json
    by_path = {n: {"serve": path["launches"].get(n, 0),
                   "train": train["launches"].get(n, 0),
                   "multi_rank": multi["launches"].get(n, 0),
                   "mla_serve": mla["launches"].get(n, 0),
                   "mla_generate": mla["generate"]["launches"].get(n, 0),
                   "zamba_generate": zamba["launches"].get(n, 0),
                   "xlstm_generate": xlstm["launches"].get(n, 0)}
               for n in src}
    path_of = {"flash_decode_paged_cuda": "serve",
               "quantize_int8_cuda": "multi_rank",
               "dequant_accum_cuda": "multi_rank",
               "mla_decode_paged_cuda": "mla_serve",
               "mla_decode_cuda": "mla_generate",
               "ssd_scan_cuda": "zamba_generate",
               "mlstm_scan_cuda": "xlstm_generate"}
    at_keys = ("dtype", "B", "Sq", "S", "H", "Hkv", "D", "T", "V", "R",
               "kv_lens", "bs", "rows", "MB", "G", "P", "N", "chunk", "dk",
               "dv")
    kernels = []
    for name, (source, replaces) in src.items():
        mine = [r for r in recs if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r]
        # the prefill kernel's row is the train path's D=128 case; its
        # D=192 case (the MLA prefill) and D=80 case (zamba2's shared
        # attention) ride beside it
        main_rec = [r for r in timed
                    if (r.get("D") not in (64, MLA_DQK, ZAMBA_DH)
                        or name != "flash_attention_cuda")
                    and r.get("window") != "long"
                    and "continuity" not in r][-1]
        path_name = path_of.get(name, "train")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[name][path_name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "launches_by_path": by_path[name],
            "two_call_ms": main_rec.get("two_call_ms"),
            "device_ms": main_rec.get("device_ms"),
            "library_device_ms": main_rec.get("library_device_ms"),
            "device_ms_by_launch": main_rec.get("device_ms_by_launch"),
            "at": {k: main_rec[k] for k in main_rec if k in at_keys}})
        for key, d, path_name_d in (("at_d64", 64, "serve"),
                                    ("at_d192", MLA_DQK, "mla_serve"),
                                    ("at_d80", ZAMBA_DH, "zamba_generate")):
            # D=64: phase 2's largest bucket (B=2, S=512)
            at_d = [r for r in timed if r.get("D") == d
                    and (d != 64 or r.get("Sq") == 512)]
            if at_d:
                kernels[-1][key] = {
                    "launches": by_path[name][path_name_d],
                    **{k: at_d[-1][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
                    "at": {k: at_d[-1][k] for k in at_d[-1]
                           if k in at_keys}}
        long_window = [r for r in timed if r.get("window") == "long"]
        if long_window:
            kernels[-1]["at_long_window"] = {
                **{k: long_window[-1][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "library_device_ms")},
                "at": {k: long_window[-1][k] for k in long_window[-1]
                       if k in at_keys}}
        for r in (r for r in timed if "continuity" in r):
            kernels[-1][r["continuity"]] = {
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "device_ms",
                                     "library_device_ms",
                                     "device_ms_by_launch")},
                "at": {k: r[k] for k in r if k in at_keys}}
        check(kernels[-1]["launches"] > 0, f"{name} never launched on its "
              f"path")
    check(kernels[0]["at_d80"]["launches"] > 0,
          "the D=80 prefill never launched on the zamba2 path")
    check(len(kernels) == 11, f"{len(kernels)} kernels listed")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "phase_seconds": phases, "sm90": sm90,
         "kernel_cases": recs,
         "path": path, "train": train, "multi_rank": multi,
         "mla_path": mla, "zamba_path": zamba, "xlstm_path": xlstm,
         "kernels": kernels},
        indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
