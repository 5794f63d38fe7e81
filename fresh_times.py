#!/usr/bin/env python3
"""Times kernels of one or more checkouts of the PyTorch/CUDA port, each
first thing in a fresh process, on one NVIDIA card, with
``chip_smoke.py``'s own timed cases.

``chip_smoke.py`` times a kernel after the phases before it, and some
kernels' profiled times fall as a process runs other work (PERF.md §6
and §7: the MLA split kernel read ~30% lower after ``chip_smoke.py``'s
first seven phases than alone). This script runs the same case
functions, from this checkout's ``chip_smoke.py``, on the kernels of
each TREE, each in a process of its own that runs nothing before it:

* phase 12's ``mlstm_case`` on the bf16 mLSTM scan (``mlstm_scan_cuda``)
  at the first of ``MLSTM_CASES`` (xlstm-125m's prefill: B=4, S=1024,
  H=4, dk=dv=384, chunk 256), held to ``parity.RTOL``;
* phase 8's ``mla_paged_case`` on the bf16 paged MLA decode
  (``mla_decode_paged_cuda``) at the serve decode shape (B=8, H=128,
  bs=16, MB=32, ``SERVE_LENS``), held to ``BF16_TOL``;
* phase 2's ``decode_case`` on the bf16 GQA paged decode
  (``flash_decode_paged_cuda``) at the same serve shape with
  tinyllama's heads (H=32, Hkv=4, D=64), held to ``BF16_TOL``;
* phase 19's ``ssd_bwd_case`` on the bf16 SSD backward
  (``ssd_scan_bwd_cuda``) at the first of ``SSD_BWD_CASES`` (zamba2's
  training microbatch: B=5, S=1024, H=80, P=64, N=64, one group, chunk
  256, with D), held to ``parity.RTOL``, with its device time by launch;
* phase 20's ``mlstm_bwd_case`` on the bf16 mLSTM backward
  (``mlstm_scan_bwd_cuda``) at the first of ``MLSTM_BWD_CASES``
  (xlstm-125m's training microbatch: B=5, S=1024, H=4, dk=dv=384, chunk
  256), held to ``parity.RTOL``, with its device time by launch;
* phase 6's ``exchange_chunk_case`` on the int8 exchange's legs
  (``exchange_legs``): rank 0's send and receive sides of one exchange
  chunk (40 of olmo-1b's 25-MiB buckets over 2 ranks) and of one bucket
  as the tree's ``core/buckets.py`` runs them, the collectives left out:
  device time and launches under torch.profiler, by kernel (no check:
  a parent's legs have no plain twin to hold them to).

So the draws, checks and timers are the script's: a reading differs from
the phase's only in what ran before it in the process. From the root of
a checkout:

    python3 fresh_times.py [--only KERNEL[,KERNEL...]] TREE [TREE ...]

Each TREE is the root of a checkout: ``.`` for this one, or another one
unpacked beside it, such as the parent commit's ``git archive`` under
the gitignored ``tmp/``. Every tree's kernels are built first (one
process a tree, all started together); then, for each TREE in the order
given (``tmp/parent . . tmp/parent`` compares two), one fresh process a
kernel (``--only`` names the kernels of ``KERNELS`` to time, all of
them without it). Prints the card's name and power limit (nvidia-smi)
and one JSON line a reading (the case's record: ``ms``, ``device_ms``, ``plain_ms``,
``bound_ms``, ...), and writes them to ``chiprun_out/fresh_times.json``.
Exits non-zero, with no reading, when ``torch.cuda.is_available()`` is
false, and when a build or a check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
KERNELS = ("mlstm_scan_cuda", "mla_decode_paged_cuda",
           "flash_decode_paged_cuda", "ssd_scan_bwd_cuda",
           "mlstm_scan_bwd_cuda", "exchange_legs")


def _use_tree(tree: str) -> None:
    """Import ``repro_torch`` from ``tree`` (before anything imports it)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))


def _one(tree: str, kernel: str) -> int:
    _use_tree(tree)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.parity import RTOL
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    if kernel == "mlstm_scan_cuda":
        from repro_torch.kernels.mlstm_scan import mlstm_scan as mk
        gen = torch.Generator(device=dev).manual_seed(12)
        rec = cs.mlstm_case(mk, *cs.MLSTM_CASES[0], bf16, gen, dev,
                            timed=True)
        err, tol = rec["rel_l2"], RTOL[("mlstm_scan_cuda", bf16)]
    elif kernel == "ssd_scan_bwd_cuda":
        from repro_torch.kernels.ssd_scan import ssd_scan as sk
        gen = torch.Generator(device=dev).manual_seed(19)
        rec = cs.ssd_bwd_case(sk, *cs.SSD_BWD_CASES[0], bf16, gen, dev,
                              timed=True)
        err, tol = rec["rel_l2"], RTOL[("ssd_scan_bwd_cuda", bf16)]
    elif kernel == "mlstm_scan_bwd_cuda":
        from repro_torch.kernels.mlstm_scan import mlstm_scan as mk
        gen = torch.Generator(device=dev).manual_seed(20)
        rec = cs.mlstm_bwd_case(mk, *cs.MLSTM_BWD_CASES[0], bf16, gen, dev,
                                timed=True)
        err, tol = rec["rel_l2"], RTOL[("mlstm_scan_bwd_cuda", bf16)]
    elif kernel == "exchange_legs":
        from repro_torch.configs import base as cfgbase
        gen = torch.Generator(device=dev).manual_seed(6)
        shapes = cs.exchange_shapes(cfgbase.resolve("olmo-1b"))
        rec = {"kernel": kernel, "chunk": cs.exchange_chunk_case(
            shapes["chunk_buckets"], gen, dev),
            "bucket": cs.exchange_chunk_case(1, gen, dev)}
        err, tol = 0.0, 0.0
    elif kernel == "flash_decode_paged_cuda":
        from repro_torch.kernels.flash_attention import flash_attention as fa
        gen = torch.Generator(device=dev).manual_seed(2)
        rec = cs.decode_case(fa, gen, dev, bf16)
        err, tol = rec["max_abs_err"], cs.BF16_TOL
    else:
        from repro_torch.kernels.mla_decode import mla_decode as md
        from repro_torch.kernels.mla_decode import ref as mla_ref
        gen = torch.Generator(device=dev).manual_seed(8)
        rec = cs.mla_paged_case(md, mla_ref, gen, dev, bf16, timed=True)
        err, tol = rec["max_abs_err"], cs.BF16_TOL
    print(json.dumps({"tree": tree, **rec, "err": err, "tol": tol}),
          flush=True)
    return 0 if err <= tol else 1


def _fresh(args, what: str):
    """This script run with ``args`` in a process of its own; its last
    line as JSON, or None (the error printed) when it fails."""
    out = subprocess.run([sys.executable, __file__, *args],
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        print(out.stdout + out.stderr, file=sys.stderr)
        print(f"fresh_times: {what} failed (exit {out.returncode})",
              file=sys.stderr)
        return None
    print(lines[-1], flush=True)
    return json.loads(lines[-1])


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        _use_tree(argv[1])
        from repro_torch.kernels import _build
        _build.build()
        return 0
    if argv[:1] == ["--one"]:
        return _one(argv[1], argv[2])
    import torch
    if not torch.cuda.is_available():
        print("fresh_times: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = KERNELS
    if argv[:1] == ["--only"]:
        kernels = tuple(argv[1].split(","))
        unknown = set(kernels) - set(KERNELS)
        if unknown:
            print(f"fresh_times: unknown kernels {sorted(unknown)} (of "
                  f"{KERNELS})", file=sys.stderr)
            return 2
        argv = argv[2:]
    trees = argv or ["."]
    builds = [subprocess.Popen([sys.executable, __file__, "--build", t])
              for t in dict.fromkeys(trees)]
    if any(p.wait(timeout=900) != 0 for p in builds):
        print("fresh_times: a build failed", file=sys.stderr)
        return 1
    readings = []
    for tree in trees:
        for kernel in kernels:
            rec = _fresh(["--one", tree, kernel], f"{kernel} in {tree}")
            if rec is None:
                return 1
            readings.append(rec)
    OUT.mkdir(exist_ok=True)
    (OUT / "fresh_times.json").write_text(json.dumps(
        {"nvidia_smi": smi, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
