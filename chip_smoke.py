#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an error):

1. Prints the card's name and power limit (nvidia-smi), builds both
   CUDA kernels from ``src/repro_torch/csrc`` with nvcc (in parallel)
   and prints the build time.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, in fp32 (tolerance 1e-4) and bf16 (tolerance 2e-2), at
   tinyllama-1.1b widths (H=32, Hkv=4, D=64). Prefill at buckets 16,
   128 and 512 with B=2, plus Sq=Skv=200 (not a tile multiple); paged
   decode with B=8, bs=16, ragged kv_lens up to 512, NULL holes, one
   all-NULL inactive slot and one sequence at exactly MB*bs. TF32 is
   off for every fp32 comparison. Times are CUDA-event medians of 20
   runs after warm-up; ``library_ms`` is
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   dense inputs, a yardstick the port never calls.
3. Path phase: ``repro_torch.launch.serve`` serves tinyllama-1.1b at
   full width (random weights from seed 0, bf16 compute,
   attention_impl="kernel"): 8 slots, prefill batch 2, 16 requests,
   prompts 64-448, generations 16-64, pod speeds 1,0.5. The launch
   counters are zeroed just before and read just after; the run must
   finish every request, launch the prefill kernel once per layer per
   prefill group and the decode kernel once per layer per decode step.
   On the first prefill group and the first decode step the kernel
   path's logits are held against the "reference" path's on the same
   inputs and a copy of the same cache (bf16 tolerance below).
4. Prints one ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``. Details go to
   ``chiprun_out/chip_smoke.json``.
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
# Kernel path vs reference path logits of the whole 22-layer model in
# bf16: the two paths round attention at different points, and the
# difference compounds through the layers. Relative to the largest
# reference logit (at least 1).
LOGIT_TOL = 5e-2
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16
REPS = 20

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
    rec = {"kernel": "flash_attention_cuda", "dtype": str(dtype),
           "B": b, "Sq": s, "Skv": s, "H": h, "Hkv": hkv, "D": d,
           "max_abs_err": err}
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


def paged_inputs(gen, dev, dtype):
    """B=8 sequences over a 16-token-block pool: ragged kv_lens up to
    MB*bs=512 (one exactly 512), NULL holes inside live windows and one
    all-NULL inactive slot with kv_len 1."""
    import torch
    b, bs, mb, hkv, h, d = 8, 16, 32, 4, 32, 64
    n = b * mb
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n, bs, hkv, d), generator=gen, device=dev).to(dtype)
    lens = [512, 1, 37, 200, 16, 301, 455, 129]     # slot 1: inactive
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
    return q, kp, vp, tables.to(dev), kv_lens.to(dev)


def decode_case(fa, gen, dev, dtype):
    import torch
    q, kp, vp, tables, kv_lens = paged_inputs(gen, dev, dtype)
    got = fa.flash_decode_paged_cuda(q, kp, vp, tables, kv_lens)
    want = fa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(not got[1].any().item(), "decode: inactive slot output is not 0")
    b, _, h, d = q.shape
    n, bs, hkv, _ = kp.shape
    rec = {"kernel": "flash_decode_paged_cuda", "dtype": str(dtype),
           "B": b, "H": h, "Hkv": hkv, "D": d, "bs": bs, "N": n,
           "MB": tables.shape[1], "kv_lens": kv_lens.tolist(),
           "max_abs_err": err}
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
        recs.append(decode_case(fa, gen, dev, dtype))
        for r in recs[-5:]:
            shape = r.get("Sq", r.get("kv_lens"))
            print(f"[kernels] {r['kernel']} {r['dtype']} at {shape}: max "
                  f"abs err {r['max_abs_err']:.3e} (tol {tol:g})"
                  + (f", {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                     f"SDPA {r['library_ms']:.4f} ms, bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']})"
                     if "ms" in r else ""), flush=True)
            check(r["max_abs_err"] <= tol,
                  f"{r['kernel']} {r['dtype']} at {shape}: error "
                  f"{r['max_abs_err']} > {tol}")
    return recs


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------

def path_phase(fa, dev):
    import torch
    from repro_torch.configs.base import resolve
    from repro_torch.launch import serve as tserve
    from repro_torch.models.model import build_model

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

    def build_checked(model, params, layout, *a, **k):
        eng = orig_build(model, params, layout, *a, **k)
        ref = build_model(dataclasses.replace(model.cfg,
                                              attention_impl="reference"),
                          model.device)
        first = {"prefill": True, "decode": True}

        def prefill_checked(fn):
            def run(prompts, lens, cache, tables):
                if not first["prefill"]:
                    return fn(prompts, lens, cache, tables)
                first["prefill"] = False
                t0 = time.monotonic()
                copy = {n: c.clone() for n, c in cache.items()}
                want, _ = ref.prefill_paged(params, prompts, lens, copy,
                                            tables)
                del copy
                torch.cuda.synchronize()
                check_s[0] += time.monotonic() - t0
                got, cache = fn(prompts, lens, cache, tables)
                compare("first prefill group", got, want)
                return got, cache
            return run

        def decode_checked(fn):
            def run(tokens, cache, tables, kv_lens):
                if not first["decode"]:
                    return fn(tokens, cache, tables, kv_lens)
                first["decode"] = False
                t0 = time.monotonic()
                copy = {n: c.clone() for n, c in cache.items()}
                want, _ = ref.decode_paged(params, tokens, copy, tables,
                                           kv_lens)
                del copy
                torch.cuda.synchronize()
                check_s[0] += time.monotonic() - t0
                got, cache = fn(tokens, cache, tables, kv_lens)
                compare("first decode step", got, want)
                return got, cache
            return run

        eng.prefill_fns = {b: prefill_checked(f)
                           for b, f in eng.prefill_fns.items()}
        eng.decode_fn = decode_checked(eng.decode_fn)
        return eng

    tserve.build_engine = build_checked
    try:
        fa.flash_attention_cuda.launches = 0
        fa.flash_decode_paged_cuda.launches = 0
        result = tserve.main(SERVE_ARGV)
        launches = {"flash_attention_cuda": fa.flash_attention_cuda.launches,
                    "flash_decode_paged_cuda":
                        fa.flash_decode_paged_cuda.launches}
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


def main() -> int:
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

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    t0 = time.monotonic()
    lib_path = _build.build(verbose=True)
    _build.load()
    build_s = time.monotonic() - t0
    print(f"[build] {lib_path.name} from "
          f"{[s.name for s in _build.sources()]} in {build_s:.1f} s",
          flush=True)

    recs = kernel_phase(fa, dev)
    path = path_phase(fa, dev)

    src = {"flash_attention_cuda": ("src/repro_torch/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention/"
                                    "flash_attention.py:88"),
           "flash_decode_paged_cuda": ("src/repro_torch/csrc/paged_decode.cu",
                                       "src/repro/kernels/flash_attention/"
                                       "flash_attention.py:210")}
    kernels = []
    for name, (source, replaces) in src.items():
        timed = [r for r in recs if r["kernel"] == name and "ms" in r]
        main_rec = timed[-1]          # prefill: bucket 512; decode: B=8
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in timed),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "at": {k: main_rec[k] for k in main_rec
                   if k in ("dtype", "B", "Sq", "Skv", "kv_lens", "bs")}})

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build_seconds": build_s, "kernel_cases": recs,
         "path": path, "kernels": kernels}, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
