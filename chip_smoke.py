#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an error):

1. Prints the card's name and power limit (nvidia-smi), builds every
   CUDA kernel from ``src/repro_torch/csrc`` with nvcc (one nvcc per
   source, all started together) and prints the build time.
2. Serving kernel phase: the prefill and paged-decode kernels against
   their plain PyTorch versions on the card, in fp32 (tolerance 1e-4)
   and bf16 (tolerance 2e-2), at tinyllama-1.1b widths (H=32, Hkv=4,
   D=64). Prefill at buckets 16, 128 and 512 with B=2, plus Sq=Skv=200
   (not a tile multiple); paged decode with B=8, bs=16, ragged kv_lens
   up to 512, NULL holes, one all-NULL inactive slot and one sequence at
   exactly MB*bs. TF32 is off for every fp32 comparison. Times are
   CUDA-event medians of 20 runs after warm-up; ``library_ms`` is
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
   any is checked. Each kernel is timed at the shape the train phase gives
   it (B=5 rows of 1024 tokens a microbatch, T=5120, a 4096-row dlogits
   chunk). Yardsticks: the autograd backward of SDPA(is_causal=True);
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
   step from one state and batch gives bit-identical parameters.
6. Prints one ``{"kernels": [...]}`` line, then, last,
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
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    e_bwd, r_bwd = _errs(grads, fa.flash_attention_bwd_plain(
        q, k, v, out, lse, dout))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          "attention backward differs between two runs")
    shape = {"dtype": str(dtype), "B": b, "S": s, "H": h, "Hkv": hkv,
             "D": d}
    fwd = {"kernel": "flash_attention_cuda", **shape, "with_lse": True,
           "max_abs_err": e_fwd, "rel_l2": r_fwd}
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
    rec = {"kernel": "cross_entropy_cuda", "dtype": str(dtype), "T": t,
           "D": d, "V": v, "eps": eps, "tied_rows": tied,
           "zero_weights": int((weights == 0).sum().item()),
           "max_abs_err": e, "rel_l2": r}
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
                     if "ms" in r else ""), flush=True)
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

    def build_checked(model, tcfg):
        step = orig_build(model, tcfg)

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
    del a, b, twin, state, result["state"]

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
        "repeat_step_seconds": repeat_s,
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


def _finite(x):
    return x == x and abs(x) != float("inf")


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
    from repro_torch.kernels.cross_entropy import cross_entropy as ce
    from repro_torch.kernels.cross_entropy import ref as ce_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    t0 = time.monotonic()
    lib_path = _build.build(verbose=True)
    _build.load()
    build_s = time.monotonic() - t0
    print(f"[build] {lib_path.name} from "
          f"{[s.name for s in _build.sources()]} in {build_s:.1f} s",
          flush=True)

    phases = {"build": build_s}
    t0 = time.monotonic()
    recs = kernel_phase(fa, dev)
    phases["serve_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    rows_mb, seq = TRAIN_MICROBATCH
    recs += train_kernel_phase(fa, ce, ce_ref, dev, rows_mb, seq)
    phases["train_kernels"] = time.monotonic() - t0
    t0 = time.monotonic()
    path = path_phase(fa, dev)
    phases["serve_path"] = time.monotonic() - t0
    t0 = time.monotonic()
    train = train_phase(fa, ce, dev)
    phases["train_path"] = time.monotonic() - t0
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
               root + "cross_entropy/ref.py:90")}
    # launches: the path each kernel serves (decode: serve; the rest:
    # train, this slice's path); both paths' counts go to the json
    by_path = {n: {"serve": path["launches"].get(n, 0),
                   "train": train["launches"][n]} for n in src}
    kernels = []
    for name, (source, replaces) in src.items():
        mine = [r for r in recs if r["kernel"] == name]
        main_rec = [r for r in mine if "ms" in r][-1]
        path_name = "serve" if name == "flash_decode_paged_cuda" else "train"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[name][path_name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "launches_by_path": by_path[name],
            "at": {k: main_rec[k] for k in main_rec
                   if k in ("dtype", "B", "Sq", "S", "H", "Hkv", "D", "T",
                            "V", "R", "kv_lens", "bs")}})
        check(kernels[-1]["launches"] > 0, f"{name} never launched on its "
              f"path")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "phase_seconds": phases, "kernel_cases": recs,
         "path": path, "train": train, "kernels": kernels}, indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
