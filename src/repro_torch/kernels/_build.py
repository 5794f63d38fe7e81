"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (one ``nvcc`` per source, all
started together, then one link), which is loaded with ``ctypes``. The
build happens at first use, never at import, into
``src/repro_torch/_build/`` under a name that hashes the sources and the
shared headers (``csrc/*.cuh``), so an edited kernel or header is
rebuilt and an unchanged one is reused within a checkout. ptxas's
report (registers, shared memory, spills per kernel) is kept beside the
library (:func:`ptxas_log`). A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def tag() -> str:
    """Hash of every source and header and the target flags: the name
    under which the library is built."""
    digest = hashlib.sha256()
    for s in sources() + headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are built from source at first use")


def _run(cmds: List[List[str]], verbose: bool = False) -> str:
    """Run the commands in parallel; returns their joined output."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    failed, outs = [], []
    for cmd, p in procs:
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
        elif verbose and out:
            print(out, end="", flush=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library.
    Returns its path; reuses a library already built from these exact
    sources and headers. ``verbose`` prints ptxas's registers and shared
    memory per kernel (kept in :func:`ptxas_log` either way)."""
    srcs = sources()
    t = tag()
    lib_path = BUILD_DIR / f"libreprotorch_{t}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
    objs = [BUILD_DIR / f"{s.stem}_{t}.o" for s in srcs]
    log = _run([common + ["-c", str(s), "-o", str(o)]
                for s, o in zip(srcs, objs)], verbose)
    (BUILD_DIR / f"ptxas_{t}.log").write_text(log)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    return lib_path


def ptxas_log() -> str:
    """ptxas's report of the current build (``build`` first)."""
    return (BUILD_DIR / f"ptxas_{tag()}.log").read_text()


def objects() -> List[Path]:
    """The current build's object files, one a source (``build`` first)."""
    t = tag()
    return [BUILD_DIR / f"{s.stem}_{t}.o" for s in sources()]


def ptx(source: Path) -> str:
    """The PTX nvcc makes of one source for the build's target."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{source.stem}_{tag()}.ptx"
    _run([[_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-ptx", str(source),
           "-o", str(out)]])
    return out.read_text()


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.flash_attention_fwd.argtypes = [
                vp, vp, vp, vp, vp,             # q, k, v, o, lse (or 0)
                ci, ci, ci, ci, ci, ci,         # B, Sq, Skv, H, Hkv, D
                ci, ci, cf, ci, vp]             # causal, q_offset, scale,
            lib.flash_attention_fwd.restype = ci  # dtype, stream
            lib.flash_attention_bwd.argtypes = [
                vp, vp, vp, vp, vp, vp,         # q, k, v, out, dout, lse
                vp, vp, vp, vp,                 # Dv scratch, dq, dk, dv
                ci, ci, ci, ci, ci, ci,         # B, Sq, Skv, H, Hkv, D
                ci, ci, cf, ci, vp]             # causal, q_offset, scale,
            lib.flash_attention_bwd.restype = ci  # dtype, stream
            lib.ce_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp,         # h, w, labels, nll, lse,
                                                # partials (bf16, or 0)
                ci, ci, ci, ci, ci,             # T, D, V, w_rows, splits
                cf, cf, ci, vp]                 # eps, softcap, dtype, stream
            lib.ce_fwd.restype = ci
            lib.flash_attention_fwd_sm90_smem.argtypes = [ci]  # D
            lib.flash_attention_fwd_sm90_smem.restype = ci
            lib.ce_fwd_sm90_smem.argtypes = []
            lib.ce_fwd_sm90_smem.restype = ci
            lib.flash_attention_fwd_sm90_kv_tile.argtypes = [ci]  # D
            lib.flash_attention_fwd_sm90_kv_tile.restype = ci
            lib.ce_fwd_sm90_tile.argtypes = [ci]  # axis
            lib.ce_fwd_sm90_tile.restype = ci
            lib.ce_dlogits.argtypes = [
                vp, vp, vp, vp, vp, vp,         # logits, lse, labels,
                                                # weights, dloss, out
                ci, ci, cf, ci, vp]             # R, V, eps, dtype, stream
            lib.ce_dlogits.restype = ci
            lib.paged_decode_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp,     # q, k_pool, v_pool,
                                                # tables, kv_lens, o,
                                                # partials
                ci, ci, ci, ci, ci, ci, ci,     # B, H, Hkv, D, N, bs, MB
                ci, cf, ci, vp]                 # splits, scale, dtype,
            lib.paged_decode_fwd.restype = ci   # stream
            lib.paged_decode_split_len.argtypes = []
            lib.paged_decode_split_len.restype = ci
            lib.flash_attention_bwd_sm90_tile.argtypes = [ci, ci]  # D, axis
            lib.flash_attention_bwd_sm90_tile.restype = ci
            lib.flash_attention_bwd_sm90_smem.argtypes = [ci, ci]  # D, pass
            lib.flash_attention_bwd_sm90_smem.restype = ci
            lib.mla_decode_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp,     # q_abs, q_r, ckv, kr,
                                                # kv_len, out, partials
                                                # (bf16)
                ci, ci, ci, ci, ci, ci,         # B, H, R, DR, S, splits
                cf, ci, vp]                     # scale, dtype, stream
            lib.mla_decode_fwd.restype = ci
            lib.mla_decode_paged_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp,     # q_abs, q_r, ckv_pool,
                vp,                             # kr_pool, tables, kv_lens,
                                                # out, partials (bf16)
                ci, ci, ci, ci, ci, ci, ci,     # B, H, R, DR, N, bs, MB
                ci, cf, ci, vp]                 # splits, scale, dtype,
            lib.mla_decode_paged_fwd.restype = ci  # stream
            for fn in ("mla_decode_paged_split_len", "mla_decode_paged_tile",
                       "mla_decode_paged_part_len",
                       "mla_decode_paged_sm90_smem", "ssd_scan_sm90_tile",
                       "ssd_scan_sm90_smem"):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ci
            lib.ssd_scan_sm90_smem.argtypes = [ci]      # kernel
            lib.ssd_scan_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp,         # x, dt, A, B, C, D (or 0)
                vp, vp, vp,                     # y, final state, scratch
                                                # (bf16)
                ci, ci, ci, ci, ci, ci, ci,     # B, S, H, P, G, N, Q
                ci, vp]                         # dtype, stream
            lib.ssd_scan_fwd.restype = ci
            lib.mlstm_scan_fwd.argtypes = [
                vp, vp, vp, vp, vp,             # q, k, v, i_pre, f_pre
                vp, vp, vp, vp,                 # h, C, n, m
                ci, ci, ci, ci, ci, ci,         # B, S, H, dk, dv, Q
                cf, ci, vp]                     # scale, dtype, stream
            lib.mlstm_scan_fwd.restype = ci
            cll = ctypes.c_longlong
            lib.quantize_int8_fwd.argtypes = [
                vp, vp, vp, vp, cll, vp]        # x, noise (or 0), q, s,
            lib.quantize_int8_fwd.restype = ci  # rows, stream
            lib.dequant_accum_fwd.argtypes = [
                vp, vp, vp, ci, cll, vp]        # q, s, out, ranks, rows,
            lib.dequant_accum_fwd.restype = ci  # stream
            _lib = lib
        return _lib
