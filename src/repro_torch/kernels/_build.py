"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (one ``nvcc`` per source, all
started together, then one link), which is loaded with ``ctypes``. The
build happens at first use, never at import, into
``src/repro_torch/_build/`` under a name that hashes the sources, so an
edited kernel is rebuilt and an unchanged one is reused within a
checkout. A failed build raises; nothing falls back.
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


def _run(cmds: List[List[str]], verbose: bool = False) -> None:
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    failed = []
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
        elif verbose and out:
            print(out, end="", flush=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library.
    Returns its path; reuses a library already built from these exact
    sources. ``verbose`` prints ptxas's registers and shared memory per
    kernel."""
    srcs = sources()
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libreprotorch_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        common += ["-Xptxas", "-v"]
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    _run([common + ["-c", str(s), "-o", str(o)] for s, o in zip(srcs, objs)],
         verbose)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    return lib_path


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
                vp, vp, vp, vp, vp,             # h, w, labels, nll, lse
                ci, ci, ci, ci,                 # T, D, V, w_rows
                cf, cf, ci, vp]                 # eps, softcap, dtype, stream
            lib.ce_fwd.restype = ci
            lib.ce_dlogits.argtypes = [
                vp, vp, vp, vp, vp, vp,         # logits, lse, labels,
                                                # weights, dloss, out
                ci, ci, cf, ci, vp]             # R, V, eps, dtype, stream
            lib.ce_dlogits.restype = ci
            lib.paged_decode_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp,         # q, k_pool, v_pool,
                                                # tables, kv_lens, o
                ci, ci, ci, ci, ci, ci, ci,     # B, H, Hkv, D, N, bs, MB
                cf, ci, vp]                     # scale, dtype, stream
            lib.paged_decode_fwd.restype = ci
            _lib = lib
        return _lib
