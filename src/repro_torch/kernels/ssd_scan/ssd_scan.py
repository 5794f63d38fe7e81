"""Hand-written CUDA SSD scan and its plain PyTorch version.

:func:`ssd_scan_cuda` — the Mamba2 SSD chunked scan from zero state
(``csrc/ssd_scan.cu``), replacing the JAX package's ``ssd_scan_pallas``:
returns ``y`` in x's dtype and the final state in fp32. It runs its
plain version (:func:`ssd_scan_plain`, ``ref.ssd_chunked``) when, and
only when, its tensors lie on the CPU. For CUDA tensors it launches the
kernel or raises. It counts its launches in ``.launches``, a plain
integer that a caller may reset (one a call: in bf16 a call is three
kernel launches). The kernels launch on PyTorch's current stream and do
not synchronise.

bf16 runs on the tensor cores in three kernels (chunk states, the
state passing, the chunk scan in tiles of ``ROW_TILE`` rows), with the
three operands made in fp32 inside the kernels (the weighted B, the
carried state and the decay-weighted scores) fed as bf16 hi/lo pairs;
:func:`ssd_scan_tiled_plain` models that arithmetic for the tests. fp32
keeps the one CUDA-core kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIM = 64         # the state dim N the kernel is built for
P_SLICE = 32           # head dim P must be a multiple of this
MAX_CHUNK = 256        # largest chunk Q (one chunk row per thread)
# rows a tile of the bf16 chunk scan (csrc/ssd_scan.cu; held equal to
# ssd_scan_sm90_tile)
ROW_TILE = 64


def _pair(v: torch.Tensor, rounding: str):
    """An fp32 operand as the kernel feeds it to a bf16 product: the
    pair hi = bf16(v), lo = bf16(v - hi) ("pair"), hi alone ("bf16"),
    or v rounded to TF32 ("tf32", for the record)."""
    if rounding == "tf32":
        bits = v.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32), None
    hi = v.to(torch.bfloat16).float()
    if rounding == "bf16":
        return hi, None
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm_pair(a, b_pair):
    """a @ (hi + lo), the two products summed in the kernel's order."""
    hi, lo = b_pair
    out = a @ hi
    return out if lo is None else out + a @ lo


def ssd_scan_tiled_plain(x, dt, A, Bm, Cm, D=None, *, chunk_size: int = 256,
                         rounding: str = "pair"):
    """The bf16 kernels' arithmetic in plain PyTorch, for the tests:
    1. chunk states from zero, S_c (P, N) = x^T (w dt B), w = exp(A_last
       - A_cum), the weighted B as a bf16 pair;
    2. state_in[0] = 0, state_in[c + 1] = exp(A_last[c]) state_in[c] +
       S_c, in chunk order, fp32;
    3. per tile of ``ROW_TILE`` rows i: exp(A_i) (C_i state_in^T) with
       the state as a bf16 pair, then for each tile j at or below i in
       order M = (C_i B_j^T) exp(A_i - A_j) dt_j (0 for j > i) as a bf16
       pair times x_j, then + D x_i; y rounded to x's dtype once.
    Rows past S read as dt = x = B = C = 0. Returns (y in x's dtype,
    final state fp32). ``rounding`` "bf16" or "tf32" replaces the pairs
    with one rounding, for the record."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(int(chunk_size), s)
    nc = -(-s // q)
    pad = nc * q - s

    def heads(t):                      # (B, S, G|H, F) -> (B, H, nc, q, F)
        t = t.float()
        if t.shape[2] != h:
            t = t.repeat_interleave(h // t.shape[2], dim=2)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nc, q, h, -1).permute(0, 3, 1, 2, 4)

    xf, Bf, Cf = heads(x), heads(Bm), heads(Cm)
    dtf = heads(dt[..., None])[..., 0]                 # (B, H, nc, q)
    acum = torch.cumsum(dtf * A.float()[None, :, None, None], dim=-1)
    a_last = acum[..., -1]                             # (B, H, nc)
    # 1. chunk states
    w = torch.exp(a_last[..., None] - acum) * dtf
    st = _mm_pair(xf.transpose(-1, -2), _pair(Bf * w[..., None], rounding))
    # 2. state passing
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = torch.exp(a_last[:, :, c])[..., None, None] * state \
            + st[:, :, c]
    sin = torch.stack(state_in, dim=2)                 # (B, H, nc, P, N)
    s_pair = _pair(sin, rounding)
    s_pair = tuple(t.transpose(-1, -2) if t is not None else None
                   for t in s_pair)
    # 3. chunk scan, tile by tile
    ys = []
    for i0 in range(0, q, ROW_TILE):
        i1 = min(i0 + ROW_TILE, q)
        ci = Cf[..., i0:i1, :]
        ai = acum[..., i0:i1]
        y = torch.exp(ai)[..., None] * _mm_pair(ci, s_pair)
        for j0 in range(0, i1, ROW_TILE):
            j1 = min(j0 + ROW_TILE, q)
            gm = ci @ Bf[..., j0:j1, :].transpose(-1, -2)
            ii = torch.arange(i0, i1)[:, None]
            jj = torch.arange(j0, j1)[None, :]
            causal = ii >= jj
            diff = ai[..., :, None] - acum[..., None, j0:j1]
            m = torch.where(causal, gm * torch.exp(
                torch.where(causal, diff, 0.0)) * dtf[..., None, j0:j1],
                0.0)
            hi, lo = _pair(m, rounding)
            y = y + hi @ xf[..., j0:j1, :]
            if lo is not None:
                y = y + lo @ xf[..., j0:j1, :]
        if D is not None:
            y = y + D.float()[None, :, None, None, None] * xf[..., i0:i1, :]
        ys.append(y)
    y = torch.cat(ys, dim=-2)                          # (B, H, nc, q, P)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_scan_plain(x, dt, A, Bm, Cm, D=None, *, chunk_size: int = 256):
    """Plain version of the kernel: ``ref.ssd_chunked`` from zero state."""
    return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk_size=chunk_size)


def ssd_scan_cuda(
    x: torch.Tensor,                     # (B, S, H, P) fp32 or bf16
    dt: torch.Tensor,                    # (B, S, H) fp32
    A: torch.Tensor,                     # (H,) fp32
    Bm: torch.Tensor,                    # (B, S, G, N) x's dtype
    Cm: torch.Tensor,                    # (B, S, G, N)
    D: Optional[torch.Tensor] = None,    # (H,) fp32
    *,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from zero state with chunks of ``min(chunk_size,
    S)`` rows; returns (y (B, S, H, P) in x's dtype, final state (B, H,
    P, N) fp32). The kernels take N == 64, P a multiple of 32, a chunk
    of at most 256 rows and G dividing H; in bf16 also 16-byte-aligned x,
    B and C and B * H <= 65535."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk_size=chunk_size)
    name = "ssd_scan_cuda"
    tensors = [x, dt, A, Bm, Cm] + ([D] if D is not None else [])
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{name}: B/C dtypes must be x's ({x.dtype})")
    if any(t.dtype != torch.float32 for t in (dt, A) + ((D,) if D is not None
                                                       else ())):
        raise TypeError(f"{name}: dt, A and D must be float32")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, g, n)
            or Cm.shape != Bm.shape or (D is not None and D.shape != (h,))):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)} "
            f"disagree")
    q = min(int(chunk_size), s)
    if (n != STATE_DIM or p % P_SLICE or g <= 0 or h % g or q <= 0
            or q > MAX_CHUNK):
        raise ValueError(
            f"{name}: needs N == {STATE_DIM}, P % {P_SLICE} == 0, H % G "
            f"== 0 and a chunk of 1..{MAX_CHUNK} rows, got N={n} P={p} "
            f"H={h} G={g} chunk={q}")
    if x.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
            raise ValueError(f"{name}: bf16 x, B and C must be 16-byte "
                             f"aligned (16-byte copies)")
        if b * h > 65535:
            raise ValueError(f"{name}: bf16 takes B * H <= 65535, got "
                             f"{b * h}")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return y, final.zero_()
    from repro_torch.kernels import _build
    lib = _build.load()
    work = None
    if x.dtype == torch.bfloat16:     # per-chunk states, then A_cum
        nc = -(-s // q)
        work = torch.empty((b * h * nc * (p * n + q),), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr() if D is not None else None,
            y.data_ptr(), final.data_ptr(),
            work.data_ptr() if work is not None else None, b, s, h, p, g, n,
            q, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    ssd_scan_cuda.launches += 1
    return y, final


ssd_scan_cuda.launches = 0
