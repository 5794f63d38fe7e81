"""Hand-written CUDA kernels of the int8 gradient exchange
(``csrc/quantize.cu``).

The TPU kernels' own contract, kept for ``compression.compress_leaf``:

  * :func:`quantize_int8_cuda` — per-block absmax int8 quantization of a
    (rows, 256) fp32 stack (``quantize_int8_fwd``), replacing the JAX
    package's ``quantize_int8_pallas``;
  * :func:`dequant_accum_cuda` — the fused dequantize and sum over
    ranks (``dequant_accum_fwd``), replacing ``dequant_accum_pallas``.

The bucketed exchange's three legs, each one launch that reads and
writes the wire format (``ref.fuse_payload``'s 260-byte rows) directly:

  * :func:`exchange_send_cuda` — kernel 4's fused form: error
    correction, quantize, the stage-1 residual and the wire in message
    order (``exchange_send_int8``);
  * :func:`exchange_receive_cuda` — kernel 5's fused form: the sum over
    ranks, its re-quantize, the stage-2 residual and the gather leg's
    messages (``exchange_receive_int8``);
  * :func:`exchange_decode_cuda` — kernel 5 at one rank: every slot of
    the chunk from the gathered wire (``exchange_decode_int8``).

Each is bitwise equal to its plain version in ``ref.py``
(``quantize_blocks``, ``dequant_accum``, ``exchange_send``,
``exchange_receive``, ``exchange_decode``). Unlike the attention and
cross-entropy wrappers they take only CUDA tensors and raise for any
other: ``ops.py`` chooses the plain version for CPU tensors. Each counts
its launches in ``.launches``. A failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attention.flash_attention import _raise_on
from repro_torch.kernels.quantize import ref

BLOCK = 256          # the block size the kernels are built for
MAX_RANKS = 64       # ranks dequant_accum_cuda takes (a runtime loop)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors, got {t.device} (the "
                         f"plain version is kernels/quantize/ref.py)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_aligned(name: str, *ts: Optional[torch.Tensor]) -> None:
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _lens(lens: Sequence[int]):
    return (ctypes.c_longlong * len(lens))(*lens)


def quantize_int8_cuda(x: torch.Tensor,
                       noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, 256) fp32 [, noise (rows, 256) fp32 in [0, 1)] ->
    (q (rows, 256) int8, s (rows,) fp32)."""
    name = "quantize_int8_cuda"
    if x.dim() != 2 or x.shape[1] != BLOCK:
        raise ValueError(f"{name}: x must be (rows, {BLOCK}), got "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    _check(name, x, torch.float32, (rows, BLOCK))
    if noise is not None:
        _check(name, noise, torch.float32, (rows, BLOCK))
        if noise.device != x.device:
            raise ValueError(f"{name}: noise on {noise.device}, x on "
                             f"{x.device}")
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_int8_fwd(
            x.data_ptr(), noise.data_ptr() if noise is not None else None,
            q.data_ptr(), s.data_ptr(), rows, stream)
    _raise_on(name, err)
    quantize_int8_cuda.launches += 1
    return q, s


quantize_int8_cuda.launches = 0


def dequant_accum_cuda(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q (R, rows, 256) int8, s (R, rows) fp32 -> (rows, 256) fp32
    ``sum_r q[r] * s[r]``, ranks added in order."""
    name = "dequant_accum_cuda"
    if q.dim() != 3 or q.shape[2] != BLOCK:
        raise ValueError(f"{name}: q must be (R, rows, {BLOCK}), got "
                         f"{tuple(q.shape)}")
    ranks, rows, _ = q.shape
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"{name}: {ranks} ranks, takes 1..{MAX_RANKS}")
    _check(name, q, torch.int8, (ranks, rows, BLOCK))
    _check(name, s, torch.float32, (ranks, rows))
    if s.device != q.device:
        raise ValueError(f"{name}: s on {s.device}, q on {q.device}")
    out = torch.empty((rows, BLOCK), dtype=torch.float32, device=q.device)
    if rows == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequant_accum_fwd(q.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), ranks, rows, stream)
    _raise_on(name, err)
    dequant_accum_cuda.launches += 1
    return out


dequant_accum_cuda.launches = 0


def _chunk(name: str, x: torch.Tensor) -> Tuple[int, int, int]:
    """An exchange chunk's (nbc, p, ns)."""
    if x.dim() != 3 or x.shape[2] % BLOCK or x.shape[2] == 0:
        raise ValueError(f"{name}: a chunk must be (nbc, p, shard) with "
                         f"shard a multiple of {BLOCK}, got "
                         f"{tuple(x.shape)}")
    nbc, p, shard = x.shape
    if not 1 <= p <= MAX_RANKS or nbc == 0:
        raise ValueError(f"{name}: {p} ranks, takes 1..{MAX_RANKS}")
    _check(name, x, torch.float32, x.shape)
    return nbc, p, shard // BLOCK


def _like(name: str, t: Optional[torch.Tensor], x: torch.Tensor,
          what: str) -> None:
    if t is not None:
        _check(f"{name} ({what})", t, torch.float32, x.shape)
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on "
                             f"{x.device}")


def exchange_send_cuda(x: torch.Tensor, e: Optional[torch.Tensor],
                       d_rows: int, noise: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, List[int]]:
    """The send leg of an exchange chunk ``x`` (nbc, p, shard) fp32 (see
    ``ref.exchange_send``): ``e`` (same shape) or None, ``noise`` (same
    shape, in [0, 1)) or None. Returns (the wire (d_rows, 260) int8, the
    rows of each message)."""
    name = "exchange_send_cuda"
    nbc, p, ns = _chunk(name, x)
    _like(name, e, x, "e")
    _like(name, noise, x, "noise")
    rows = nbc * p * ns
    if not 0 <= d_rows <= rows:
        raise ValueError(f"{name}: d_rows {d_rows} of {rows} rows")
    lens = ref.message_rows(nbc, p, ns, d_rows)
    wire = torch.empty((d_rows, BLOCK + 4), dtype=torch.int8,
                       device=x.device)
    if d_rows == 0 and (e is None or rows == 0):
        return wire, lens
    _check_aligned(name, x, e, noise, wire)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.exchange_send_int8(
            x.data_ptr(), e.data_ptr() if e is not None else None,
            noise.data_ptr() if noise is not None else None,
            wire.data_ptr(), rows, d_rows, p, ns, _lens(lens), stream)
    _raise_on(name, err)
    exchange_send_cuda.launches += 1
    return wire, lens


exchange_send_cuda.launches = 0


def exchange_receive_cuda(rx: torch.Tensor, e: Optional[torch.Tensor],
                          me: int) -> torch.Tensor:
    """The receive leg (see ``ref.exchange_receive``): ``rx`` (p, L, 260)
    int8, the message from each rank; ``e`` (nbc, p, shard) fp32 or
    None, my slot ``me`` updated. Returns (p L, 260) int8: the
    re-quantized rows ``p`` times."""
    name = "exchange_receive_cuda"
    if rx.dim() != 3 or rx.shape[2] != BLOCK + 4:
        raise ValueError(f"{name}: rx must be (p, L, {BLOCK + 4}), got "
                         f"{tuple(rx.shape)}")
    p, rows, _ = rx.shape
    if not 1 <= p <= MAX_RANKS or not 0 <= me < p:
        raise ValueError(f"{name}: rank {me} of {p}, takes 1..{MAX_RANKS} "
                         f"ranks")
    _check(name, rx, torch.int8, rx.shape)
    ns = 1
    if e is not None:
        nbc, pe, ns = _chunk(name, e)
        if pe != p or rows > nbc * ns:
            raise ValueError(f"{name}: e {tuple(e.shape)} does not hold "
                             f"{rows} rows of {p} ranks' slots")
        if e.device != rx.device:
            raise ValueError(f"{name}: e on {e.device}, rx on {rx.device}")
    out = torch.empty((p * rows, BLOCK + 4), dtype=torch.int8,
                      device=rx.device)
    if rows == 0:
        return out
    _check_aligned(name, rx, e, out)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(rx.device):
        stream = torch.cuda.current_stream(rx.device).cuda_stream
        err = lib.exchange_receive_int8(
            rx.data_ptr(), out.data_ptr(),
            e.data_ptr() if e is not None else None, rows, p, me, ns,
            stream)
    _raise_on(name, err)
    exchange_receive_cuda.launches += 1
    return out


exchange_receive_cuda.launches = 0


def exchange_decode_cuda(g: torch.Tensor, lens: Sequence[int],
                         x: torch.Tensor) -> torch.Tensor:
    """The decode (see ``ref.exchange_decode``): ``g`` (sum lens, 260)
    int8, ``lens[j]`` rows of rank j's in rank order; writes all of
    ``x`` (nbc, p, shard) fp32. Returns ``x``."""
    name = "exchange_decode_cuda"
    nbc, p, ns = _chunk(name, x)
    lens = [int(n) for n in lens]
    if len(lens) != p or any(not 0 <= n <= nbc * ns for n in lens):
        raise ValueError(f"{name}: lens {lens} for {p} slots of "
                         f"{nbc * ns} rows")
    _check(name, g, torch.int8, (sum(lens), BLOCK + 4))
    if g.device != x.device:
        raise ValueError(f"{name}: g on {g.device}, x on {x.device}")
    _check_aligned(name, g, x)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.exchange_decode_int8(g.data_ptr(), x.data_ptr(), nbc, p,
                                       ns, _lens(lens), stream)
    _raise_on(name, err)
    exchange_decode_cuda.launches += 1
    return x


exchange_decode_cuda.launches = 0
