"""Plain PyTorch per-block int8 quantization (gradient compression)
(port of ``repro/kernels/quantize/ref.py``).

The plain versions of the CUDA kernels in ``csrc/quantize.cu``, and the
CPU path of ``ops.py``. They keep the JAX oracle's order of operations
so that the codes and scales are bitwise those of JAX and of the
kernels: ``scale = max(absmax / 127, 1e-12)`` with a true division by a
tensor (PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal), ``x / scale`` (a division), round half to even, clip.
Stochastic rounding takes the uniform noise as an argument instead of a
key: ``jax.random`` and ``torch.Generator`` give different numbers, so
the caller draws it (the JAX package draws it inside the op).

The bucketed exchange's wire format lives here too: :func:`fuse_payload`
(a block's codes, then its scale's 4 bytes) and the order of a chunk's
rows on the wire (:func:`message_rows`, :func:`wire_rows`). Its three
legs, :func:`exchange_send`, :func:`exchange_receive` and
:func:`exchange_decode`, are the plain versions of the fused kernels
(the exchange's values are these functions' bits on every device).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def to_blocks(x: torch.Tensor, block_size: int = 256) -> torch.Tensor:
    """Flatten to fp32 and zero-pad to whole blocks: (nb, block_size)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_size)


def quantize_blocks(blocks: torch.Tensor,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, B) fp32 -> (int8 codes (nb, B), fp32 scales (nb,)); the plain
    version of ``quantize_int8_cuda``. ``noise``: (nb, B) fp32 in [0, 1)
    for stochastic rounding."""
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    scaled = blocks / scale
    if noise is not None:
        scaled = scaled + (noise - 0.5)
    q = torch.clamp(torch.round(scaled), -127, 127)
    return q.to(torch.int8), scale[:, 0]


def quantize_int8(x: torch.Tensor, *, block_size: int = 256,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any shape, flattened -> (int8 values (nb, B), fp32 per-block
    scales (nb,)); the tail of the last block is zero padding."""
    return quantize_blocks(to_blocks(x, block_size), noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], block_size: int = 256
                    ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= int(d)
    return flat[:n].reshape(tuple(shape))


def dequant_accum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``sum_r q[r] * scale[r]`` for q (R, nb, B) int8 and scale (R, nb)
    fp32 -> (nb, B) fp32; the plain version of ``dequant_accum_cuda``.
    A loop over ranks in order from a zero accumulator, one rounded
    product and one rounded sum per rank, as the kernel does (the JAX
    oracle is an einsum: equal to rounding)."""
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for r in range(q.shape[0]):
        acc = acc + q[r].to(torch.float32) * scale[r].to(torch.float32)[:,
                                                                        None]
    return acc


# --------------------------------------------------------------------------
# the bucketed exchange's wire format and legs
# --------------------------------------------------------------------------


def fuse_payload(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Int8 values + fp32 scales as ONE int8 wire buffer: each block's
    ``block_size`` codes followed by its scale's 4 bytes (bit-cast,
    native byte order), (..., blocks, block_size + 4). Byte-equal to the
    JAX package's payload on current jax (``NATIVE_MANUAL_COLLECTIVES``)."""
    s_bytes = s.to(torch.float32).contiguous().view(torch.int8).reshape(
        *s.shape, 4)
    return torch.cat([q, s_bytes], dim=-1)


def split_payload(payload: torch.Tensor, block_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`fuse_payload`: -> (q int8, s fp32)."""
    if payload.dtype != torch.int8:
        raise TypeError(f"split_payload: int8 payload expected, got "
                        f"{payload.dtype}")
    q = payload[..., :block_size]
    s = payload[..., block_size:].contiguous().view(torch.float32)
    return q, s[..., 0]


def message_rows(nbc: int, p: int, ns: int, d_rows: int) -> List[int]:
    """Data rows (blocks) of the message to each rank, for an exchange
    chunk of ``nbc`` buckets over ``p`` ranks, ``ns`` blocks a shard:
    message j holds the rows (k, j, b) of every bucket k of the chunk,
    and the data rows (stream row < d_rows) are a prefix of it."""
    return [sum(min(ns, max(0, d_rows - (k * p + j) * ns))
                for k in range(nbc)) for j in range(p)]


def wire_rows(nbc: int, p: int, ns: int, lens: Sequence[int],
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The stream row of each row of a wire that holds ``lens[j]`` rows
    of message j, the messages in rank order: (k, j, b) with k ns + b <
    lens[j], as ``(k p + j) ns + b``."""
    parts = [torch.zeros(0, dtype=torch.long, device=device)]
    for j, n in enumerate(lens):
        t = torch.arange(int(n), device=device)
        parts.append((t // ns * p + j) * ns + t % ns)
    return torch.cat(parts)


def exchange_send(x: torch.Tensor, e: Optional[torch.Tensor], d_rows: int,
                  noise: Optional[torch.Tensor] = None,
                  block_size: int = 256
                  ) -> Tuple[torch.Tensor, List[int]]:
    """The send leg of an exchange chunk ``x`` (nbc, p, shard) fp32; the
    plain version of ``exchange_send_cuda``. Error-corrects the data rows
    (the first ``d_rows`` blocks of the stream: corrected = x + e),
    quantizes them (``noise``, shaped like ``x``, for stochastic
    rounding), writes the stage-1 residual ``corrected - q * s`` into
    ``e`` (the product rounded, then the difference) and zeros ``e``'s
    padding rows. ``x`` is left as it is. Returns (the wire, (d_rows,
    block_size + 4) int8 in message order, and the rows of each
    message)."""
    nbc, p, shard = x.shape
    bs = block_size
    ns = shard // bs
    corrected = x.reshape(-1, bs)[:d_rows]
    if e is not None:
        corrected = corrected + e.view(-1, bs)[:d_rows]
    q, s = quantize_blocks(corrected, None if noise is None
                           else noise.reshape(-1, bs)[:d_rows])
    if e is not None:
        er = e.view(-1, bs)
        torch.sub(corrected, q.to(torch.float32) * s[:, None],
                  out=er[:d_rows])
        er[d_rows:].zero_()
    lens = message_rows(nbc, p, ns, d_rows)
    return fuse_payload(q, s)[wire_rows(nbc, p, ns, lens, x.device)], lens


def exchange_receive(rx: torch.Tensor, e: Optional[torch.Tensor], me: int,
                     block_size: int = 256) -> torch.Tensor:
    """The receive leg; the plain version of ``exchange_receive_cuda``.
    ``rx`` (p, L, block_size + 4) int8: the message from each rank, my
    shard's L data rows. Sums them over the ranks in rank order
    (:func:`dequant_accum`), re-quantizes the sum and adds the stage-2
    residual ``sum - q2 * s2`` (product, difference, sum: three
    roundings) into my slot (``me``) of ``e`` (nbc, p, shard). Returns
    the re-quantized rows' payload ``p`` times, (p L, block_size + 4):
    the gather leg's message to each rank."""
    p, rows, _ = rx.shape
    q_x, s_x = split_payload(rx, block_size)
    total = dequant_accum(q_x, s_x)
    q2, s2 = quantize_blocks(total)
    if e is not None and rows:
        nbc, _, shard = e.shape
        mine = wire_rows(nbc, p, shard // block_size,
                         [rows if j == me else 0 for j in range(p)],
                         e.device)
        er = e.view(-1, block_size)
        er[mine] = er[mine] + (total - q2.to(torch.float32) * s2[:, None])
    return fuse_payload(q2, s2).repeat(p, 1)


def exchange_decode(g: torch.Tensor, lens: Sequence[int], x: torch.Tensor,
                    block_size: int = 256) -> torch.Tensor:
    """The decode; the plain version of ``exchange_decode_cuda``. ``g``
    (sum lens, block_size + 4) int8: every rank's re-quantized shard
    rows, ``lens[j]`` of rank j's, in rank order. Writes all of ``x``
    (nbc, p, shard): slot j's rows q * s, zero past ``lens[j]``. Returns
    ``x``."""
    nbc, p, shard = x.shape
    q, s = split_payload(g, block_size)
    xr = x.view(-1, block_size)
    xr.zero_()
    xr[wire_rows(nbc, p, shard // block_size, lens, x.device)] = (
        q.to(torch.float32) * s[:, None])
    return x
