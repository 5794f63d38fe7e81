"""Hand-written CUDA attention kernels and their plain PyTorch versions.

  * :func:`flash_attention_cuda` — causal GQA flash-attention forward
    (``csrc/flash_attention.cu``), replacing the JAX package's
    ``flash_attention_pallas``; head dim 64, 80 (zamba2's shared
    block), 128 or 192 (MLA prefill),
    optionally with the row log-sum-exp. Used by prefill and by
    training. bf16 runs on the tensor cores (wgmma) with p fed to the
    P·V product as a bf16 pair; :func:`flash_attention_tiled_plain`
    models that arithmetic for the tests. fp32 keeps the CUDA-core
    kernel.
  * :func:`flash_attention_bwd_cuda` — its recompute backward
    (``csrc/flash_attention_bwd.cu``), held against ``ref.py::_flash_bwd``
    (the Pallas kernel has no backward); head dim 64, 80 (zamba2's
    shared block), 128 or 192 (MLA training). bf16 runs on the tensor
    cores (wgmma; at 80 on tiles padded to 128 columns), p and ds rounded to
    bf16 once as the reference rounds them (at 192 the dk/dv pass's two
    warpgroups split the two outputs, which leaves each sum's order as
    it is); :func:`flash_attention_bwd_tiled_plain` models that
    arithmetic for the tests. fp32 keeps the CUDA-core kernels.
  * :class:`FlashAttentionFn` — the two as one ``torch.autograd.Function``.
  * :func:`flash_decode_paged_cuda` — single-query GQA decode over a
    paged pool with the block-table gather inside the kernel
    (``csrc/paged_decode.cu``), replacing ``flash_decode_paged_pallas``;
    head dim 64 (tinyllama) or 128 (glm4-9b, phi4-mini, arctic), as the
    Pallas kernel reads its head dim from q. The positions are split across blocks (``DECODE_SPLIT`` a split) and
    the partials merged in split order, so a sequence's bits do not
    depend on the batch; :func:`flash_decode_paged_split_plain` models
    the split and the merge. One design for both dtypes.

Each wrapper runs its plain PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`, :func:`flash_decode_paged_plain`) when,
and only when, its tensors lie on the CPU. For CUDA tensors it launches
the kernel or raises. Each wrapper counts its launches in ``.launches``,
a plain integer that a caller may reset, so a run can show that it went
through the kernel (the backward wrapper counts one per call, which is
two kernel launches: the dq pass, then the dk/dv pass). The kernels
launch on PyTorch's current stream and do not synchronise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PREFILL_HEAD_DIMS = (64, 80, 128, 192)   # head dims of the forward kernel
BWD_HEAD_DIMS = (64, 80, 128, 192)   # head dims of the backward kernel
DECODE_HEAD_DIMS = (64, 128)   # head dims the decode kernel is built for
MAX_GROUP = 16         # most query heads per kv head the decode kernel takes
# kv positions a tile of the bf16 forward kernel, by head dim
# (csrc/flash_attention.cu, Sm90Tiles; chip_smoke.py and the card tests
# hold it equal to flash_attention_fwd_sm90_kv_tile)
KV_TILES = {64: 64, 80: 64, 128: 64, 192: 32}
# tiles of the bf16 backward kernels, by head dim: (q rows a dq-pass
# block, kv positions a dq-pass tile, keys a dk/dv-pass block, q rows a
# dk/dv-pass tile) (csrc/flash_attention_bwd.cu, BwdTiles; held equal to
# flash_attention_bwd_sm90_tile)
BWD_TILES = {64: (64, 64, 64, 64), 80: (64, 64, 64, 64),
             128: (64, 64, 64, 64), 192: (64, 64, 64, 64)}
# positions a split of the decode kernel and a stage of its ring
# (csrc/paged_decode.cu; held equal to paged_decode_split_len)
DECODE_SPLIT = 64
DECODE_TILE = 32
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0,
                          softmax_scale=None, return_lse=False):
    """Plain version of the prefill kernel: the dense oracle (with
    ``return_lse``, also its lse (B, Sq, H) fp32)."""
    return ref.mha_dense(q, k, v, causal=causal, q_offset=q_offset,
                         softmax_scale=softmax_scale, want_lse=return_lse)


def flash_attention_tiled_plain(q, k, v, *, causal=True, q_offset=0,
                                softmax_scale=None, return_lse=False,
                                split_p=True):
    """The bf16 kernel's arithmetic in plain PyTorch, for the tests: fp32
    scores of q k^T, scaled after the product (in log2 units); an online
    softmax over the kernel's kv tiles (``KV_TILES``) with fp32 (m, l);
    p as the bf16 pair hi = bf16(p), lo = bf16(p - hi), each times v
    summed in fp32 (``split_p=False``: p rounded to bf16 once); the
    output times 1 / max(l, 1e-30), in q's dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    block_kv = KV_TILES[d]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qf = q.float().transpose(1, 2)                          # (B, H, Sq, D)
    kf = ref._repeat_kv(k, h // hkv).float().transpose(1, 2)
    vf = ref._repeat_kv(v, h // hkv).float().transpose(1, 2)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, sq), -1e30, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, skv, block_kv):
        k1 = min(k0 + block_kv, skv)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * (scale * _LOG2E)
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(kpos > qpos, float("-inf"))
        mn = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - mn[..., None])
        corr = torch.exp2(m - mn)
        l = l * corr + p.sum(dim=-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k1]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k1]
        acc = acc * corr[..., None] + pv
        m = mn
    lc = torch.clamp(l, min=1e-30)
    out = (acc * (1.0 / lc)[..., None]).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, (m * _LN2 + torch.log(lc)).transpose(1, 2)
    return out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              q_offset=0, softmax_scale=None):
    """Plain version of the backward kernel: ``ref.flash_bwd_ref``."""
    return ref.flash_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                             q_offset=q_offset, softmax_scale=softmax_scale)


def flash_attention_bwd_tiled_plain(q, k, v, out, lse, dout, *,
                                    causal=True, q_offset=0,
                                    softmax_scale=None):
    """The bf16 backward kernels' arithmetic in plain PyTorch, for the
    tests: Dv = rowsum(dout * out) in fp32; fp32 products of the input
    tiles; p = exp2(s * scale * log2e - lse * log2e), masked; ds = p (dp -
    Dv) scale; p rounded to q's dtype once before the dv product and ds
    before the dq and dk products; dq summed over the kernel's kv tiles
    in order, dk and dv over the group's query heads in order and, within
    a head, over the kernel's q tiles in order (``BWD_TILES``). Returns
    (dq, dk, dv) in q's dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    _, kv_tile, _, q_tile = BWD_TILES[d]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    sl2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E
    dev = q.device
    qf, dof = (x.float().transpose(1, 2) for x in (q, dout))  # (B, H, Sq, D)
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))      # (B, Hkv, ..)
    dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, Sq)
    lse2 = (lse.float() * _LOG2E).transpose(1, 2)
    qpos = torch.arange(sq, device=dev) + q_offset
    kpos = torch.arange(skv, device=dev)

    def p_ds(s, dp, l2, dv_, mask):
        p = torch.exp2(s * sl2 - l2).masked_fill(mask, 0.0)
        return p, p * (dp - dv_) * scale

    # dq pass: a row's kv tiles in order
    kr, vr = (x.repeat_interleave(group, dim=1) for x in (kf, vf))
    dq = torch.zeros((b, h, sq, d), device=dev)
    for k0 in range(0, skv, kv_tile):
        k1 = min(k0 + kv_tile, skv)
        mask = (kpos[None, k0:k1] > qpos[:, None]) if causal else \
            torch.zeros((sq, k1 - k0), dtype=torch.bool, device=dev)
        _, ds = p_ds(qf @ kr[:, :, k0:k1].transpose(-1, -2),
                     dof @ vr[:, :, k0:k1].transpose(-1, -2),
                     lse2[..., None], dvec[..., None], mask)
        dq = dq + ds.to(q.dtype).float() @ kr[:, :, k0:k1]
    # dk/dv pass: the group's heads in order, a head's q tiles in order
    dk = torch.zeros((b, hkv, skv, d), device=dev)
    dv = torch.zeros((b, hkv, skv, d), device=dev)
    for g in range(group):
        heads = torch.arange(hkv, device=dev) * group + g
        qg, dog, lg, dvg = qf[:, heads], dof[:, heads], lse2[:, heads], \
            dvec[:, heads]
        for q0 in range(0, sq, q_tile):
            q1 = min(q0 + q_tile, sq)
            mask = (kpos[:, None] > qpos[None, q0:q1]) if causal else \
                torch.zeros((skv, q1 - q0), dtype=torch.bool, device=dev)
            p, ds = p_ds(kf @ qg[:, :, q0:q1].transpose(-1, -2),
                         vf @ dog[:, :, q0:q1].transpose(-1, -2),
                         lg[:, :, None, q0:q1], dvg[:, :, None, q0:q1], mask)
            dv = dv + p.to(q.dtype).float() @ dog[:, :, q0:q1]
            dk = dk + ds.to(q.dtype).float() @ qg[:, :, q0:q1]
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, kv_lens, *,
                             softmax_scale=None):
    """Plain version of the decode kernel: materialize-then-attend."""
    return ref.paged_decode_ref(q, k_pool, v_pool, block_tables, kv_lens,
                                softmax_scale=softmax_scale)


def decode_splits(mb: int, bs: int) -> int:
    """Splits of the decode kernel over a window of ``mb * bs``
    positions: a shape, never the lengths."""
    return -(-mb * bs // DECODE_SPLIT)


def flash_decode_paged_split_plain(q, k_pool, v_pool, block_tables,
                                   kv_lens, *, softmax_scale=None):
    """The decode kernel's arithmetic in plain PyTorch, for the tests:
    the window min(kv_lens, MB * bs) cut into splits of ``DECODE_SPLIT``
    positions from position 0, each an online softmax in fp32 (log2
    units) over stages of ``DECODE_TILE`` positions, rows of NULL pages
    zero (they score 0 and count in the denominator); the splits that
    hold positions merged in split order; the output acc * (1 / l) in
    q's dtype. A sequence's result depends on its own q, table row and
    length only."""
    b, _, h, d = q.shape
    n, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    group = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    sl2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E
    window = mb * bs
    lens = torch.clamp(kv_lens.long(), max=window)
    tables = block_tables.long()
    mapped = (tables >= 0) & (tables < n)
    idx = torch.where(mapped, tables, torch.zeros_like(tables))

    def window_of(pool):                   # (B, Hkv, MB * bs, D) fp32
        g = torch.where(mapped[:, :, None, None, None], pool[idx].float(),
                        0.0)
        return g.reshape(b, window, hkv, d).transpose(1, 2)

    kw, vw = window_of(k_pool), window_of(v_pool)
    qf = q.float().reshape(b, hkv, group, d)
    pos = torch.arange(window, device=q.device)
    parts = []
    for s0 in range(0, window, DECODE_SPLIT):
        s1 = min(s0 + DECODE_SPLIT, window)
        m = torch.full((b, hkv, group), float("-inf"), device=q.device)
        l = torch.zeros((b, hkv, group), device=q.device)
        acc = torch.zeros((b, hkv, group, d), device=q.device)
        for t0 in range(s0, s1, DECODE_TILE):
            t1 = min(t0 + DECODE_TILE, s1)
            live = (pos[None, t0:t1] < lens[:, None])[:, None, None, :]
            x = (qf @ kw[:, :, t0:t1].transpose(-1, -2)) * sl2
            x = x.masked_fill(~live, float("-inf"))
            seen = (t0 < lens)[:, None, None]          # the kernel's tiles
            mn = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - mn[..., None])
            c = torch.exp2(m - mn)
            l = torch.where(seen, l * c + p.sum(-1), l)
            acc = torch.where(seen[..., None],
                              acc * c[..., None] + p @ vw[:, :, t0:t1], acc)
            m = torch.where(seen, mn, m)
        parts.append((m, l, acc, (s0 < lens)[:, None, None]))
    m, l, acc, _ = parts[0]
    for ms, ls, accs, live in parts[1:]:
        mn = torch.maximum(m, ms)
        c0, c1 = torch.exp2(m - mn), torch.exp2(ms - mn)
        l = torch.where(live, l * c0 + ls * c1, l)
        acc = torch.where(live[..., None],
                          acc * c0[..., None] + accs * c1[..., None], acc)
        m = torch.where(live, mn, m)
    out = acc * (1.0 / l)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_aligned(name: str, *tensors: torch.Tensor):
    """The bf16 kernels and the decode kernel copy 16-byte chunks: every
    base address must be 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def flash_attention_cuda(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Causal GQA flash attention; returns (B, Sq, H, D) in q's dtype, and
    with ``return_lse`` also the row log-sum-exp (B, Sq, H) fp32.

    kv positions ``>= Skv`` do not exist; with ``causal`` q row ``i``
    (absolute position ``i + q_offset``) sees kv positions ``<= i +
    q_offset``. Every row must see at least one key (true for causal
    attention with ``q_offset >= 0``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     softmax_scale=softmax_scale,
                                     return_lse=return_lse)
    name = "flash_attention_cuda"
    b, sq, h, d, skv, hkv = _check_attention(name, PREFILL_HEAD_DIMS, q, k,
                                             v, q_offset)
    if q.dtype == torch.bfloat16:
        _check_aligned(name, q, k, v)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, sq, skv, h, hkv, d, int(bool(causal)), int(q_offset),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def _check_attention(name, dims, q, k, v, q_offset, *more):
    _check_cuda(name, q.dtype, q, k, v, *more)
    b, sq, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ")
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d not in dims or hkv <= 0 or h % hkv:
        raise ValueError(f"{name}: needs D in {dims} and "
                         f"H % Hkv == 0, got D={d} H={h} Hkv={hkv}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0")
    return b, sq, h, d, skv, hkv


def flash_attention_bwd_cuda(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Skv, Hkv, D)
    v: torch.Tensor,
    out: torch.Tensor,                   # (B, Sq, H, D) forward output
    lse: torch.Tensor,                   # (B, Sq, H) fp32 forward lse
    dout: torch.Tensor,                  # (B, Sq, H, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
):
    """Recompute backward of :func:`flash_attention_cuda`: returns (dq,
    dk, dv) in q's dtype. Deterministic: no float atomics (dq in one
    pass, dk/dv summed over each GQA group inside one block in a
    second). bf16 runs on the tensor cores and needs 16-byte-aligned
    tensors; fp32 on the CUDA cores."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, q_offset=q_offset,
                                         softmax_scale=softmax_scale)
    name = "flash_attention_bwd_cuda"
    b, sq, h, d, skv, hkv = _check_attention(name, BWD_HEAD_DIMS, q, k, v,
                                             q_offset, out, lse, dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} differ from q "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"{name}: out/dout dtypes differ from q")
    if lse.dtype != torch.float32 or lse.shape != (b, sq, h):
        raise ValueError(f"{name}: lse must be fp32 {(b, sq, h)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.dtype == torch.bfloat16:
        _check_aligned(name, q, k, v, out, dout)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dvec = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, h, hkv, d, int(bool(causal)), int(q_offset),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with its lse,
    the backward kernel for the gradients (their plain versions for CPU
    tensors). Saves (q, k, v, out, lse) and nothing of size Sq x Skv.
    Under activation checkpointing the forward runs again in the
    recompute and the backward reads that run's lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, softmax_scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        q_offset=q_offset,
                                        softmax_scale=softmax_scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, softmax_scale = ctx.args
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            q_offset=q_offset, softmax_scale=softmax_scale)
        return dq, dk, dv, None, None, None


def flash_decode_paged_cuda(
    q: torch.Tensor,                     # (B, 1, H, D)
    k_pool: torch.Tensor,                # (N, bs, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, MB) int32, NULL == N
    kv_lens: torch.Tensor,               # (B,) int32 effective lengths
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-query GQA decode over a paged pool; returns (B, 1, H, D).

    ``kv_lens`` are effective lengths (>= 1; positions ``>= kv_lens[b]``
    are masked) and the new token's K/V must already be in the pool.
    Table entries outside ``[0, N)`` act as blocks of zeros and are
    never read. The pools must be 16-byte aligned. A sequence's output
    does not depend on the rest of the batch or on MB beyond its
    length (the positions split from 0 in ``DECODE_SPLIT``s, merged in
    order)."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, block_tables,
                                        kv_lens,
                                        softmax_scale=softmax_scale)
    name = "flash_decode_paged_cuda"
    _check_cuda(name, q.dtype, q, k_pool, v_pool, block_tables, kv_lens)
    b, sq, h, d = q.shape
    n, bs, hkv, dk = k_pool.shape
    if sq != 1:
        raise ValueError(f"{name}: expects a single query, got {sq}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q/pool dtypes differ")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and kv_lens must be int32")
    if (v_pool.shape != k_pool.shape or dk != d or block_tables.ndim != 2
            or block_tables.shape[0] != b or kv_lens.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)}"
            f" tables {tuple(block_tables.shape)} lens "
            f"{tuple(kv_lens.shape)} disagree")
    if (d not in DECODE_HEAD_DIMS or hkv <= 0 or h % hkv or h // hkv > MAX_GROUP
            or n <= 0 or bs <= 0 or block_tables.shape[1] <= 0):
        raise ValueError(
            f"{name}: needs D in {DECODE_HEAD_DIMS}, H % Hkv == 0, H/Hkv <= "
            f"{MAX_GROUP} and a non-empty pool, got D={d} H={h} Hkv={hkv} "
            f"N={n} bs={bs} MB={block_tables.shape[1]}")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    _check_aligned(name, k_pool, v_pool)
    mb = block_tables.shape[1]
    splits = decode_splits(mb, bs)
    part = torch.empty((b, h, splits, d + 2), dtype=torch.float32,
                       device=q.device)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, h, hkv, d, n, bs, mb, splits, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(name, err)
    flash_decode_paged_cuda.launches += 1
    return out


flash_decode_paged_cuda.launches = 0
