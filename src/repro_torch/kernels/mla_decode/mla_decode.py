"""Hand-written CUDA absorbed-MLA decode kernels and their plain versions.

  * :func:`mla_decode_cuda` — decode over a contiguous latent cache
    (``csrc/mla_decode.cu::mla_decode_fwd``), replacing the JAX
    package's ``mla_decode_pallas``: the decode attention of MLA's
    static path (``static_generate``).
  * :func:`mla_decode_paged_cuda` — the same over a paged latent pool
    with the block-table gather inside the kernel
    (``csrc/mla_decode.cu::mla_decode_paged_fwd``), replacing
    ``mla_decode_paged_pallas``: the decode attention of MLA serving.

Both read each tile of latent positions once and use it for the scores
and for the values; no (B, H, S) tensor reaches device memory. In bf16
both run one tensor-core kernel with the positions split across blocks
(``SPLIT`` a split, merged in split order), which differs between the
two caches only in where a position's row lies;
:func:`mla_decode_split_plain` and :func:`mla_decode_paged_split_plain`
model that arithmetic for the tests. fp32 keeps the CUDA-core kernel.
Each wrapper runs its plain version (``ref.mla_decode_online_plain``,
``ref.mla_decode_paged_online_plain``) when, and only when, its tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises. Each
counts its launches in ``.launches``. The kernels are built for the
latent rank and RoPE width of deepseek-v2 (``RANK``, ``ROPE_DIM``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    _DTYPE_CODES, _check_cuda, _raise_on)
from repro_torch.kernels.mla_decode import ref

RANK = 512          # latent rank r the kernels are built for
ROPE_DIM = 64       # RoPE width Dr the kernels are built for
# positions a split of the bf16 kernels and a tile of their ring
# (csrc/mla_decode.cu; held equal to mla_decode_paged_split_len and
# mla_decode_paged_tile)
SPLIT = 128
TILE = 64
PART = RANK + 4     # floats a partial of a split: acc, m, l, 2 of padding
_LOG2E = 1.4426950408889634


def mla_splits(mb: int, bs: int) -> int:
    """Splits of the bf16 kernels over a window of ``mb * bs`` positions
    (the contiguous cache: ``mla_splits(1, S)``): a shape, never the
    lengths."""
    return -(-mb * bs // SPLIT)


def _split_plain(q_abs, q_r, rows, kv_lens, window: int, dtype,
                 scale: float) -> torch.Tensor:
    """The bf16 kernels' arithmetic over sequence i's first n positions,
    ``rows(i, n) -> (ckv (n, r), kr (n, Dr))`` in the cache dtype ``dtype``:
    the window min(kv_lens, ``window``) cut into splits of ``SPLIT``
    positions from position 0, each an online softmax in fp32 (log2
    units) over tiles of ``TILE`` positions; scores are fp32 sums of the
    inputs' products, scaled after the sum; p is rounded to the cache
    dtype once a tile before the value product; the splits that hold
    positions are merged in split order and the output is acc / max(l,
    1e-30) in fp32. Each sequence is computed on its own, as each of the
    kernel's blocks is, so its result depends on its own q, rows and
    length only."""
    b, h, r = q_abs.shape
    sl2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E
    out = torch.zeros((b, h, r), dtype=torch.float32, device=q_abs.device)
    for i in range(b):
        n_pos = min(int(kv_lens[i]), window)
        ckv, kr = rows(i, n_pos)
        kw = torch.cat([ckv, kr], dim=-1).float()            # (len, 576)
        q = torch.cat([q_abs[i], q_r[i]], dim=-1).float()    # (H, 576)
        m = l = acc = None
        for s0 in range(0, n_pos, SPLIT):
            ms = torch.full((h,), float("-inf"), device=q.device)
            ls = torch.zeros((h,), device=q.device)
            accs = torch.zeros((h, r), device=q.device)
            for t0 in range(s0, min(s0 + SPLIT, n_pos), TILE):
                t1 = min(t0 + TILE, s0 + SPLIT, n_pos)
                x = (q @ kw[t0:t1].t()) * sl2     # dead positions: -inf,
                mn = torch.maximum(ms, x.amax(-1))      # p = 0 (omitted)
                p = torch.exp2(x - mn[:, None])
                c = torch.exp2(ms - mn)
                pv = p.to(dtype).float() @ ckv[t0:t1].float()
                ls = ls * c + p.sum(-1)
                accs = accs * c[:, None] + pv
                ms = mn
            if m is None:
                m, l, acc = ms, ls, accs
                continue
            mn = torch.maximum(m, ms)
            c0, c1 = torch.exp2(m - mn), torch.exp2(ms - mn)
            l = l * c0 + ls * c1
            acc = acc * c0[:, None] + accs * c1[:, None]
            m = mn
        if acc is not None:
            out[i] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def mla_decode_split_plain(q_abs, q_r, ckv, kr, kv_len, scale: float
                           ) -> torch.Tensor:
    """The bf16 contiguous kernel's arithmetic in plain PyTorch, for the
    tests (:func:`_split_plain`): sequence b's positions are the rows
    ``ckv[b, :kv_len[b]]``, within a window of S."""
    return _split_plain(q_abs, q_r, lambda i, n: (ckv[i, :n], kr[i, :n]),
                        kv_len, ckv.shape[1], ckv.dtype, scale)


def mla_decode_paged_split_plain(q_abs, q_r, ckv_pool, kr_pool,
                                 block_tables, kv_lens, scale: float
                                 ) -> torch.Tensor:
    """The bf16 paged kernel's arithmetic in plain PyTorch, for the tests
    (:func:`_split_plain`): sequence b's positions are gathered through
    its table row, within a window of MB * bs; rows of entries outside
    [0, N) are zeros (they score 0 and count in the denominator)."""
    def rows(i, n):
        tbl = block_tables[i:i + 1]
        return (ref.gather_blocks(ckv_pool, tbl)[0, :n],
                ref.gather_blocks(kr_pool, tbl)[0, :n])
    return _split_plain(q_abs, q_r, rows, kv_lens,
                        block_tables.shape[1] * ckv_pool.shape[1],
                        ckv_pool.dtype, scale)


def _check_mla(name, q_abs, q_r, ckv, kr, lens, *more):
    """Common checks; returns (B, H)."""
    _check_cuda(name, q_abs.dtype, q_abs, q_r, ckv, kr, lens, *more)
    if any(t.dtype != q_abs.dtype for t in (q_r, ckv, kr)):
        raise TypeError(f"{name}: q_abs, q_r and the caches must share a "
                        f"dtype")
    if any(t.dtype != torch.int32 for t in (lens, *more)):
        raise TypeError(f"{name}: lengths and block tables must be int32")
    if any(t.data_ptr() % 16 for t in (q_abs, q_r, ckv, kr)):
        raise ValueError(f"{name}: q and cache tensors must start on a "
                         f"16-byte boundary (vector loads)")
    b, h, r = q_abs.shape
    if (r != RANK or q_r.shape != (b, h, ROPE_DIM)
            or ckv.shape[-1] != RANK or kr.shape[-1] != ROPE_DIM
            or ckv.shape[:-1] != kr.shape[:-1] or lens.shape != (b,)):
        raise ValueError(
            f"{name}: built for r={RANK}, Dr={ROPE_DIM}; got q_abs "
            f"{tuple(q_abs.shape)} q_r {tuple(q_r.shape)} ckv "
            f"{tuple(ckv.shape)} kr {tuple(kr.shape)} lens "
            f"{tuple(lens.shape)}")
    return b, h


def mla_decode_cuda(q_abs: torch.Tensor, q_r: torch.Tensor,
                    ckv: torch.Tensor, kr: torch.Tensor,
                    kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q_abs (B, H, r), q_r (B, H, Dr), ckv (B, S, r), kr (B, S, Dr) in
    one dtype (fp32 or bf16); kv_len (B,) int32 >= 1 (positions >=
    kv_len[b] are masked). Returns (B, H, r) fp32. In bf16 the kernel
    splits the positions across blocks and merges the partials (a
    scratch of (B, H, splits, PART) fp32) in split order: one count in
    ``.launches`` for its two launches."""
    if q_abs.device.type == "cpu":
        return ref.mla_decode_online_plain(q_abs, q_r, ckv, kr, kv_len,
                                           scale)
    name = "mla_decode_cuda"
    b, h = _check_mla(name, q_abs, q_r, ckv, kr, kv_len)
    s = ckv.shape[1]
    if ckv.shape[0] != b or s <= 0:
        raise ValueError(f"{name}: ckv {tuple(ckv.shape)} for B={b}")
    out = torch.empty((b, h, RANK), dtype=torch.float32,
                      device=q_abs.device)
    if b == 0 or h == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    splits = mla_splits(1, s)
    part = None
    if q_abs.dtype == torch.bfloat16:   # the split kernel's partials
        part = torch.empty((b, h, splits, PART), dtype=torch.float32,
                           device=q_abs.device)
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        err = lib.mla_decode_fwd(
            q_abs.data_ptr(), q_r.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, b, h, RANK,
            ROPE_DIM, s, splits, float(scale), _DTYPE_CODES[q_abs.dtype],
            stream)
    _raise_on(name, err)
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0


def mla_decode_paged_cuda(q_abs: torch.Tensor, q_r: torch.Tensor,
                          ckv_pool: torch.Tensor, kr_pool: torch.Tensor,
                          block_tables: torch.Tensor, kv_lens: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q_abs (B, H, r), q_r (B, H, Dr), pools (N, bs, r) and (N, bs, Dr)
    in one dtype; block_tables (B, MB) int32 with NULL == N; kv_lens (B,)
    int32 effective lengths >= 1. Table entries outside [0, N) act as
    blocks of zeros and are never read. Returns (B, H, r) fp32. In bf16
    the kernel splits the positions across blocks and merges the
    partials (a scratch of (B, H, splits, PART) fp32) in split order:
    one count in ``.launches`` for its two launches."""
    if q_abs.device.type == "cpu":
        return ref.mla_decode_paged_online_plain(
            q_abs, q_r, ckv_pool, kr_pool, block_tables, kv_lens, scale)
    name = "mla_decode_paged_cuda"
    b, h = _check_mla(name, q_abs, q_r, ckv_pool, kr_pool, kv_lens,
                      block_tables)
    n, bs = ckv_pool.shape[:2]
    if (block_tables.ndim != 2 or block_tables.shape[0] != b
            or block_tables.shape[1] <= 0 or n <= 0 or bs <= 0):
        raise ValueError(f"{name}: tables {tuple(block_tables.shape)} and "
                         f"pool {tuple(ckv_pool.shape)} for B={b}")
    out = torch.empty((b, h, RANK), dtype=torch.float32,
                      device=q_abs.device)
    if b == 0 or h == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    mb = block_tables.shape[1]
    splits = mla_splits(mb, bs)
    part = None
    if q_abs.dtype == torch.bfloat16:   # the split kernel's partials
        part = torch.empty((b, h, splits, PART), dtype=torch.float32,
                           device=q_abs.device)
    with torch.cuda.device(q_abs.device):
        stream = torch.cuda.current_stream(q_abs.device).cuda_stream
        err = lib.mla_decode_paged_fwd(
            q_abs.data_ptr(), q_r.data_ptr(), ckv_pool.data_ptr(),
            kr_pool.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            b, h, RANK, ROPE_DIM, n, bs, mb, splits, float(scale),
            _DTYPE_CODES[q_abs.dtype], stream)
    _raise_on(name, err)
    mla_decode_paged_cuda.launches += 1
    return out


mla_decode_paged_cuda.launches = 0
