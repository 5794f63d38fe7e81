"""Hand-written CUDA mLSTM chunked scan and its plain PyTorch version.

:func:`mlstm_scan_cuda` — the xLSTM mLSTM chunkwise-parallel scan from
zero state (``csrc/mlstm_scan.cu``), replacing the JAX package's
``mlstm_scan_pallas``: returns ``h`` in q's dtype and the final (C, n,
m) in fp32. It runs its plain version (:func:`mlstm_scan_plain`,
``ref.mlstm_chunked``) when, and only when, its tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises. It counts its
launches in ``.launches``, a plain integer that a caller may reset (one
a call: in bf16 a call is three kernel launches). The kernels launch on
PyTorch's current stream and do not synchronise.

bf16 runs on the tensor cores in three kernels (chunk states, the state
passing, the chunk scan in tiles of ``ROW_TILE`` rows and ``DV_SLICE``
columns of v), with the three operands made in fp32 inside the kernels
(the weighted keys kw k, the carried state C and the decay-weighted
scores W) fed as bf16 hi/lo pairs; :func:`mlstm_scan_tiled_plain` models
that arithmetic for the tests. fp32 keeps the one CUDA-core kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mlstm_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import _pair

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WIDTH_MULT = 64        # dk and dv must be multiples of this
MAX_DK = 512           # the (dk, 64) fp32 state slice lives in shared memory
MAX_CHUNK = 256        # largest chunk Q (one gate row per thread)
# the bf16 chunk scan's tile (csrc/mlstm_scan.cu; held equal to
# mlstm_scan_sm90_tile): rows a tile, and v's columns a block
ROW_TILE = 64
DV_SLICE = 128
MADE_OPERANDS = ("kw_k", "c_in", "w")


def _terms(v: torch.Tensor, single: bool):
    """An fp32 operand as the kernel feeds it to bf16 products: [hi, lo]
    of its pair, or [hi] alone (``single``, for the record)."""
    return [t for t in _pair(v, "bf16" if single else "pair")
            if t is not None]


def mlstm_scan_tiled_plain(q, k, v, i_pre, f_pre, *, chunk_size: int = 256,
                           single=()):
    """The bf16 kernels' arithmetic in plain PyTorch, for the tests.
    Per chunk, from the gates alone: b the inclusive cumsum of
    logsigmoid(f~), u_j = i~_j - b_j, the intra-chunk stabiliser b_i +
    max_{j<=i} u_j, g = b_last, m_loc = max_j (g + u_j).
    1. chunk states from zero, S_c = (kw k)^T v and n_c = sum_j kw_j k_j,
       kw_j = exp(g + u_j - m_loc), kw k as a bf16 pair;
    2. m_{c+1} = max(g_c + m_c, m_loc_c), C_{c+1} = exp(g_c + m_c -
       m_{c+1}) C_c + exp(m_loc_c - m_{c+1}) S_c and n the same, in chunk
       order, fp32, from C = n = 0, m = -1e30;
    3. per tile of ``ROW_TILE`` rows i: m_i = max(b_i + max_{j<=i} u_j,
       b_i + m), exp(b_i + m - m_i) scale (q_i C_in) with C_in as a bf16
       pair and the same times q_i.n_in, then for each tile j at or below
       i in order W = exp((b_i - m_i) + u_j) (q_i k_j^T) scale (0 for j >
       i), den += W's row sums, + W as a bf16 pair times v_j; h = num /
       max(|den|, exp(-m_i)) rounded to q's dtype once.
    Rows past S read as the Pallas padding (q = k = v = 0, i~ = -1e30,
    f~ = 30). Returns (h, (C, n, m)) as :func:`mlstm_scan_plain`.
    ``single`` names made operands (of ``MADE_OPERANDS``) fed as one
    bf16 rounding instead of a pair, for the record."""
    assert set(single) <= set(MADE_OPERANDS), single
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    cq = min(int(chunk_size), s)
    nc = -(-s // cq)
    pad = nc * cq - s

    def heads(t, value=0.0):           # (B, S, H, F) -> (B, H, nc, cq, F)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad),
                                    value=value)
        return t.reshape(b, nc, cq, h, -1).permute(0, 3, 1, 2, 4)

    qf, kf, vf = heads(q), heads(k), heads(v)
    ig = heads(i_pre[..., None], ref.NEG_BIG)[..., 0]  # (B, H, nc, cq)
    fg = heads(f_pre[..., None], ref.PAD_F)[..., 0]
    bcs = torch.cumsum(torch.nn.functional.logsigmoid(fg), dim=-1)
    u = ig - bcs
    m_intra = bcs + torch.cummax(u, dim=-1).values
    g = bcs[..., -1]                                   # (B, H, nc)
    w_st = g[..., None] + u
    m_loc = w_st.amax(dim=-1)
    # 1. chunk states
    kwk = torch.exp(w_st - m_loc[..., None])[..., None] * kf
    s_c = sum(t.transpose(-1, -2) @ vf
              for t in _terms(kwk, "kw_k" in single))   # (B, H, nc, dk, dv)
    n_c = kwk.sum(dim=-2)                              # (B, H, nc, dk)
    # 2. state passing
    C = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), ref.NEG_BIG, dtype=torch.float32,
                   device=q.device)
    c_in, n_in, m_in = [], [], []
    for c in range(nc):
        c_in.append(C)
        n_in.append(n)
        m_in.append(m)
        m_next = torch.maximum(g[..., c] + m, m_loc[..., c])
        a = torch.exp(g[..., c] + m - m_next)
        w = torch.exp(m_loc[..., c] - m_next)
        C = a[..., None, None] * C + w[..., None, None] * s_c[:, :, c]
        n = a[..., None] * n + w[..., None] * n_c[:, :, c]
        m = m_next
    c_pair = _terms(torch.stack(c_in, dim=2), "c_in" in single)
    n_in = torch.stack(n_in, dim=2)                    # (B, H, nc, dk)
    m_in = torch.stack(m_in, dim=2)                    # (B, H, nc)
    # 3. chunk scan, tile by tile
    hs = []
    for i0 in range(0, cq, ROW_TILE):
        i1 = min(i0 + ROW_TILE, cq)
        qi = qf[..., i0:i1, :]
        bi = bcs[..., i0:i1]
        mi = torch.maximum(m_intra[..., i0:i1], bi + m_in[..., None])
        iw = torch.exp(bi + m_in[..., None] - mi) * scale
        num = iw[..., None] * sum(qi @ t for t in c_pair)
        den = iw * (qi @ n_in[..., None])[..., 0]
        for j0 in range(0, i1, ROW_TILE):
            j1 = min(j0 + ROW_TILE, cq)
            causal = (torch.arange(i0, i1)[:, None]
                      >= torch.arange(j0, j1)[None, :])
            expo = (bi - mi)[..., :, None] + u[..., None, j0:j1]
            sc = qi @ kf[..., j0:j1, :].transpose(-1, -2)
            w = torch.where(causal, sc * scale * torch.exp(
                torch.where(causal, expo, 0.0)), 0.0)
            den = den + w.sum(dim=-1)
            num = num + sum(t @ vf[..., j0:j1, :]
                            for t in _terms(w, "w" in single))
        lim = torch.maximum(den.abs(), torch.exp(-mi))
        hs.append(num / lim[..., None])
    hseq = torch.cat(hs, dim=-2)                       # (B, H, nc, cq, dv)
    hseq = hseq.permute(0, 2, 3, 1, 4).reshape(b, nc * cq, h, dv)[:, :s]
    return hseq.to(q.dtype), (C, n, m)


def mlstm_scan_plain(q, k, v, i_pre, f_pre, *, chunk_size: int = 256):
    """Plain version of the kernel: ``ref.mlstm_chunked`` from zero
    state."""
    return ref.mlstm_chunked(q, k, v, i_pre, f_pre, chunk_size=chunk_size)


def mlstm_scan_cuda(
    q: torch.Tensor,                     # (B, S, H, dk) fp32 or bf16
    k: torch.Tensor,                     # (B, S, H, dk) q's dtype
    v: torch.Tensor,                     # (B, S, H, dv) q's dtype
    i_pre: torch.Tensor,                 # (B, S, H) fp32
    f_pre: torch.Tensor,                 # (B, S, H) fp32
    *,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, ref.State]:
    """The mLSTM scan from zero state with chunks of ``min(chunk_size,
    S)`` rows; returns (h (B, S, H, dv) in q's dtype, (C (B, H, dk, dv),
    n (B, H, dk), m (B, H)) in fp32). The kernels take dk and dv that
    are multiples of 64, dk <= 512 and a chunk of at most 256 rows; in
    bf16 also 16-byte-aligned q, k and v and B * H <= 65535."""
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i_pre, f_pre, chunk_size=chunk_size)
    name = "mlstm_scan_cuda"
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in (q, k, v, i_pre, f_pre):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k/v dtypes must be q's ({q.dtype})")
    if i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32:
        raise TypeError(f"{name}: i_pre and f_pre must be float32")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape != (b, s, h, dv)
            or i_pre.shape != (b, s, h) or f_pre.shape != (b, s, h)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} i {tuple(i_pre.shape)} f "
            f"{tuple(f_pre.shape)} disagree")
    chunk = min(int(chunk_size), s)
    if (dk % WIDTH_MULT or dv % WIDTH_MULT or not 0 < dk <= MAX_DK
            or dv <= 0 or (s > 0 and not 0 < chunk <= MAX_CHUNK)):
        raise ValueError(
            f"{name}: needs dk % {WIDTH_MULT} == 0, dv % {WIDTH_MULT} == 0, "
            f"dk <= {MAX_DK} and a chunk of 1..{MAX_CHUNK} rows, got "
            f"dk={dk} dv={dv} chunk={chunk}")
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{name}: bf16 q, k and v must be 16-byte "
                             f"aligned (16-byte copies)")
        if b * h > 65535:
            raise ValueError(f"{name}: bf16 takes B * H <= 65535, got "
                             f"{b * h}")
    out = torch.empty_like(v)
    C = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or s == 0:
        return out, (C.zero_(), n.zero_(), m.fill_(ref.NEG_BIG))
    from repro_torch.kernels import _build
    lib = _build.load()
    work = None
    if q.dtype == torch.bfloat16:
        # per-chunk states and n, the incoming C's pairs, gate records
        nc = -(-s // chunk)
        work = torch.empty(
            (b * h * nc * (dk * (2 * dv + 1) + 4 + 3 * chunk),),
            dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mlstm_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), out.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), work.data_ptr() if work is not None else None, b,
            s, h, dk, dv, chunk, dk ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    mlstm_scan_cuda.launches += 1
    return out, (C, n, m)


mlstm_scan_cuda.launches = 0
