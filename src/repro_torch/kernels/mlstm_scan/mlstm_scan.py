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

:func:`mlstm_scan_bwd_cuda` — the scan's backward
(``csrc/mlstm_scan_bwd.cu``), with the final state's cotangent taken as
0 (training drops the state). The JAX package has no kernel for it (its
training differentiates ``ref.mlstm_chunked``); its plain version
:func:`mlstm_scan_bwd_plain` writes out the backward's arithmetic step
by step, and runs for CPU tensors. It counts its launches as the
forward does (one a call). bf16 runs on the tensor cores in nine kernel
launches, each causal tile pair's q k^T and dh v^T computed once, with
the operands made in fp32 (kw k, C_in, dS, W/lim, the weighted q, G_c)
fed as bf16 hi/lo pairs; :func:`mlstm_scan_bwd_tiled_plain` models that
arithmetic for the tests. fp32 keeps six CUDA-core kernel launches.
:class:`MLSTMScanFn` joins the forward and the backward as one
``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
# the bf16 backward's tiles (csrc/mlstm_scan_bwd.cu; held equal to
# mlstm_scan_bwd_sm90_tile): rows of a causal pair's tiles, and the
# accumulator columns a pass (64 where 128 does not divide the width)
BWD_ROW_TILE = 64
BWD_PASS = 128


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

    qf, kf, vf = (_heads(t, h, nc, cq, pad) for t in (q, k, v))
    ig = _heads(i_pre[..., None], h, nc, cq, pad, ref.NEG_BIG)[..., 0]
    fg = _heads(f_pre[..., None], h, nc, cq, pad, ref.PAD_F)[..., 0]
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


def _checked(name: str, q, k, v, i_pre, f_pre, chunk_size: int, *,
             dh: Optional[torch.Tensor] = None):
    """The checks both kernels' wrappers make of CUDA inputs: one device,
    contiguous, q (and dh) fp32 or bf16 with k and v in q's dtype, the
    gates fp32, agreeing shapes and the widths the kernels take. Returns
    (B, S, H, dk, dv, the chunk's rows)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in (q, k, v, i_pre, f_pre, dh):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if any(t.dtype != q.dtype for t in (k, v, dh) if t is not None):
        raise TypeError(f"{name}: k/v dtypes (and dh's) must be q's "
                        f"({q.dtype})")
    if i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32:
        raise TypeError(f"{name}: i_pre and f_pre must be float32")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape != (b, s, h, dv)
            or (dh is not None and dh.shape != v.shape)
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
    return b, s, h, dk, dv, chunk


def mlstm_scan_plain(q, k, v, i_pre, f_pre, *, chunk_size: int = 256):
    """Plain version of the kernel: ``ref.mlstm_chunked`` from zero
    state."""
    return ref.mlstm_chunked(q, k, v, i_pre, f_pre, chunk_size=chunk_size)


def _heads(t: torch.Tensor, h: int, nc: int, cq: int, pad: int,
           value: float = 0.0) -> torch.Tensor:
    """(B, S, H, F) -> (B, H, nc, cq, F) fp32, rows past S set to
    ``value``."""
    b = t.shape[0]
    t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad), value=value)
    return t.reshape(b, nc, cq, h, -1).permute(0, 3, 1, 2, 4)


def _unheads(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, nc, cq, F) -> (B, S, H, F), rows past S dropped."""
    b, h, nc, cq, f = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, nc * cq, h, f)[:, :s]


def mlstm_scan_bwd_plain(q, k, v, i_pre, f_pre, dh, *,
                         chunk_size: int = 256):
    """The backward of :func:`mlstm_scan_plain` with the final state's
    cotangent 0, in fp32, as the kernel computes it. It works in the
    forward's stabilised units and holds every stabiliser constant: in
    true units h_i = num_i / max(|den_i|, 1) depends on none of them, so
    their own gradients cancel and nothing is differentiated through a
    max. Per chunk (b the inclusive cumsum of logsigmoid(f~), g its last
    row, u_j = i~_j - b_j, m the incoming stabiliser):

    1. the stabilisers from the gates alone, as the forward takes them:
       m_i = max(b_i + max_{j<=i} u_j, b_i + m), m' = max(g + m, max_j
       (g + u_j)), the carried state's row weight w_i = exp(b_i + m -
       m_i), the keys' state weight kw_j = exp(g - b_j + i~_j - m') and
       the carry exp(g + m - m'), in chunk order from m = -1e30. Each log
       weight is summed as the reference sums it, the difference of two
       b first: b is a running sum of negative terms, so b_i - b_j is
       exact where (b_i - m_i) + u_j would round at b's magnitude, and a
       denominator that cancels (large gates) amplifies that;
    2. the incoming states, C_in[0] = 0 and C_in[c+1] = carry C_in[c] +
       sum_j kw_j k_j v_j^T, n_in the same with v_j -> 1;
    3. per row: with E_ij = exp(b_i - b_j + i~_j - m_i) on the causal half (0
       above it), W = E (q k^T scale) and P = dh v^T, den_i = sum_j W_ij
       + w_i scale q_i.n_in, X_i = C_in dh_i and dh_i.num_i = sum_j
       W_ij P_ij + w_i scale q_i.X_i; lim_i = max(|den_i|, exp(-m_i)),
       dnum_i = dh_i / lim_i, dden_i = -sign(den_i) (dh_i.num_i) /
       lim_i^2 where |den_i| > exp(-m_i), else 0; dW = P / lim + dden;
       dq_i = scale sum_j dW_ij E_ij k_j + w_i scale (X_i / lim_i + dden_i
       n_in), and the log weights' gradient dW W;
    4. the incoming state's gradient from the rows, L_c = sum_i w_i scale
       q_i dnum_i^T (and sum_i w_i scale dden_i q_i for n), then in
       reverse the gradient of each chunk's outgoing state, G_c = (L +
       carry G)_{c+1}, 0 after the last chunk (the final state's
       cotangent), and the carry's log-gradient carry <C_in, G_c> (+ n);
    5. per column: dk_j = scale sum_i dW_ij E_ij q_i + kw_j (G_c v_j +
       G^n_c), dv_j = sum_i W_ij dnum_i + kw_j G_c^T k_j, and kw_j's
       log-gradient kw_j k_j.(G_c v_j + G^n_c);
    6. the gates: di~_j = the column sums of dW W + kw_j's log-gradient;
       b's gradient = the row sums of dW W - its column sums + w_i's
       log-gradient - kw_i's, and at the last row the carry's and every
       kw_j's log-gradient (g); summed in reverse over the chunk (the
       cumsum's transpose) it is logsigmoid(f~)'s, and df~ = that
       sigmoid(-f~).

    Rows past S read as the forward's padding (q = k = v = 0, i~ =
    -1e30, f~ = 30) with dh = 0; their gradients are dropped. Returns
    (dq, dk, dv) in q's dtype and (di~, df~) (B, S, H) in fp32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    cq = min(int(chunk_size), s)
    nc = -(-s // cq)
    pad = nc * cq - s
    qf, kf, vf, dhf = (_heads(t, h, nc, cq, pad) for t in (q, k, v, dh))
    ig = _heads(i_pre[..., None], h, nc, cq, pad, ref.NEG_BIG)[..., 0]
    fg = _heads(f_pre[..., None], h, nc, cq, pad, ref.PAD_F)[..., 0]
    # 1. the stabilisers, as the forward takes them
    bcs = torch.cumsum(torch.nn.functional.logsigmoid(fg), dim=-1)
    u = ig - bcs
    m_intra = bcs + torch.cummax(u, dim=-1).values
    g = bcs[..., -1]                                   # (B, H, nc)
    m_loc = (g[..., None] + u).amax(dim=-1)
    m = torch.full((b, h), ref.NEG_BIG, dtype=torch.float32,
                   device=q.device)
    m_in, m_out = [], []
    for c in range(nc):
        m_in.append(m)
        m = torch.maximum(g[..., c] + m, m_loc[..., c])
        m_out.append(m)
    m_in, m_out = torch.stack(m_in, dim=-1), torch.stack(m_out, dim=-1)
    m_row = torch.maximum(m_intra, bcs + m_in[..., None])
    w_row = torch.exp(bcs + m_in[..., None] - m_row)
    kw = torch.exp(g[..., None] - bcs + ig - m_out[..., None])
    carry = torch.exp(g + m_in - m_out)
    # 2. the incoming states
    s_c = (kw[..., None] * kf).transpose(-1, -2) @ vf  # (B, H, nc, dk, dv)
    n_c = (kw[..., None] * kf).sum(dim=-2)
    C = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    c_in, n_in = [], []
    for c in range(nc):
        c_in.append(C)
        n_in.append(n)
        C = carry[..., c, None, None] * C + s_c[:, :, c]
        n = carry[..., c, None] * n + n_c[:, :, c]
    c_in, n_in = torch.stack(c_in, dim=2), torch.stack(n_in, dim=2)
    # 3. the rows
    ii = torch.arange(cq, device=q.device)
    causal = ii[:, None] >= ii[None, :]
    expo = (bcs[..., :, None] - bcs[..., None, :] + ig[..., None, :]
            - m_row[..., :, None])
    E = torch.where(causal, torch.exp(torch.where(causal, expo, 0.0)), 0.0)
    W = E * (qf @ kf.transpose(-1, -2) * scale)
    P = dhf @ vf.transpose(-1, -2)
    qn = (qf * n_in[..., None, :]).sum(dim=-1)
    X = dhf @ c_in.transpose(-1, -2)                   # (B, H, nc, cq, dk)
    qx = (qf * X).sum(dim=-1)
    den = W.sum(dim=-1) + w_row * scale * qn
    dot = (W * P).sum(dim=-1) + w_row * scale * qx
    lim = torch.maximum(den.abs(), torch.exp(-m_row))
    inv = 1.0 / lim
    dden = torch.where(den.abs() > torch.exp(-m_row),
                       -torch.sign(den) * dot * inv * inv, 0.0)
    dW = torch.where(causal, P * inv[..., None] + dden[..., None], 0.0)
    dS = dW * E * scale
    dD = dW * W
    rw = w_row * scale
    dq = dS @ kf + rw[..., None] * (X * inv[..., None]
                                    + dden[..., None] * n_in[..., None, :])
    d_row_w = rw * (qx * inv + qn * dden)
    # 4. the incoming states' gradients, then the reverse pass
    l_c = (qf * (rw * inv)[..., None]).transpose(-1, -2) @ dhf
    ln_c = (qf * (rw * dden)[..., None]).sum(dim=-2)
    G = torch.zeros_like(C)
    Gn = torch.zeros_like(n)
    g_out, gn_out, d_carry = [None] * nc, [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        g_out[c], gn_out[c] = G, Gn
        d_carry[c] = carry[..., c] * ((c_in[:, :, c] * G).sum(dim=(-1, -2))
                                      + (n_in[:, :, c] * Gn).sum(dim=-1))
        G = l_c[:, :, c] + carry[..., c, None, None] * G
        Gn = ln_c[:, :, c] + carry[..., c, None] * Gn
    g_out, gn_out = torch.stack(g_out, dim=2), torch.stack(gn_out, dim=2)
    d_carry = torch.stack(d_carry, dim=-1)             # (B, H, nc)
    # 5. the columns
    gv = vf @ g_out.transpose(-1, -2) + gn_out[..., None, :]  # (.., cq, dk)
    dkk = dS.transpose(-1, -2) @ qf + kw[..., None] * gv
    dvv = (W * inv[..., None]).transpose(-1, -2) @ dhf + kw[..., None] * (
        kf @ g_out)
    d_kw = kw * (kf * gv).sum(dim=-1)
    # 6. the gates
    col = dD.sum(dim=-2)
    di = col + d_kw
    db = dD.sum(dim=-1) - col + d_row_w - d_kw
    db[..., -1] += d_carry + d_kw.sum(dim=-1)
    dlf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
    df = dlf * torch.sigmoid(-fg)
    return (_unheads(dq, s).to(q.dtype), _unheads(dkk, s).to(q.dtype),
            _unheads(dvv, s).to(q.dtype), _unheads(di[..., None], s)[..., 0],
            _unheads(df[..., None], s)[..., 0])


def mlstm_scan_bwd_tiled_plain(q, k, v, i_pre, f_pre, dh, *,
                               chunk_size: int = 256,
                               rounding: str = "pair"):
    """The bf16 backward kernels' arithmetic in plain PyTorch, for the
    tests; the steps of :func:`mlstm_scan_bwd_plain` on exact bf16 inputs,
    with the operands made in fp32 rounded as the kernels feed them to
    bf16 products and the sums taken in the kernels' tile order:

    1. the stabilisers and weights as the plain version takes them;
    2. the chunk states (kw k)^T v with kw k as a pair, the incoming
       states in chunk order in fp32;
    3. per tile of ``BWD_ROW_TILE`` rows i: X = dh_i C_in^T with C_in as a
       pair, q.X and q.n_in; then each causal pair (i, j <= i) once, in
       order: S = q_i k_j^T and P = dh_i v_j^T of the exact operands, W =
       E S scale, den and dh.num's pair parts; the row scalars; per pair
       dW = P / lim + dden, dS = dW E scale and W / lim, dW W's row sums
       and column sums; dq_i = sum_j dS_ij k_j (dS as a pair) + w scale
       (X / lim + dden n_in);
    4. L = (rw inv q)^T dh with the weighted q as a pair, the outgoing
       states' gradients in reverse in fp32;
    5. per column tile j: dk_j = kw_j (v_j G^T + G^n) + sum_{i >= j}
       dS_ij^T q_i and dv_j = kw_j k_j G + sum_i (W / lim)_ij^T dh_i, G,
       dS and W / lim as pairs; kw_j's log-gradient;
    6. the gates as the plain version.

    ``rounding`` "bf16" feeds each made operand as one bf16 rounding
    instead of a pair, for the record. Returns what
    :func:`mlstm_scan_bwd_plain` returns."""
    assert rounding in ("pair", "bf16"), rounding
    single = rounding == "bf16"
    rp = lambda x: _terms(x, single)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    cq = min(int(chunk_size), s)
    nc = -(-s // cq)
    pad = nc * cq - s
    t = BWD_ROW_TILE
    tiles = [(i0, min(i0 + t, cq)) for i0 in range(0, cq, t)]
    qf, kf, vf, dhf = (_heads(x, h, nc, cq, pad) for x in (q, k, v, dh))
    ig = _heads(i_pre[..., None], h, nc, cq, pad, ref.NEG_BIG)[..., 0]
    fg = _heads(f_pre[..., None], h, nc, cq, pad, ref.PAD_F)[..., 0]
    # 1. the stabilisers
    bcs = torch.cumsum(torch.nn.functional.logsigmoid(fg), dim=-1)
    u = ig - bcs
    m_intra = bcs + torch.cummax(u, dim=-1).values
    g = bcs[..., -1]
    m_loc = (g[..., None] + u).amax(dim=-1)
    m = torch.full((b, h), ref.NEG_BIG, dtype=torch.float32,
                   device=q.device)
    m_in, m_out = [], []
    for c in range(nc):
        m_in.append(m)
        m = torch.maximum(g[..., c] + m, m_loc[..., c])
        m_out.append(m)
    m_in, m_out = torch.stack(m_in, dim=-1), torch.stack(m_out, dim=-1)
    m_row = torch.maximum(m_intra, bcs + m_in[..., None])
    w_row = torch.exp(bcs + m_in[..., None] - m_row)
    kw = torch.exp(g[..., None] - bcs + ig - m_out[..., None])
    carry = torch.exp(g + m_in - m_out)
    rw = w_row * scale
    # 2. the incoming states
    kwk = kw[..., None] * kf
    s_c = sum(x.transpose(-1, -2) @ vf for x in rp(kwk))
    n_c = kwk.sum(dim=-2)
    C = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    c_in, n_in = [], []
    for c in range(nc):
        c_in.append(C)
        n_in.append(n)
        C = carry[..., c, None, None] * C + s_c[:, :, c]
        n = carry[..., c, None] * n + n_c[:, :, c]
    c_in, n_in = torch.stack(c_in, dim=2), torch.stack(n_in, dim=2)
    c_pair = rp(c_in)

    def expo(i0, i1, j0, j1):
        causal = (torch.arange(i0, i1)[:, None]
                  >= torch.arange(j0, j1)[None, :])
        e = (bcs[..., i0:i1, None] - bcs[..., None, j0:j1]
             + ig[..., None, j0:j1] - m_row[..., i0:i1, None])
        return causal, torch.where(
            causal, torch.exp(torch.where(causal, e, 0.0)), 0.0)

    # 3. the rows, tile by tile
    dq, inv, dden, d_row_w, row_s = [], [], [], [], []
    ds_t, wl_t = {}, {}
    col_s = torch.zeros_like(bcs)
    for ti, (i0, i1) in enumerate(tiles):
        qi, dhi = qf[..., i0:i1, :], dhf[..., i0:i1, :]
        X = sum(dhi @ x.transpose(-1, -2) for x in c_pair)
        qx = (qi * X).sum(dim=-1)
        qn = (qi * n_in[..., None, :]).sum(dim=-1)
        den = torch.zeros_like(qx)
        dot = torch.zeros_like(qx)
        WP = []
        for j0, j1 in tiles[:ti + 1]:
            causal, E = expo(i0, i1, j0, j1)
            W = (qi @ kf[..., j0:j1, :].transpose(-1, -2)) * scale * E
            P = dhi @ vf[..., j0:j1, :].transpose(-1, -2)
            den = den + W.sum(dim=-1)
            dot = dot + (W * P).sum(dim=-1)
            WP.append((causal, E, W, P))
        ri = rw[..., i0:i1]
        den = den + ri * qn
        dot = dot + ri * qx
        floor = torch.exp(-m_row[..., i0:i1])
        iv = 1.0 / torch.maximum(den.abs(), floor)
        dd = torch.where(den.abs() > floor,
                         -torch.sign(den) * dot * iv * iv, 0.0)
        acc = 0.0
        rsum = torch.zeros_like(qx)
        for tj, (causal, E, W, P) in enumerate(WP):
            j0, j1 = tiles[tj]
            dW = torch.where(causal, P * iv[..., None] + dd[..., None], 0.0)
            dS = dW * E * scale
            dD = dW * W
            rsum = rsum + dD.sum(dim=-1)
            col_s[..., j0:j1] += dD.sum(dim=-2)
            ds_t[ti, tj] = rp(dS)
            wl_t[ti, tj] = rp(W * iv[..., None])
            acc = acc + sum(x @ kf[..., j0:j1, :] for x in ds_t[ti, tj])
        dq.append(acc + ri[..., None] * (X * iv[..., None]
                                         + dd[..., None] * n_in[..., None, :]))
        inv.append(iv)
        dden.append(dd)
        d_row_w.append(ri * (qx * iv + qn * dd))
        row_s.append(rsum)
    inv, dden = torch.cat(inv, dim=-1), torch.cat(dden, dim=-1)
    # 4. the incoming states' gradients, then the reverse pass
    l_c = sum(x.transpose(-1, -2) @ dhf
              for x in rp(qf * (rw * inv)[..., None]))
    ln_c = (qf * (rw * dden)[..., None]).sum(dim=-2)
    G = torch.zeros_like(C)
    Gn = torch.zeros_like(n)
    g_out, gn_out, d_carry = [None] * nc, [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        g_out[c], gn_out[c] = G, Gn
        d_carry[c] = carry[..., c] * ((c_in[:, :, c] * G).sum(dim=(-1, -2))
                                      + (n_in[:, :, c] * Gn).sum(dim=-1))
        G = l_c[:, :, c] + carry[..., c, None, None] * G
        Gn = ln_c[:, :, c] + carry[..., c, None] * Gn
    g_out, gn_out = torch.stack(g_out, dim=2), torch.stack(gn_out, dim=2)
    d_carry = torch.stack(d_carry, dim=-1)
    g_pair = rp(g_out)
    # 5. the columns, tile by tile
    dkk, dvv, d_kw = [], [], []
    for tj, (j0, j1) in enumerate(tiles):
        kj, vj, kwj = kf[..., j0:j1, :], vf[..., j0:j1, :], kw[..., j0:j1]
        gv = sum(vj @ x.transpose(-1, -2) for x in g_pair) + gn_out[
            ..., None, :]
        d_kw.append(kwj * (kj * gv).sum(dim=-1))
        ak = kwj[..., None] * gv
        av = kwj[..., None] * sum(kj @ x for x in g_pair)
        for ti in range(tj, len(tiles)):
            i0, i1 = tiles[ti]
            ak = ak + sum(x.transpose(-1, -2) @ qf[..., i0:i1, :]
                          for x in ds_t[ti, tj])
            av = av + sum(x.transpose(-1, -2) @ dhf[..., i0:i1, :]
                          for x in wl_t[ti, tj])
        dkk.append(ak)
        dvv.append(av)
    # 6. the gates
    d_kw = torch.cat(d_kw, dim=-1)
    di = col_s + d_kw
    db = torch.cat(row_s, dim=-1) - col_s + torch.cat(d_row_w, dim=-1) - d_kw
    db[..., -1] += d_carry + d_kw.sum(dim=-1)
    dlf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
    df = dlf * torch.sigmoid(-fg)
    return (_unheads(torch.cat(dq, dim=-2), s).to(q.dtype),
            _unheads(torch.cat(dkk, dim=-2), s).to(q.dtype),
            _unheads(torch.cat(dvv, dim=-2), s).to(q.dtype),
            _unheads(di[..., None], s)[..., 0],
            _unheads(df[..., None], s)[..., 0])


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
    b, s, h, dk, dv, chunk = _checked(name, q, k, v, i_pre, f_pre,
                                      chunk_size)
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


def bwd_scratch_floats(b: int, s: int, h: int, dk: int, dv: int,
                       q: int, bf16: bool = False) -> int:
    """fp32 words of :func:`mlstm_scan_bwd_cuda`'s scratch. fp32: per
    chunk eleven records of q rows (the forward's gates and stabilisers,
    the row and column kernels' scalars), the carry and the carry
    gradient's part a 64 x 64 state tile, the incoming state and the
    outgoing state's gradient (dk dv each), their n (dk each) and X =
    C_in dh (q dk). bf16: per chunk two dk (dv + 1) states (the chunk
    state then the incoming one, L then G^n), the bf16 pairs of C_in and
    G (dk dv words each), each causal tile pair's image (dS and W/lim as
    pairs of 64 x 64 tiles: 8192 words), X (dk words a row of the tiles),
    dW W's column sums by row tile (nt x nt 64), q.X's and q.n_in's
    parts by 128-column pass of dk (2 a row of the tiles), the eleven
    records, the carry and the carry gradient's parts (one a 1024 state
    elements)."""
    chunks = b * h * -(-s // q)
    if not bf16:
        tiles = (dk // WIDTH_MULT) * (dv // WIDTH_MULT)
        return chunks * (11 * q + 1 + tiles + 2 * dk * dv + 2 * dk + q * dk)
    nt = -(-q // BWD_ROW_TILE)
    rows = nt * BWD_ROW_TILE
    state = dk * (dv + 1)
    passes = -(-dk // BWD_PASS)
    return chunks * (2 * state + 2 * dk * dv + nt * (nt + 1) // 2 * 8192
                     + rows * dk + nt * rows + 2 * passes * rows + 11 * q
                     + 1 + -(-state // 1024))


def mlstm_scan_bwd_cuda(
    q: torch.Tensor,                     # (B, S, H, dk) fp32 or bf16
    k: torch.Tensor,                     # (B, S, H, dk) q's dtype
    v: torch.Tensor,                     # (B, S, H, dv) q's dtype
    i_pre: torch.Tensor,                 # (B, S, H) fp32
    f_pre: torch.Tensor,                 # (B, S, H) fp32
    dh: torch.Tensor,                    # (B, S, H, dv) q's dtype
    *,
    chunk_size: int = 256,
):
    """The scan's backward with the final state's cotangent 0: returns
    (dq, dk, dv) in q's dtype and (di~, df~) (B, S, H) in fp32. The
    kernels take the forward's shapes (dk and dv multiples of 64, dk <=
    512, a chunk of at most 256 rows) and B * H * chunks <= 65535, in
    bf16 also 16-byte-aligned q, k, v and dh; every sum runs in a fixed
    order (two calls give equal bits)."""
    if q.device.type == "cpu":
        return mlstm_scan_bwd_plain(q, k, v, i_pre, f_pre, dh,
                                    chunk_size=chunk_size)
    name = "mlstm_scan_bwd_cuda"
    dev = q.device
    b, s, h, dk, dv, chunk = _checked(name, q, k, v, i_pre, f_pre,
                                      chunk_size, dh=dh)
    if s > 0 and b * h * -(-s // chunk) > 65535:
        raise ValueError(f"{name}: takes B * H * chunks <= 65535, got "
                         f"{b * h * -(-s // chunk)}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v, dh)):
        raise ValueError(f"{name}: bf16 q, k, v and dh must be 16-byte "
                         f"aligned (16-byte copies)")
    dq, dkk, dvv = (torch.empty_like(t) for t in (q, k, v))
    di = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    df = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or s == 0:
        return dq, dkk, dvv, di, df
    from repro_torch.kernels import _build
    lib = _build.load()
    work = torch.empty((bwd_scratch_floats(b, s, h, dk, dv, chunk, bf16),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mlstm_scan_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), dh.data_ptr(), dq.data_ptr(), dkk.data_ptr(),
            dvv.data_ptr(), di.data_ptr(), df.data_ptr(), work.data_ptr(), b,
            s, h, dk, dv, chunk, dk ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    mlstm_scan_bwd_cuda.launches += 1
    return dq, dkk, dvv, di, df


mlstm_scan_bwd_cuda.launches = 0


class MLSTMScanFn(torch.autograd.Function):
    """``mlstm_scan_cuda`` with ``mlstm_scan_bwd_cuda`` as its backward:
    (q, k, v, i~, f~, chunk_size) -> (h, (C, n, m)). Training drops the
    final state; a gradient that reaches it raises (the backward takes
    its cotangent as 0)."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, chunk_size):
        ctx.set_materialize_grads(False)
        ctx.chunk_size = chunk_size
        ctx.save_for_backward(q, k, v, i_pre, f_pre)
        hout, (C, n, m) = mlstm_scan_cuda(q, k, v, i_pre, f_pre,
                                          chunk_size=chunk_size)
        ctx.mark_non_differentiable(m)
        return hout, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        if dC is not None or dn is not None:
            raise RuntimeError(
                "MLSTMScanFn: a gradient reached the final state; the mLSTM "
                "backward takes the final state's cotangent as 0 (training "
                "drops the state)")
        q, k, v, i_pre, f_pre = ctx.saved_tensors
        if dh is None:
            return None, None, None, None, None, None
        dh = dh.contiguous().to(q.dtype)
        if dh.data_ptr() % 16:               # the bf16 kernels' copies
            dh = dh.clone()
        dq, dk, dv, di, df = mlstm_scan_bwd_cuda(
            q, k, v, i_pre, f_pre, dh, chunk_size=ctx.chunk_size)
        return dq, dk, dv, di, df, None
