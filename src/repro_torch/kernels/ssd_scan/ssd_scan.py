"""Hand-written CUDA SSD scan, its backward, and their plain PyTorch
versions.

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

:func:`ssd_scan_bwd_cuda` — the scan's backward (``csrc/ssd_scan_bwd.cu``),
with the final state's cotangent taken as 0 (training drops the state).
The JAX package has no kernel for it (its training differentiates
``ref.ssd_chunked``); its plain version :func:`ssd_scan_bwd_plain` writes
out the backward's arithmetic step by step, and runs for CPU tensors. It
counts its launches as the forward does (one a call). bf16 runs on the
tensor cores in four kernels (chunk states, the state passing, one pass
over the causal pairs of ``BWD_ROW_TILE``-row tiles, the group sums),
with the operands made in fp32 fed as bf16 hi/lo pairs;
:func:`ssd_scan_bwd_tiled_plain` models that arithmetic for the tests.
fp32 keeps six CUDA-core kernels. :class:`SSDScanFn` joins the forward
and the backward as one ``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIM = 64         # the state dim N the kernel is built for
P_SLICE = 32           # head dim P must be a multiple of this
MAX_CHUNK = 256        # largest chunk Q (one chunk row per thread)
BWD_MAX_P = 128        # largest head dim P of the backward kernel
# rows a tile of the bf16 chunk scan (csrc/ssd_scan.cu; held equal to
# ssd_scan_sm90_tile)
ROW_TILE = 64
# rows a tile of the bf16 backward's pair pass (csrc/ssd_scan_bwd.cu; held
# equal to ssd_scan_bwd_sm90_tile)
BWD_ROW_TILE = 64


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


def _chunked(t: torch.Tensor, h: int, nc: int, q: int) -> torch.Tensor:
    """(B, S, G|H, F) -> (B, H, nc, q, F) fp32, groups broadcast over
    heads, rows past S as 0."""
    b, s = t.shape[:2]
    t = t.float()
    if t.shape[2] != h:
        t = t.repeat_interleave(h // t.shape[2], dim=2)
    t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, nc * q - s))
    return t.reshape(b, nc, q, h, -1).permute(0, 3, 1, 2, 4)


def _unchunked(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, nc, q, F) -> (B, S, H, F)."""
    b, h, nc, q, f = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, f)[:, :s]


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
    n = Bm.shape[3]
    q = min(int(chunk_size), s)
    nc = -(-s // q)
    xf, Bf, Cf = (_chunked(t, h, nc, q) for t in (x, Bm, Cm))
    dtf = _chunked(dt[..., None], h, nc, q)[..., 0]    # (B, H, nc, q)
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
    y = _unchunked(torch.cat(ys, dim=-2), s)
    return y.to(x.dtype), state


def _checked(name: str, x, dt, A, Bm, Cm, D, chunk_size: int, *,
             dy: Optional[torch.Tensor] = None, max_p: Optional[int] = None):
    """The checks both kernels' wrappers make of CUDA inputs: one device,
    contiguous, x (and dy) fp32 or bf16 with B and C in x's dtype, dt, A
    and D fp32, agreeing shapes and the widths the kernels take. Returns
    (B, S, H, P, G, N, the chunk's rows)."""
    tensors = [t for t in (x, dt, A, Bm, Cm, D, dy) if t is not None]
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
    if any(t.dtype != x.dtype for t in (Bm, Cm, dy) if t is not None):
        raise TypeError(f"{name}: B/C dtypes (and dy's) must be x's "
                        f"({x.dtype})")
    if any(t.dtype != torch.float32 for t in (dt, A, D) if t is not None):
        raise TypeError(f"{name}: dt, A and D must be float32")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, g, n)
            or Cm.shape != Bm.shape or (D is not None and D.shape != (h,))
            or (dy is not None and dy.shape != x.shape)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
            f"{tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)} "
            f"disagree")
    q = min(int(chunk_size), s)
    if (n != STATE_DIM or p % P_SLICE or (max_p is not None and p > max_p)
            or g <= 0 or h % g or q <= 0 or q > MAX_CHUNK):
        raise ValueError(
            f"{name}: needs N == {STATE_DIM}, P % {P_SLICE} == 0"
            + (f" and P <= {max_p}" if max_p is not None else "")
            + f", H % G == 0 and a chunk of 1..{MAX_CHUNK} rows, got "
            f"N={n} P={p} H={h} G={g} chunk={q}")
    return b, s, h, p, g, n, q


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
    b, s, h, p, g, n, q = _checked(name, x, dt, A, Bm, Cm, D, chunk_size)
    dev = x.device
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


def _bwd_state_pass(st, loc, a_last):
    """The backward's state passing over the chunks of S_c (``st``) and
    L_c (``loc``), (B, H, nc, P, N) each: forward, state_in[0] = 0,
    state_in[c + 1] = exp(a_c) state_in[c] + S_c; then in reverse the
    gradient of S_c, G_c (0 for the last chunk, G_{c-1} = L_c + exp(a_c)
    G_c), and the gradient of a_c through the carried state, exp(a_c)
    <state_in[c], G_c> in fp64. Returns (state_in, G, a_c's gradient),
    stacked over the chunks."""
    nc = st.shape[2]
    state = torch.zeros_like(st[:, :, 0])
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = torch.exp(a_last[:, :, c])[..., None, None] * state \
            + st[:, :, c]
    g_next = torch.zeros_like(state)
    grads, d_last = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        e = torch.exp(a_last[:, :, c])
        grads[c] = g_next
        d_last[c] = e.double() * (state_in[c].double()
                                  * g_next.double()).sum(dim=(-1, -2))
        g_next = loc[:, :, c] + e[..., None, None] * g_next
    return (torch.stack(state_in, dim=2), torch.stack(grads, dim=2),
            torch.stack(d_last, dim=2))


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, dy, *, chunk_size: int = 256):
    """The backward of :func:`ssd_scan_plain` with the final state's
    cotangent 0, in fp32, as the kernel computes it (``A_cum`` the
    inclusive cumsum of dt A within a chunk, ``a`` its last row):

    1. per chunk, the state it adds, S_c = sum_j exp(a - A_cum_j) dt_j
       x_j B_j^T, and the gradient its output puts on its incoming
       state, L_c = sum_i exp(A_cum_i) dy_i C_i^T;
    2. the state passing forward (state_in[0] = 0, state_in[c + 1] =
       exp(a_c) state_in[c] + S_c), then in reverse the gradient of S_c,
       G_c (0 for the last chunk, G_{c-1} = L_c + exp(a_c) G_c), and
       the gradient of a_c through the carried state, exp(a_c)
       <state_in[c], G_c>;
    3. per chunk, with F_ij = exp(A_cum_i - A_cum_j) dt_j on the causal
       half (0 above it), M = (C B^T) F, dM = dy x^T and dCB = dM F:
       dC = dCB B + exp(A_cum) dy state_in; dB = dCB^T C + exp(a -
       A_cum) dt G^T x; dx = M^T dy + exp(a - A_cum) dt G B (+ D dy);
       ddt's direct part, column sums of dM F / dt plus exp(a - A_cum)
       x^T G B; and A_cum's gradient: row sums minus column sums of dM
       M, the carried state's exp(A_cum) C . (dy state_in), minus the
       chunk state's exp(a - A_cum) dt x^T G B, and a's gradient (step 2
       and the chunk state's sum) at the last row;
    4. A_cum's gradient summed in reverse over the chunk (the cumsum's
       transpose): ddt += A that, dA = sum dt that. A_cum's gradient
       and these sums are taken in fp64 from fp32 terms: each pair's
       dM M enters at its row and (negated) at its column from one fp32
       value, so the pairs that do not straddle a row cancel exactly in
       that row's reverse sum, and A's gradient, a small sum of large
       terms, keeps its digits;
    5. dB and dC summed over the heads of a group; dD = sum dy . x.

    Rows past S read as 0, as in the forward. Returns (dx, ddt, dA, dB,
    dC, dD): dx, dB, dC in x's dtype, the rest fp32; dD is None without
    D."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(int(chunk_size), s)
    nc = -(-s // q)
    xf, Bf, Cf, dyf = (_chunked(t, h, nc, q) for t in (x, Bm, Cm, dy))
    dtf = _chunked(dt[..., None], h, nc, q)[..., 0]          # (B, H, nc, q)
    Af = A.float()
    acum = torch.cumsum(dtf * Af[None, :, None, None], dim=-1)
    a_last = acum[..., -1]                                   # (B, H, nc)
    decay = torch.exp(a_last[..., None] - acum)              # exp(a - A_cum)
    w = decay * dtf
    e_in = torch.exp(acum)
    # 1. chunk states, and the output's gradient on the incoming state
    st = (xf * w[..., None]).transpose(-1, -2) @ Bf          # (.., P, N)
    loc = (dyf * e_in[..., None]).transpose(-1, -2) @ Cf
    # 2. the state passing, forward then in reverse
    sin, gst, d_last = _bwd_state_pass(st, loc, a_last)
    # 3. per chunk
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    diff = acum[..., :, None] - acum[..., None, :]
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    cb = Cf @ Bf.transpose(-1, -2)                           # (.., q, q)
    dm = dyf @ xf.transpose(-1, -2)
    fac = L * dtf[..., None, :]
    m = cb * fac
    dcb = dm * fac
    dmm = (dm * m).double()            # each pair's term, summed in fp64
    u = dyf @ sin                                            # (.., q, N)
    dC = dcb @ Bf + e_in[..., None] * u
    d_acum = dmm.sum(dim=-1) + (e_in * (Cf * u).sum(dim=-1)).double()
    gb = Bf @ gst.transpose(-1, -2)                          # (.., q, P)
    gx = xf @ gst                                            # (.., q, N)
    s_j = (Bf * gx).sum(dim=-1)
    dx = m.transpose(-1, -2) @ dyf + w[..., None] * gb
    dB = dcb.transpose(-1, -2) @ Cf + w[..., None] * gx
    ddt = (dm * cb * L).sum(dim=-2) + decay * s_j
    ws = (w * s_j).double()            # -ws at each row, +ws at the last
    d_acum = d_acum - dmm.sum(dim=-2) - ws
    d_acum[..., -1] += d_last + ws.sum(dim=-1)
    # 4. through the cumsum, in fp64
    dda = torch.flip(torch.cumsum(torch.flip(d_acum, (-1,)), -1), (-1,))
    ddt = (ddt.double() + Af.double()[None, :, None, None] * dda).float()
    dA = (dtf.double() * dda).sum(dim=(0, 2, 3)).float()
    dD = None
    if D is not None:
        dx = dx + D.float()[None, :, None, None, None] * dyf
        dD = (dyf * xf).sum(dim=(0, 2, 3, 4))
    # 5. back to the input layouts; a group's heads summed
    rep = h // g
    dB = _unchunked(dB, s).reshape(b, s, g, rep, n).sum(dim=3)
    dC = _unchunked(dC, s).reshape(b, s, g, rep, n).sum(dim=3)
    return (_unchunked(dx, s).to(x.dtype), _unchunked(ddt[..., None], s)[
        ..., 0], dA, dB.to(x.dtype), dC.to(x.dtype), dD)


def ssd_scan_bwd_tiled_plain(x, dt, A, Bm, Cm, D, dy, *,
                             chunk_size: int = 256, rounding: str = "pair"):
    """The bf16 backward kernels' arithmetic in plain PyTorch, for the
    tests; the steps of :func:`ssd_scan_bwd_plain`, with the operands
    made in fp32 rounded as the kernels feed them to bf16 products:

    1. S_c = x^T (w B) and L_c = dy^T (exp(A_cum) C), the weighted B and
       C as bf16 pairs;
    2. the state passing as in the plain version, fp32 (a_c's gradient
       in fp64);
    3. per head and chunk, in tiles of ``BWD_ROW_TILE`` rows: u = dy_i
       state_in (the state as a pair) for dC_i and A_cum's gradient from
       the carried state; per column tile j, x_j G and B_j G^T (G as a
       pair) for dB_j, dx_j and s; then the causal pairs (i >= j) in
       order: S^T = B_j C_i^T and dM^T = x_j dy_i^T of the exact
       operands, M^T = S^T l dt_j and (dM F)^T = dM^T l dt_j as pairs in
       dx_j += M^T dy_i, dB_j += (dM F)^T C_i and dC_i += (dM F) B_j, v =
       dM M summed in fp64 over the rows and the columns of each pair;
    4. A_cum's gradient summed in reverse in fp64, as the plain version.

    Rows past S read as 0. ``rounding`` "bf16" or "tf32" replaces the
    pairs with one rounding, for the record. Returns what
    :func:`ssd_scan_bwd_plain` returns."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(int(chunk_size), s)
    nc = -(-s // q)
    t = BWD_ROW_TILE
    nt = -(-q // t)
    qp = nt * t
    rp = lambda v: _pair(v, rounding)
    xf, Bf, Cf, dyf = (_chunked(v, h, nc, q) for v in (x, Bm, Cm, dy))
    dtf = _chunked(dt[..., None], h, nc, q)[..., 0]          # (B, H, nc, q)
    Af = A.float()
    acum = torch.cumsum(dtf * Af[None, :, None, None], dim=-1)
    a_last = acum[..., -1]
    e_in = torch.exp(acum)
    w = torch.exp(a_last[..., None] - acum) * dtf
    # 1. chunk states, the weighted operand as a pair
    st = _mm_pair(xf.transpose(-1, -2), rp(Bf * w[..., None]))
    loc = _mm_pair(dyf.transpose(-1, -2), rp(Cf * e_in[..., None]))
    # 2. the state passing, forward then in reverse
    sin, gst, d_last = _bwd_state_pass(st, loc, a_last)
    # 3. rows padded to whole tiles: zeros, A_cum flat, dt 0
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, qp - q))
    xp, Bp, Cp, dyp = (pad(v) for v in (xf, Bf, Cf, dyf))
    dtp = torch.nn.functional.pad(dtf, (0, qp - q))
    acp = torch.cat([acum, acum[..., -1:].expand(*acum.shape[:-1], qp - q)],
                    dim=-1)
    e_p = torch.exp(acp)
    decay = torch.exp(a_last[..., None] - acp)
    w_p = decay * dtp
    # the carried state's terms
    u = _mm_pair(dyp, rp(sin))                               # (.., qp, N)
    dC = e_p[..., None] * u
    d_row = (e_p * (Cp * u).sum(dim=-1)).double()
    # the chunk state's terms
    g_pair = rp(gst)
    gx = _mm_pair(xp, g_pair)                                # x G
    gb = _mm_pair(Bp, tuple(v.transpose(-1, -2) if v is not None else None
                            for v in g_pair))                # B G^T
    s_j = (Bp * gx).sum(dim=-1)
    ws = (w_p * s_j).double()
    dx = w_p[..., None] * gb
    if D is not None:
        dx = dx + D.float()[None, :, None, None, None] * dyp
    dB = w_p[..., None] * gx
    ddt = decay * s_j
    v_col = torch.zeros_like(d_row)
    dx, dB, dC, ddt = (list(v.split(t, dim=-2 if v.dim() == 5 else -1))
                       for v in (dx, dB, dC, ddt))
    d_row = list(d_row.split(t, dim=-1))
    v_col = list(v_col.split(t, dim=-1))
    tiles = lambda v: v.split(t, dim=-2)
    xt, Bt, Ct, dyt = (tiles(v) for v in (xp, Bp, Cp, dyp))
    at, dtt = acp.split(t, dim=-1), dtp.split(t, dim=-1)
    idx = torch.arange(qp, device=x.device).split(t)
    for jt in range(nt):
        for it in range(jt, nt):
            sT = Bt[jt] @ Ct[it].transpose(-1, -2)           # rows j, cols i
            dmT = xt[jt] @ dyt[it].transpose(-1, -2)
            live = (idx[it][None, :] >= idx[jt][:, None]) & (
                idx[it][None, :] < q)
            arg = torch.where(live, at[it][..., None, :]
                              - at[jt][..., :, None], 0.0)
            l = torch.where(live, torch.exp(arg), 0.0)
            ldt = l * dtt[jt][..., :, None]
            m = sT * ldt
            f = dmT * ldt
            ddt[jt] = ddt[jt] + (dmT * sT * l).sum(dim=-1)
            v = (dmT * m).double()
            v_col[jt] = v_col[jt] + v.sum(dim=-1)
            d_row[it] = d_row[it] + v.sum(dim=-2)
            dx[jt] = dx[jt] + _mm_pair_left(rp(m), dyt[it])
            dB[jt] = dB[jt] + _mm_pair_left(rp(f), Ct[it])
            dC[it] = dC[it] + _mm_pair_left(
                tuple(v_.transpose(-1, -2) if v_ is not None else None
                      for v_ in rp(f)), Bt[jt])
    cat = lambda vs, dim: torch.cat(vs, dim=dim)[..., :q, :] if dim == -2 \
        else torch.cat(vs, dim=-1)[..., :q]
    dx, dB, dC = (cat(v, -2) for v in (dx, dB, dC))
    ddt = cat(ddt, -1)
    d_acum = cat(d_row, -1) - cat(v_col, -1) - ws[..., :q]
    d_acum[..., -1] += d_last + ws.sum(dim=-1)
    # 4. through the cumsum, in fp64
    dda = torch.flip(torch.cumsum(torch.flip(d_acum, (-1,)), -1), (-1,))
    ddt = (ddt.double() + Af.double()[None, :, None, None] * dda).float()
    dA = (dtf.double() * dda).sum(dim=(0, 2, 3)).float()
    dD = None if D is None else (dyf * xf).sum(dim=(0, 2, 3, 4))
    rep = h // g
    dB = _unchunked(dB, s).reshape(b, s, g, rep, n).sum(dim=3)
    dC = _unchunked(dC, s).reshape(b, s, g, rep, n).sum(dim=3)
    return (_unchunked(dx, s).to(x.dtype), _unchunked(ddt[..., None], s)[
        ..., 0], dA, dB.to(x.dtype), dC.to(x.dtype), dD)


def _mm_pair_left(a_pair, b):
    """(hi + lo) @ b, the two products summed in the kernel's order."""
    hi, lo = a_pair
    out = hi @ b
    return out if lo is None else out + lo @ b


def bwd_scratch_floats(b: int, s: int, h: int, p: int, g: int, q: int,
                       bf16: bool, slices: int = 1) -> int:
    """fp32 words of :func:`ssd_scan_bwd_cuda`'s scratch. fp32: per
    chunk, A_cum's gradient from the rows and the columns (fp64, q each),
    a's gradient, its chunk-state part per column tile and dA's part
    (fp64), A_cum and ddt's direct part (q each), the chunk state then
    state_in and L then G (P N each), dD's part per column tile; dB and
    dC per head (B S H N each). bf16: per chunk the two P N states,
    a's gradient by warp of the state passing (P / 2 fp64), dA's part
    (fp64), A_cum (q) and dD's part; dB and dC per head slice (``slices``
    x B S G N each)."""
    chunks = b * h * -(-s // q)
    n = STATE_DIM
    if bf16:
        return chunks * (2 * p * n + p + q + 3) + 2 * slices * b * s * g * n
    nt = -(-q // BWD_ROW_TILE)
    return chunks * (6 * q + 2 * p * n + 4 + 3 * nt) + 2 * b * s * h * n

def ssd_scan_bwd_cuda(
    x: torch.Tensor,                     # (B, S, H, P) fp32 or bf16
    dt: torch.Tensor,                    # (B, S, H) fp32
    A: torch.Tensor,                     # (H,) fp32
    Bm: torch.Tensor,                    # (B, S, G, N) x's dtype
    Cm: torch.Tensor,                    # (B, S, G, N)
    D: Optional[torch.Tensor],           # (H,) fp32 or None
    dy: torch.Tensor,                    # (B, S, H, P) x's dtype
    *,
    chunk_size: int = 256,
):
    """The scan's backward with the final state's cotangent 0: returns
    (dx, ddt, dA, dB, dC, dD), dx, dB and dC in x's dtype, ddt (B, S, H),
    dA (H,) and dD (H,) (None without D) in fp32. The kernels take the
    forward's shapes with P at most ``BWD_MAX_P``, in bf16 also
    16-byte-aligned x, B, C and dy and B, H <= 65535; every sum runs in a
    fixed order (two calls give equal bits). bf16 runs the tensor-core
    kernels, fp32 the CUDA-core ones."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, dy,
                                  chunk_size=chunk_size)
    name = "ssd_scan_bwd_cuda"
    b, s, h, p, g, n, q = _checked(name, x, dt, A, Bm, Cm, D, chunk_size,
                                   dy=dy, max_p=BWD_MAX_P)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if any(t.data_ptr() % 16 for t in (x, Bm, Cm, dy)):
            raise ValueError(f"{name}: bf16 x, B, C and dy must be 16-byte "
                             f"aligned (16-byte copies)")
        if b > 65535 or h > 65535:
            raise ValueError(f"{name}: bf16 takes B, H <= 65535, got B={b} "
                             f"H={h}")
    dx = torch.empty_like(x)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dA = torch.zeros((h,), dtype=torch.float32, device=dev)
    dD = (torch.zeros((h,), dtype=torch.float32, device=dev)
          if D is not None else None)
    if b == 0 or s == 0:
        return dx, ddt, dA, dB.zero_(), dC.zero_(), dD
    from repro_torch.kernels import _build
    lib = _build.load()
    slices = lib.ssd_scan_bwd_sm90_slices(b, s, h, g, q) if bf16 else 1
    work = torch.empty((bwd_scratch_floats(b, s, h, p, g, q, bf16, slices),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr() if D is not None else None,
            dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr() if dD is not None else None, work.data_ptr(),
            b, s, h, p, g, n, q, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    ssd_scan_bwd_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dD


ssd_scan_bwd_cuda.launches = 0


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan_cuda`` with ``ssd_scan_bwd_cuda`` as its backward:
    (x, dt, A, B, C, D, chunk_size) -> (y, final state). Training drops
    the final state; a gradient that reaches it raises (the backward
    takes its cotangent as 0)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk_size):
        ctx.set_materialize_grads(False)
        ctx.chunk_size = chunk_size
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        y, final = ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk_size=chunk_size)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        if dfinal is not None:
            raise RuntimeError(
                "SSDScanFn: a gradient reached the final state; the SSD "
                "backward takes the final state's cotangent as 0 "
                "(training drops the state)")
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dD = ssd_scan_bwd_cuda(
            x, dt, A, Bm, Cm, D, dy.contiguous().to(x.dtype),
            chunk_size=ctx.chunk_size)
        return dx, ddt, dA, dB, dC, dD, None
