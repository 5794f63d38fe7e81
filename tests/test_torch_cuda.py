"""The repro_torch CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU. Every test here is marked ``cuda`` and skips with a
reason where there is no card; this file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the serving kernels' outputs are O(1) and are held to
1e-4 absolute in fp32 (TF32 off; the kernel sums the softmax online, the
plain version densely) and 2e-2 in bf16 (the two round to bf16 at
different points). The training kernels' outputs (lse, gradients,
losses, dlogits) are not O(1): each is held by its relative L2 error to
``repro_torch.kernels.parity.RTOL`` for its kernel and dtype, and the
autograd Functions against the "reference" impls' autograd to
``AUTOGRAD_RTOL``. The int8 exchange kernels must equal their plain
versions bit for bit. The MLA decode kernels and the head-dim-192
prefill are held like the serving kernels (1e-4 fp32, 2e-2 bf16;
outputs O(1)), and the MLA serving path's kernel route against its
reference route at fp32 by ``MLA_PATH_TOL``. The SSD scan kernel and the
head-dim-80 prefill are held by relative L2 error to ``parity.RTOL``
(the scan on the larger of y's and the final state's), and zamba2's
static path, kernel route against reference route at fp32, by
``ZAMBA_PATH_TOL``. The mLSTM scan kernel is held by relative L2 error
to ``parity.RTOL`` (the largest over h, C, n and m), and xLSTM's static
path, kernel route against reference route at fp32, by
``XLSTM_PATH_TOL``. The bf16 prefill forward and CE forward run on the
tensor cores: each is held to its plain version by relative L2 error
(``parity.RTOL``) at every head dim and both head layouts, on ragged
shapes, and must give bitwise-equal outputs on a second run. So is the
bf16 attention backward (tensor cores) at head dims 64 and 128. The
split paged decode must repeat its bits and give a sequence the same
bits alone as inside a wider batch; so must the bf16 paged MLA decode
(tensor cores, positions split across blocks), at 128 heads and at 16,
and the bf16 contiguous MLA decode (the same kernel), which is also held
to its split model (2e-3) at the generate shape, and whose static path
(``static_generate``), kernel route against reference route at fp32,
is held by ``MLA_PATH_TOL`` with identical greedy tokens.
The bf16 SSD scan (tensor cores, three kernels) must repeat its bits,
also where the chunk is not a multiple of its 64-row tile.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cross_entropy import cross_entropy as ce
from repro_torch.kernels.cross_entropy import ref as ce_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mla_decode import mla_decode as md
from repro_torch.kernels.mla_decode import ref as mla_ref
from repro_torch.kernels.mlstm_scan import mlstm_scan as mk
from repro_torch.kernels.parity import RTOL, rel_l2
from repro_torch.kernels.quantize import quantize as qz
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as sk

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# kernel impl vs the "reference" impl under autograd, about 10x the
# largest reading on an H100 (5.8e-7 fp32, 4.1e-3 bf16: the reference
# rounds its bf16 intermediates where the kernels keep fp32)
AUTOGRAD_RTOL = {torch.float32: 5e-6, torch.bfloat16: 4e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


def _err(got, want):
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,off", [
    (2, 16, 16, 32, 4, True, 0),       # smallest bucket, Sq < q tile
    (1, 200, 200, 32, 4, True, 0),     # not a multiple of either tile
    (2, 20, 100, 8, 8, True, 80),      # chunked prefill, group 1
    (1, 33, 77, 4, 2, False, 0),       # non-causal, group 2
    (1, 130, 130, 16, 1, True, 0),     # MQA, 3 q tiles
])
def test_prefill_kernel_matches_plain(dev, dtype, tol, b, sq, skv, h, hkv,
                                      causal, off):
    rng = np.random.default_rng(sq + skv)
    q = _randn(rng, (b, sq, h, 64), dev, dtype)
    k = _randn(rng, (b, skv, hkv, 64), dev, dtype)
    v = _randn(rng, (b, skv, hkv, 64), dev, dtype)
    n0 = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    assert fa.flash_attention_cuda.launches == n0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == dtype and got.shape == q.shape
    assert _err(got, want) <= tol


def _paged(rng, dev, dtype, b, bs, mb, hkv, group, lens):
    n = b * mb
    q = _randn(rng, (b, 1, hkv * group, 64), dev, dtype)
    kp = _randn(rng, (n, bs, hkv, 64), dev, dtype)
    vp = _randn(rng, (n, bs, hkv, 64), dev, dtype)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    for i, ln in enumerate(lens):
        nb = min(-(-ln // bs), mb)
        if ln > 1:
            tables[i, :nb] = perm[i * mb:i * mb + nb]
        if nb > 2:
            tables[i, nb // 2] = n if i % 2 else -1     # NULL holes
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("bs,mb,hkv,group,lens", [
    (16, 32, 4, 8, [512, 1, 37, 200, 16, 301, 455, 129]),
    (12, 5, 2, 4, [60, 1, 13, 59]),             # block size not a tile div
    (64, 3, 1, 16, [192, 70, 1]),               # group of 16 warps
    (16, 4, 4, 8, [80, 64, 1]),                 # kv_len past the window
])
def test_paged_decode_kernel_matches_plain(dev, dtype, tol, bs, mb, hkv,
                                           group, lens):
    rng = np.random.default_rng(bs * mb)
    args = _paged(rng, dev, dtype, len(lens), bs, mb, hkv, group, lens)
    n0 = fa.flash_decode_paged_cuda.launches
    got = fa.flash_decode_paged_cuda(*args)
    assert fa.flash_decode_paged_cuda.launches == n0 + 1
    want = fa.flash_decode_paged_plain(*args)
    assert _err(got, want) <= tol
    inactive = [i for i, ln in enumerate(lens) if ln == 1]
    assert not got[inactive].any()


def test_kernels_refuse_what_they_do_not_take(dev):
    def qk(d, dtype=torch.float32):
        return (torch.zeros((1, 8, 4, d), device=dev, dtype=dtype),
                torch.zeros((1, 8, 2, d), device=dev, dtype=dtype))
    q, k = qk(32)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_cuda(q, k, k)
    q, k = qk(64, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, k, k)
    q, k = qk(64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="single query"):
        fa.flash_decode_paged_cuda(
            q, k, k, torch.zeros((1, 1), dtype=torch.int32, device=dev),
            torch.ones((1,), dtype=torch.int32, device=dev))


def _close(what, got, want, tol):
    """Relative L2 error of ``got`` within ``tol``; the reading is
    printed (shown with ``-s``) so the limits can be set from it."""
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    print(f"[rel-l2] {what} {got.dtype}: {err:.3e} (tol {tol:g})")
    return err <= tol


DTYPE_ONLY = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,off", [
    (2, 130, 130, 16, 16, 128, 0),     # olmo-1b heads, 3 q tiles
    (1, 200, 200, 8, 2, 128, 0),       # GQA 4 at D=128, ragged tiles
    (1, 20, 50, 4, 1, 128, 30),        # q_offset, MQA
    (2, 77, 77, 8, 2, 64, 0),          # tinyllama's D
])
def test_prefill_lse_and_backward_match_plain(dev, dtype, b, sq, skv, h,
                                              hkv, d, off):
    rng = np.random.default_rng(sq * d + off)
    q = _randn(rng, (b, sq, h, d), dev, dtype)
    k = _randn(rng, (b, skv, hkv, d), dev, dtype)
    v = _randn(rng, (b, skv, hkv, d), dev, dtype)
    dout = _randn(rng, (b, sq, h, d), dev, dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, q_offset=off,
                                       return_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, q_offset=off,
                                              return_lse=True)
    tol = RTOL[("flash_attention_cuda", dtype)]
    assert _close("out", out, want, tol)
    assert _close("lse", lse, want_lse, tol)
    n0 = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_offset=off)
    assert fa.flash_attention_bwd_cuda.launches == n0 + 1
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, q_offset=off)
    tol = RTOL[("flash_attention_bwd_cuda", dtype)]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _close(name, g, r, tol)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_offset=off)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
@pytest.mark.parametrize("t,d,v,rows,eps,cap", [
    (100, 64, 300, False, 0.0, 0.0),   # T, V not tile multiples
    (64, 96, 257, True, 0.1, 0.0),     # tied layout, smoothing
    (33, 32, 130, False, 0.0, 5.0),    # softcap (forward only)
])
def test_cross_entropy_kernels_match_plain(dev, dtype, t, d, v, rows, eps,
                                           cap):
    rng = np.random.default_rng(t + v)
    hid = _randn(rng, (t, d), dev, dtype)
    w = _randn(rng, (v, d) if rows else (d, v), dev, dtype)
    head = w.t() if rows else w
    labels = torch.from_numpy(rng.integers(0, v, t)).to(dev)
    weights = torch.from_numpy(
        (rng.random(t) > 0.3).astype(np.float32)).to(dev)
    n0 = ce.cross_entropy_cuda.launches
    got = ce.cross_entropy_cuda(hid, head, labels, weights,
                                label_smoothing=eps, logit_softcap=cap,
                                return_lse=True)
    assert ce.cross_entropy_cuda.launches == n0 + 1
    want = ce.cross_entropy_plain(hid, head, labels, weights,
                                  label_smoothing=eps, logit_softcap=cap,
                                  return_lse=True)
    tol = RTOL[("cross_entropy_cuda", dtype)]
    for name, g, r in zip(("loss_sum", "w_sum", "lse"), got, want):
        assert _close(name, g, r, tol)
    logits = ce_ref.mm_f32(hid, head)
    dloss = torch.tensor(0.7, device=dev)
    n0 = ce.ce_dlogits_cuda.launches
    dl = ce.ce_dlogits_cuda(logits, want[2], labels, weights, dloss,
                            label_smoothing=eps, dtype=dtype)
    assert ce.ce_dlogits_cuda.launches == n0 + 1
    ref = ce_ref.ce_dlogits(logits, want[2], labels, weights, dloss,
                            label_smoothing=eps, dtype=dtype)
    assert dl.dtype == dtype
    assert _close("dlogits", dl, ref, RTOL[("ce_dlogits_cuda", dtype)])
    assert not dl[weights == 0].any()        # dummy rows: exactly zero


# the bf16 prefill forward (tensor cores): head dims 64, 80, 128 and 192
# at (b, sq, skv, h, hkv, causal, q_offset): more than one q tile of
# either size with a ragged tail (group 2), chunked prefill with Skv > Sq
# (group 1), MQA (group 8), non-causal with a ragged Skv
SM90_ATTN_CASES = [
    (2, 300, 300, 8, 4, True, 0),
    (1, 40, 200, 4, 4, True, 160),
    (1, 130, 130, 8, 1, True, 0),
    (1, 70, 150, 4, 2, False, 0),
]


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,off", SM90_ATTN_CASES)
def test_bf16_prefill_kernel_matches_plain_and_repeats(dev, d, b, sq, skv,
                                                       h, hkv, causal, off):
    rng = np.random.default_rng(d + sq + skv)
    q = _randn(rng, (b, sq, h, d), dev, torch.bfloat16)
    k, v = (_randn(rng, (b, skv, hkv, d), dev, torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=off)
    n0 = fa.flash_attention_cuda.launches
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa.flash_attention_cuda.launches == n0 + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    tol = RTOL[("flash_attention_cuda", torch.bfloat16)]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _close(f"prefill D={d} out", out, want, tol)
    assert _close(f"prefill D={d} lse", lse, want_lse, tol)
    again, again_lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                               **kw)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)


# (t, d, v, tied, eps, cap): T and V not multiples of the 128-token and
# 128-column tiles, tied and untied; a (D, V) head whose rows are not
# 16-byte aligned (V % 8 != 0); label smoothing and softcap
SM90_CE_CASES = [
    (300, 64, 5000, True, 0.0, 0.0),
    (300, 64, 5000, False, 0.1, 0.0),
    (129, 96, 1001, False, 0.0, 5.0),
    (77, 32, 257, True, 0.1, 3.0),
]


@pytest.mark.parametrize("t,d,v,tied,eps,cap", SM90_CE_CASES)
def test_bf16_cross_entropy_kernel_matches_plain_and_repeats(dev, t, d, v,
                                                             tied, eps, cap):
    rng = np.random.default_rng(t + v)
    hid = _randn(rng, (t, d), dev, torch.bfloat16)
    table = (_randn(rng, (v, d), dev, torch.float32) * d ** -0.5).bfloat16()
    head = table.t() if tied else table.t().contiguous()
    labels = torch.from_numpy(rng.integers(0, v, t)).to(dev)
    weights = torch.from_numpy(
        (rng.random(t) > 0.3).astype(np.float32)).to(dev)
    kw = dict(label_smoothing=eps, logit_softcap=cap, return_lse=True)
    n0 = ce.cross_entropy_cuda.launches
    got = ce.cross_entropy_cuda(hid, head, labels, weights, **kw)
    assert ce.cross_entropy_cuda.launches == n0 + 1
    want = ce.cross_entropy_plain(hid, head, labels, weights, **kw)
    tol = RTOL[("cross_entropy_cuda", torch.bfloat16)]
    for name, g, r in zip(("loss_sum", "w_sum", "lse"), got, want):
        assert _close(f"ce {name}", g, r, tol)
    again = ce.cross_entropy_cuda(hid, head, labels, weights, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_bf16_kernels_refuse_what_they_do_not_take(dev):
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 4, 96), device=dev, dtype=bf)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_cuda(q, q, q)
    buf = torch.zeros((1 + 8 * 4 * 64,), device=dev, dtype=bf)
    q = buf[1:].view(1, 8, 4, 64)                 # 2 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(q, q, q)
    hid = torch.zeros((8, 40), device=dev, dtype=bf)
    lab = torch.zeros((8,), dtype=torch.int32, device=dev)
    wts = torch.ones((8,), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        ce.cross_entropy_cuda(hid, torch.zeros((40, 300), device=dev,
                                               dtype=bf), lab, wts)


def test_bf16_kernels_take_the_tiles_the_cpu_models_follow(dev):
    """The tiles of flash_attention_tiled_plain and
    cross_entropy_split_plain (tests/test_torch_sm90_numerics.py) are the
    ones the built kernels launch with."""
    from repro_torch.kernels import _build
    lib = _build.load()
    for d in fa.PREFILL_HEAD_DIMS:
        assert lib.flash_attention_fwd_sm90_kv_tile(d) == fa.KV_TILES[d]
    assert lib.flash_attention_fwd_sm90_kv_tile(96) == -1
    assert (lib.ce_fwd_sm90_tile(0), lib.ce_fwd_sm90_tile(1)) == \
        (ce.TOKEN_TILE, ce.VOCAB_TILE)


# the bf16 backward (tensor cores): the forward's cases and a group of 16
SM90_BWD_CASES = SM90_ATTN_CASES + [(1, 96, 96, 16, 1, True, 0)]


@pytest.mark.parametrize("d", list(fa.BWD_HEAD_DIMS))
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,off", SM90_BWD_CASES)
def test_bf16_backward_kernel_matches_plain_and_repeats(dev, d, b, sq, skv,
                                                        h, hkv, causal, off):
    rng = np.random.default_rng(3 * d + sq + skv)
    q = _randn(rng, (b, sq, h, d), dev, torch.bfloat16)
    k, v = (_randn(rng, (b, skv, hkv, d), dev, torch.bfloat16)
            for _ in range(2))
    dout = _randn(rng, (b, sq, h, d), dev, torch.bfloat16)
    kw = dict(causal=causal, q_offset=off)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    n0 = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert fa.flash_attention_bwd_cuda.launches == n0 + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    tol = RTOL[("flash_attention_bwd_cuda", torch.bfloat16)]
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _close(f"backward D={d} {name}", g, r, tol)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_paged_decode_kernel_repeats_and_is_batch_invariant(dev, dtype, tol):
    """The split decode: equal bits on a second run, and one sequence
    alone (a 24-block table) gives the bits it gets inside a batch of 8
    with a 64-block table (more splits of the window)."""
    rng = np.random.default_rng(5)
    lens = [1000, 1, 37, 300, 16, 512, 455, 129]
    q, kp, vp, tables, kv_lens = _paged(rng, dev, dtype, 8, 16, 64, 4, 8,
                                        lens)
    got = fa.flash_decode_paged_cuda(q, kp, vp, tables, kv_lens)
    assert _err(got, fa.flash_decode_paged_plain(
        q, kp, vp, tables, kv_lens)) <= tol
    assert not got[1].any()
    assert torch.equal(fa.flash_decode_paged_cuda(q, kp, vp, tables,
                                                  kv_lens), got)
    seq = 3
    alone = fa.flash_decode_paged_cuda(
        q[seq:seq + 1].contiguous(), kp, vp,
        tables[seq:seq + 1, :24].contiguous(), kv_lens[seq:seq + 1])
    assert fa.decode_splits(24, 16) < fa.decode_splits(64, 16)
    assert torch.equal(alone[0], got[seq])


def test_backward_and_decode_take_the_tiles_the_cpu_models_follow(dev):
    """The tiles of flash_attention_bwd_tiled_plain and the split of
    flash_decode_paged_split_plain (tests/test_torch_sm90_numerics.py)
    are the ones the built kernels launch with."""
    from repro_torch.kernels import _build
    lib = _build.load()
    for d in fa.BWD_HEAD_DIMS:
        assert tuple(lib.flash_attention_bwd_sm90_tile(d, a)
                     for a in range(4)) == fa.BWD_TILES[d]
        assert lib.flash_attention_bwd_sm90_smem(d, 0) > 0
        assert lib.flash_attention_bwd_sm90_smem(d, 1) > 0
    assert lib.flash_attention_bwd_sm90_tile(96, 0) == -1
    assert lib.flash_attention_bwd_sm90_tile(128, 4) == -1
    assert lib.paged_decode_split_len() == fa.DECODE_SPLIT


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
def test_autograd_functions_launch_kernels_and_match_reference(dev, dtype):
    """``impl="kernel"`` under autograd on CUDA tensors: the attention
    forward and backward kernels, the CE forward kernel and its dlogits
    pass (tied head), each launched, with gradients equal to the
    "reference" impls' autograd on the same inputs."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(3)
    qkv = [_randn(rng, (2, 96, h, 128), dev, dtype) for h in (8, 4, 4)]
    dout = _randn(rng, (2, 96, 8, 128), dev, dtype)
    grads = {}
    for impl in ("kernel", "reference"):
        leaves = [x.clone().requires_grad_(True) for x in qkv]
        n0 = fa.flash_attention_bwd_cuda.launches
        out = fa_ops.flash_attention(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, dout)
        assert fa.flash_attention_bwd_cuda.launches == n0 + (
            impl == "kernel")
    tol = AUTOGRAD_RTOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), grads["kernel"],
                          grads["reference"]):
        assert g.dtype == dtype and _close(f"autograd {name}", g, r, tol)

    hid = _randn(rng, (300, 64), dev, dtype)
    table = _randn(rng, (1000, 64), dev, dtype) * 0.125
    labels = torch.from_numpy(rng.integers(0, 1000, 300)).to(dev)
    weights = torch.from_numpy((rng.random(300) > 0.2).astype(
        np.float32)).to(dev)
    grads = {}
    for impl in ("kernel", "reference"):
        h = hid.clone().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        n0 = (ce.cross_entropy_cuda.launches, ce.ce_dlogits_cuda.launches)
        loss, _ = ce_ops.weighted_cross_entropy(
            h, t.t(), labels, weights, label_smoothing=0.1, impl=impl,
            chunk_size=128)
        grads[impl] = (loss.detach(), *torch.autograd.grad(loss, (h, t)))
        want = (n0[0] + 1, n0[1] + 3) if impl == "kernel" else n0
        assert (ce.cross_entropy_cuda.launches,
                ce.ce_dlogits_cuda.launches) == want
    for name, g, r in zip(("loss", "dh", "dtable"), grads["kernel"],
                          grads["reference"]):
        assert _close(f"autograd {name}", g, r, tol)
    assert not grads["kernel"][1][weights == 0].any()


# --------------------------------------------------------------------------
# the int8 exchange kernels: bitwise equal to their plain versions
# --------------------------------------------------------------------------


def _stack(rng, rows, dev, zero_rows=(0,)):
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    x *= rng.uniform(1e-3, 10.0, (rows, 1)).astype(np.float32)
    x[list(zero_rows)] = 0.0                    # all-zero blocks
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("rows,stochastic", [
    (1, False), (7, False), (9, False), (1001, False), (4099, True),
    (20001, True)])
def test_quantize_kernel_bitwise_equal_plain(dev, rows, stochastic):
    """Odd row counts (a partial last block of 8 warps), zero blocks, and
    stochastic rounding with noise from a seeded generator."""
    x = _stack(np.random.default_rng(rows), rows, dev,
               zero_rows=(0, rows - 1))
    noise = None
    if stochastic:
        gen = torch.Generator(device=dev).manual_seed(rows)
        noise = torch.rand((rows, 256), generator=gen, device=dev)
    n0 = qz.quantize_int8_cuda.launches
    q, s = qz.quantize_int8_cuda(x, noise)
    assert qz.quantize_int8_cuda.launches == n0 + 1
    qr, sr = q_ref.quantize_blocks(x, noise)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, qr)
    assert torch.equal(s.view(torch.int32), sr.view(torch.int32))
    assert float(s[0]) == np.float32(1e-12) and not q[0].any()
    if rows > 2:
        assert int(q.abs().max()) == 127


@pytest.mark.parametrize("ranks,rows", [(1, 5), (2, 1001), (3, 7),
                                        (8, 4099), (64, 33)])
def test_dequant_accum_kernel_bitwise_equal_plain(dev, ranks, rows):
    rng = np.random.default_rng(ranks * rows)
    q = torch.from_numpy(rng.integers(-127, 128, (ranks, rows, 256)).astype(
        np.int8)).to(dev)
    s = torch.from_numpy((rng.random((ranks, rows)) * 0.1).astype(
        np.float32)).to(dev)
    n0 = qz.dequant_accum_cuda.launches
    got = qz.dequant_accum_cuda(q, s)
    assert qz.dequant_accum_cuda.launches == n0 + 1
    want = q_ref.dequant_accum(q, s)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_quantize_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((4, 256), device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        qz.quantize_int8_cuda(x.cpu())
    with pytest.raises(ValueError, match=r"\(rows, 256\)"):
        qz.quantize_int8_cuda(torch.zeros((4, 128), device=dev))
    with pytest.raises(TypeError):
        qz.quantize_int8_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        qz.quantize_int8_cuda(torch.zeros((256, 4), device=dev).t())
    q = torch.zeros((65, 2, 256), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="ranks"):
        qz.dequant_accum_cuda(q, torch.zeros((65, 2), device=dev))


# --------------------------------------------------------------------------
# absorbed-MLA decode kernels, the D=192 prefill, the MLA serving path
# --------------------------------------------------------------------------

def _mla_paged(rng, dev, dtype, h, bs, mb, lens):
    """deepseek-v2 latent widths (r=512, Dr=64): ragged lengths, NULL
    holes (N and -1), an all-NULL inactive slot with length 1."""
    b, n = len(lens), len(lens) * mb
    qa = _randn(rng, (b, h, md.RANK), dev, dtype)
    qr = _randn(rng, (b, h, md.ROPE_DIM), dev, dtype)
    cp = _randn(rng, (n, bs, md.RANK), dev, dtype)
    kp = _randn(rng, (n, bs, md.ROPE_DIM), dev, dtype)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    for i, ln in enumerate(lens):
        nb = min(-(-ln // bs), mb)
        if ln > 1:
            tables[i, :nb] = perm[i * mb:i * mb + nb]
        if nb > 2:
            tables[i, nb // 2] = n if i % 2 else -1
    return (qa, qr, cp, kp, torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("h,bs,mb,lens", [
    (128, 16, 32, [512, 1, 37, 200, 16, 301, 455, 129]),   # the serve path
    (20, 12, 5, [60, 1, 13, 59]),     # heads not a multiple of 16, bs 12
    (16, 16, 4, [80, 64, 1]),         # kv_len past the window
])
def test_mla_paged_decode_kernel_matches_plain(dev, dtype, tol, h, bs, mb,
                                               lens):
    rng = np.random.default_rng(h * bs + mb)
    args = _mla_paged(rng, dev, dtype, h, bs, mb, lens)
    n0 = md.mla_decode_paged_cuda.launches
    got = md.mla_decode_paged_cuda(*args, 192 ** -0.5)
    assert md.mla_decode_paged_cuda.launches == n0 + 1
    want = mla_ref.mla_decode_paged_online_plain(*args, 192 ** -0.5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("h,s,lens", [
    (128, 200, [200, 1, 77, 16]),
    (128, 2048, [2048, 513, 1000, 3]),
    (24, 40, [40, 39, 1]),
])
def test_mla_contiguous_decode_kernel_matches_plain(dev, dtype, tol, h, s,
                                                    lens):
    rng = np.random.default_rng(h + s)
    b = len(lens)
    qa = _randn(rng, (b, h, md.RANK), dev, dtype)
    qr = _randn(rng, (b, h, md.ROPE_DIM), dev, dtype)
    ckv = _randn(rng, (b, s, md.RANK), dev, dtype)
    kr = _randn(rng, (b, s, md.ROPE_DIM), dev, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = md.mla_decode_cuda.launches
    got = md.mla_decode_cuda(qa, qr, ckv, kr, lens, 0.1)
    assert md.mla_decode_cuda.launches == n0 + 1
    want = mla_ref.mla_decode_online_plain(qa, qr, ckv, kr, lens, 0.1)
    assert _err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,s,h", [(2, 16, 128), (1, 200, 8), (2, 70, 4)])
def test_prefill_kernel_head_dim_192_matches_plain(dev, dtype, tol, b, s, h):
    rng = np.random.default_rng(s + h)
    q, k, v = (_randn(rng, (b, s, h, 192), dev, dtype) for _ in range(3))
    got = fa.flash_attention_cuda(q, k, v, causal=True,
                                  softmax_scale=192 ** -0.5)
    want = fa.flash_attention_plain(q, k, v, causal=True,
                                    softmax_scale=192 ** -0.5)
    assert _err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("h", [128, 16])
def test_mla_paged_decode_kernel_repeats_and_is_batch_invariant(dev, dtype,
                                                                tol, h):
    """Equal bits on a second run, and one sequence alone (a 20-block
    table) gives the bits it gets inside a batch of 8 with a 64-block
    table (more splits of the window in bf16)."""
    rng = np.random.default_rng(6 + h)
    lens = [1000, 1, 37, 300, 16, 512, 455, 129]
    args = _mla_paged(rng, dev, dtype, h, 16, 64, lens)
    qa, qr, cp, kp, tables, kv_lens = args
    got = md.mla_decode_paged_cuda(*args, 0.1)
    assert _err(got, mla_ref.mla_decode_paged_online_plain(*args, 0.1)) <= tol
    assert not got[1].any()
    assert torch.equal(md.mla_decode_paged_cuda(*args, 0.1), got)
    seq = 3
    alone = md.mla_decode_paged_cuda(
        qa[seq:seq + 1].contiguous(), qr[seq:seq + 1].contiguous(), cp, kp,
        tables[seq:seq + 1, :20].contiguous(), kv_lens[seq:seq + 1], 0.1)
    assert md.mla_splits(20, 16) < md.mla_splits(64, 16)
    assert torch.equal(alone[0], got[seq])


@pytest.mark.parametrize("lens", [[1088] * 4, [1088, 1, 513, 700]])
def test_mla_contiguous_bf16_kernel_matches_split_model_and_repeats(dev,
                                                                    lens):
    """The bf16 contiguous kernel (tensor cores, positions split across
    blocks) at the generate shape (B=4, H=128, S=1088): within 2e-3 of
    the split model (which follows its tiles, splits and rounding) and
    2e-2 of the online plain version, one launch a call,
    equal bits on a second run, and a sequence alone over a shorter cache
    (fewer splits) gets the bits it gets inside a batch of 8."""
    rng = np.random.default_rng(len(set(lens)))
    b, h, s = len(lens), 128, 1088
    qa = _randn(rng, (b, h, md.RANK), dev, torch.bfloat16)
    qr = _randn(rng, (b, h, md.ROPE_DIM), dev, torch.bfloat16)
    ckv = _randn(rng, (b, s, md.RANK), dev, torch.bfloat16)
    kr = _randn(rng, (b, s, md.ROPE_DIM), dev, torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (qa, qr, ckv, kr, kv_len, 192 ** -0.5)
    n0 = md.mla_decode_cuda.launches
    got = md.mla_decode_cuda(*args)
    assert md.mla_decode_cuda.launches == n0 + 1
    assert _err(got, md.mla_decode_split_plain(*args)) <= 2e-3
    assert _err(got, mla_ref.mla_decode_online_plain(*args)) <= 2e-2
    assert torch.equal(md.mla_decode_cuda(*args), got)
    seq = 2
    wide = [torch.cat([t] * 2) for t in args[:5]]
    batched = md.mla_decode_cuda(*wide, 192 ** -0.5)
    alone = md.mla_decode_cuda(
        qa[seq:seq + 1].contiguous(), qr[seq:seq + 1].contiguous(),
        ckv[seq:seq + 1, :lens[seq]].contiguous(),
        kr[seq:seq + 1, :lens[seq]].contiguous(), kv_len[seq:seq + 1],
        192 ** -0.5)
    assert md.mla_splits(1, lens[seq]) <= md.mla_splits(1, s)
    assert torch.equal(batched[seq], got[seq])
    assert torch.equal(alone[0], batched[b + seq])


def test_mla_and_ssd_take_the_tiles_the_cpu_models_follow(dev):
    """The split, tile and partial length of mla_decode_paged_split_plain
    and the row tile of ssd_scan_tiled_plain
    (tests/test_torch_sm90_numerics.py) are the ones the built kernels
    launch with."""
    from repro_torch.kernels import _build
    lib = _build.load()
    assert lib.mla_decode_paged_split_len() == md.SPLIT
    assert lib.mla_decode_paged_tile() == md.TILE
    assert lib.mla_decode_paged_part_len() == md.PART
    assert lib.mla_decode_paged_sm90_smem() > 0
    assert lib.ssd_scan_sm90_tile() == sk.ROW_TILE
    assert lib.ssd_scan_sm90_smem(0) > 0 and lib.ssd_scan_sm90_smem(1) > 0


def test_mla_kernels_refuse_what_they_do_not_take(dev):
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, device=dev,
                                                     dtype=dt)
    lens = torch.ones((2,), dtype=torch.int32, device=dev)
    tables = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="r=512"):
        md.mla_decode_cuda(z(2, 4, 256), z(2, 4, 64), z(2, 8, 256),
                           z(2, 8, 64), lens, 1.0)
    with pytest.raises(TypeError, match="share a dtype"):
        md.mla_decode_paged_cuda(z(2, 4, 512), z(2, 4, 64),
                                 z(6, 16, 512, dt=torch.bfloat16),
                                 z(6, 16, 64, dt=torch.bfloat16), tables,
                                 lens, 1.0)
    with pytest.raises(TypeError, match="int32"):
        md.mla_decode_paged_cuda(z(2, 4, 512), z(2, 4, 64), z(6, 16, 512),
                                 z(6, 16, 64), tables.long(), lens, 1.0)
    with pytest.raises(ValueError, match="D in"):
        q = z(1, 8, 4, 192)
        fa.flash_attention_bwd_cuda(q, q, q, q, z(1, 8, 4), q)


# kernel route vs reference route of the MLA serving path at fp32 (TF32
# off), a model with deepseek-v2's MLA widths and a narrow residual
# stream: logits relative to the largest reference logit
MLA_PATH_TOL = 1e-4


def test_mla_serving_kernel_path_matches_reference(dev):
    import dataclasses
    from repro_torch.configs.base import resolve
    from repro_torch.models.kvcache import PagedLayout
    from repro_torch.models.model import build_model
    full = resolve("deepseek-v2-236b")
    cfg = dataclasses.replace(
        full, num_layers=2, d_model=256, vocab_size=512, num_heads=20,
        num_kv_heads=20, compute_dtype="float32", param_dtype="float32",
        moe=dataclasses.replace(full.moe, num_experts=8, expert_d_ff=128,
                                shared_d_ff=128), attention_impl="kernel")
    kern = build_model(cfg, dev)
    ref = build_model(dataclasses.replace(cfg, attention_impl="reference"),
                      dev)
    params = kern.init_params(0)
    layout = PagedLayout(block_size=16, num_blocks=12, max_blocks_per_seq=6)
    rng = np.random.default_rng(0)
    lens = torch.tensor([40, 23], dtype=torch.int32, device=dev)
    tables = torch.tensor([[0, 1, 2, 3, 12, 12], [4, 5, 12, 12, 12, 12]],
                          dtype=torch.int32, device=dev)
    x = torch.from_numpy(rng.integers(0, 512, (2, 48)).astype(np.int32)
                         ).to(dev)
    caches = {}
    outs = {}
    for name, model in (("kernel", kern), ("reference", ref)):
        n0 = (fa.flash_attention_cuda.launches,
              md.mla_decode_paged_cuda.launches)
        c = model.init_paged_cache(layout)
        pre, c = model.prefill_paged(params, x, lens, c, tables)
        dec, c = model.decode_paged(params, x[:, 47], c, tables, lens)
        caches[name], outs[name] = c, (pre, dec)
        launched = (fa.flash_attention_cuda.launches - n0[0],
                    md.mla_decode_paged_cuda.launches - n0[1])
        assert launched == ((2, 2) if name == "kernel" else (0, 0))
    for got, want in zip(outs["kernel"], outs["reference"]):
        scale = max(1.0, want.abs().max().item())
        assert _err(got, want) <= MLA_PATH_TOL * scale
    for key in ("c_kv", "k_rope"):
        assert _err(caches["kernel"][key], caches["reference"][key]) <= 1e-4


def test_mla_static_kernel_path_matches_reference(dev):
    """deepseek-v2's MLA widths (r=512, Dr=64, head dim 192) and a narrow
    residual stream through ``static_generate`` at fp32 (TF32 off): the
    kernel route (the D=192 prefill once a layer, the contiguous MLA
    decode once a layer a step) and the reference route give identical
    greedy tokens; a prefill and one decode step agree within
    ``MLA_PATH_TOL``, and so do their caches."""
    import dataclasses
    from repro_torch.configs.base import resolve
    from repro_torch.launch.serve import static_generate
    from repro_torch.models.model import build_model
    full = resolve("deepseek-v2-236b")
    cfg = dataclasses.replace(
        full, num_layers=2, d_model=256, vocab_size=512, num_heads=20,
        num_kv_heads=20, compute_dtype="float32", param_dtype="float32",
        moe=dataclasses.replace(full.moe, num_experts=8, expert_d_ff=128,
                                shared_d_ff=128), attention_impl="kernel")
    kern = build_model(cfg, dev)
    ref = build_model(dataclasses.replace(cfg, attention_impl="reference"),
                      dev)
    params = kern.init_params(0)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 150)).astype(
        np.int32)
    x = torch.from_numpy(prompts).to(dev)
    outs, toks = {}, {}
    for name, model in (("kernel", kern), ("reference", ref)):
        n0 = (fa.flash_attention_cuda.launches, md.mla_decode_cuda.launches)
        logits, cache = model.prefill(params, x, max_len=152)
        dec, cache = model.decode(params, x[:, -1], cache, 150)
        outs[name] = (logits, dec, cache)
        toks[name] = static_generate(model, params, prompts, 6)
        launched = (fa.flash_attention_cuda.launches - n0[0],
                    md.mla_decode_cuda.launches - n0[1])
        assert launched == ((4, 12) if name == "kernel" else (0, 0))
    for got, want in zip(outs["kernel"][:2], outs["reference"][:2]):
        scale = max(1.0, want.abs().max().item())
        assert _err(got, want) <= MLA_PATH_TOL * scale
    for key in ("c_kv", "k_rope"):
        assert _err(outs["kernel"][2][key], outs["reference"][2][key]) <= 1e-4
    assert np.array_equal(toks["kernel"], toks["reference"])


# --------------------------------------------------------------------------
# zamba2: the SSD scan kernel, the head-dim-80 prefill, the static path
# --------------------------------------------------------------------------

def _ssd_inputs(rng, dev, dtype, b, s, h, g, use_d, p=64):
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    x = f(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(f(b, s, h) - 2.0)
    A = -torch.exp(f(h) * 0.5)
    Bm, Cm = (f(b, s, g, 64) * 0.3).to(dtype), (f(b, s, g, 64) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm, (f(h) if use_d else None)


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
@pytest.mark.parametrize("b,s,h,g,chunk,use_d", [
    (4, 1024, 80, 1, 256, True),      # zamba2's prefill shape
    (4, 1000, 80, 1, 256, True),      # ragged tail
    (2, 100, 80, 1, 256, True),       # S shorter than the chunk
    (2, 512, 8, 2, 256, True),        # groups
    (2, 300, 6, 3, 128, True),        # groups, ragged
    (2, 700, 16, 1, 256, False),      # no D
])
def test_ssd_scan_kernel_matches_plain(dev, dtype, b, s, h, g, chunk,
                                       use_d):
    rng = np.random.default_rng(s + h + g)
    args = _ssd_inputs(rng, dev, dtype, b, s, h, g, use_d)
    n0 = sk.ssd_scan_cuda.launches
    y, fin = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    assert sk.ssd_scan_cuda.launches == n0 + 1
    yw, fw = ssd_ref.ssd_chunked(*args, chunk_size=chunk)
    assert y.dtype == dtype and fin.dtype == torch.float32
    tol = RTOL[("ssd_scan_cuda", dtype)]
    assert _close("ssd y", y, yw, tol)
    assert _close("ssd final", fin, fw, tol)


@pytest.mark.parametrize("b,s,h,g,chunk,use_d,p", [
    (4, 1024, 80, 1, 256, True, 64),  # zamba2's prefill shape
    (2, 100, 8, 1, 256, True, 64),    # Q = 100: a 36-row second tile
    (2, 300, 6, 3, 96, True, 64),     # Q = 96, groups, ragged tail
    (1, 400, 4, 2, 200, False, 96),   # Q = 200, P of 1.5 slices, no D
    (2, 130, 4, 1, 130, True, 32),    # Q = 130, P = 32
])
def test_bf16_ssd_scan_kernel_matches_plain_and_repeats(dev, b, s, h, g,
                                                        chunk, use_d, p):
    rng = np.random.default_rng(s + h + g + p)
    args = _ssd_inputs(rng, dev, torch.bfloat16, b, s, h, g, use_d, p)
    n0 = sk.ssd_scan_cuda.launches
    y, fin = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    assert sk.ssd_scan_cuda.launches == n0 + 1
    yw, fw = ssd_ref.ssd_chunked(*args, chunk_size=chunk)
    tol = RTOL[("ssd_scan_cuda", torch.bfloat16)]
    assert _close("ssd y", y, yw, tol)
    assert _close("ssd final", fin, fw, tol)
    y2, fin2 = sk.ssd_scan_cuda(*args, chunk_size=chunk)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
@pytest.mark.parametrize("b,s,h,hkv", [(4, 1024, 32, 32), (2, 200, 8, 2),
                                       (1, 16, 32, 32)])
def test_prefill_kernel_head_dim_80_matches_plain(dev, dtype, b, s, h, hkv):
    rng = np.random.default_rng(s + h)
    q = _randn(rng, (b, s, h, 80), dev, dtype)
    k, v = (_randn(rng, (b, s, hkv, 80), dev, dtype) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert got.shape == q.shape
    assert _close("prefill D=80", got, want,
                  RTOL[("flash_attention_cuda", dtype)])


def test_ssd_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(0)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, dev, torch.float32, 1, 8, 4, 1,
                                      True)
    with pytest.raises(ValueError, match="N == 64"):
        sk.ssd_scan_cuda(x, dt, A, Bm[..., :32].contiguous(),
                         Cm[..., :32].contiguous(), D)
    with pytest.raises(ValueError, match="P % 32"):
        sk.ssd_scan_cuda(x[..., :48].contiguous(), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="chunk of 1..256"):
        sk.ssd_scan_cuda(torch.cat([x] * 40, 1), torch.cat([dt] * 40, 1), A,
                         torch.cat([Bm] * 40, 1), torch.cat([Cm] * 40, 1),
                         D, chunk_size=300)
    with pytest.raises(TypeError, match="B/C dtypes"):
        sk.ssd_scan_cuda(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), D)
    with pytest.raises(TypeError, match="float32"):
        sk.ssd_scan_cuda(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_scan_cuda(x.transpose(1, 2), dt, A, Bm, Cm, D)


# kernel route vs reference route of zamba2's static path at fp32 (TF32
# off), zamba2's SSM and attention widths over a narrow residual stream:
# logits relative to the largest reference logit
ZAMBA_PATH_TOL = 1e-4


def test_zamba_static_kernel_path_matches_reference(dev):
    import dataclasses
    from repro_torch.configs.base import resolve
    from repro_torch.launch.serve import static_generate
    from repro_torch.models.model import build_model
    full = resolve("zamba2-2.7b")
    cfg = dataclasses.replace(
        full, num_layers=6, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=80, d_ff=512, vocab_size=512, compute_dtype="float32",
        hybrid=dataclasses.replace(full.hybrid, shared_attn_d_ff=512),
        attention_impl="kernel")
    kern = build_model(cfg, dev)
    ref = build_model(dataclasses.replace(cfg, attention_impl="reference"),
                      dev)
    params = kern.init_params(0)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 300)).astype(np.int32)).to(dev)
    outs = {}
    for name, model in (("kernel", kern), ("reference", ref)):
        n0 = (sk.ssd_scan_cuda.launches, fa.flash_attention_cuda.launches)
        logits, cache = model.prefill(params, x, max_len=302)
        dec, cache = model.decode(params, x[:, -1], cache, 300)
        outs[name] = (logits, dec, cache)
        launched = (sk.ssd_scan_cuda.launches - n0[0],
                    fa.flash_attention_cuda.launches - n0[1])
        assert launched == ((6, 1) if name == "kernel" else (0, 0))
    for got, want in zip(outs["kernel"][:2], outs["reference"][:2]):
        scale = max(1.0, want.abs().max().item())
        assert _err(got, want) <= ZAMBA_PATH_TOL * scale
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        assert _err(outs["kernel"][2][key], outs["reference"][2][key]) \
            <= 1e-4
    toks = {n: static_generate(m, params, x[:, :40].cpu().numpy(), 4)
            for n, m in (("kernel", kern), ("reference", ref))}
    assert np.array_equal(toks["kernel"], toks["reference"])


# --------------------------------------------------------------------------
# xLSTM: the mLSTM scan kernel, the static path
# --------------------------------------------------------------------------

def _mlstm_inputs(rng, dev, dtype, b, s, h, dk, dv):
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    q, k, v = (f(b, s, h, dk).to(dtype), f(b, s, h, dk).to(dtype),
               f(b, s, h, dv).to(dtype))
    return q, k, v, f(b, s, h), f(b, s, h) + 3.0


@pytest.mark.parametrize("dtype", DTYPE_ONLY)
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (4, 1024, 4, 384, 384, 256),      # xlstm-125m's prefill shape
    (4, 1000, 4, 384, 384, 256),      # ragged tail
    (2, 100, 4, 384, 384, 256),       # S shorter than the chunk
    (2, 300, 4, 384, 384, 128),       # the Pallas wrapper's chunk
    (2, 300, 2, 64, 64, 256),         # the smoke widths
    (1, 70, 3, 128, 64, 32),          # dk != dv
])
def test_mlstm_scan_kernel_matches_plain(dev, dtype, b, s, h, dk, dv, chunk):
    rng = np.random.default_rng(s + h + dk)
    args = _mlstm_inputs(rng, dev, dtype, b, s, h, dk, dv)
    n0 = mk.mlstm_scan_cuda.launches
    hout, (C, n, m) = mk.mlstm_scan_cuda(*args, chunk_size=chunk)
    assert mk.mlstm_scan_cuda.launches == n0 + 1
    hw, (Cw, nw, mw) = mk.mlstm_scan_plain(*args, chunk_size=chunk)
    assert hout.dtype == dtype and hout.shape == (b, s, h, dv)
    assert C.shape == (b, h, dk, dv) and n.shape == (b, h, dk)
    assert m.shape == (b, h) and C.dtype == torch.float32
    tol = RTOL[("mlstm_scan_cuda", dtype)]
    for what, got, want in (("h", hout, hw), ("C", C, Cw), ("n", n, nw),
                            ("m", m, mw)):
        assert _close(f"mlstm {what}", got, want, tol)


def test_mlstm_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(0)
    q, k, v, i, f = _mlstm_inputs(rng, dev, torch.float32, 1, 8, 2, 64, 64)
    with pytest.raises(ValueError, match="dk % 64"):
        mk.mlstm_scan_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v, i, f)
    with pytest.raises(ValueError, match="dk <= 512"):
        wide = torch.cat([q] * 9, -1)
        mk.mlstm_scan_cuda(wide, wide, v, i, f)
    with pytest.raises(ValueError, match="chunk of 1..256"):
        big = [torch.cat([t] * 40, 1) for t in (q, k, v, i, f)]
        mk.mlstm_scan_cuda(*big, chunk_size=300)
    with pytest.raises(TypeError, match="k/v dtypes"):
        mk.mlstm_scan_cuda(q, k.bfloat16(), v, i, f)
    with pytest.raises(TypeError, match="float32"):
        mk.mlstm_scan_cuda(q, k, v, i.bfloat16(), f)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mlstm_scan_cuda(q.transpose(1, 2), k, v, i, f)
    with pytest.raises(ValueError, match="disagree"):
        mk.mlstm_scan_cuda(q, k, v, i[:, :4].contiguous(), f)


# kernel route vs reference route of xLSTM's static path at fp32 (TF32
# off), xlstm-125m's mLSTM head dim 384 over 4 layers and a small vocab:
# logits relative to the largest reference logit
XLSTM_PATH_TOL = 1e-4


def test_xlstm_static_kernel_path_matches_reference(dev):
    import dataclasses
    from repro_torch.configs.base import resolve
    from repro_torch.launch.serve import static_generate
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import XLSTM_CACHE
    cfg = dataclasses.replace(resolve("xlstm-125m"), num_layers=4,
                              vocab_size=512, compute_dtype="float32",
                              attention_impl="kernel")
    kern = build_model(cfg, dev)
    ref = build_model(dataclasses.replace(cfg, attention_impl="reference"),
                      dev)
    params = kern.init_params(0)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 300)).astype(np.int32)).to(dev)
    outs = {}
    for name, model in (("kernel", kern), ("reference", ref)):
        n0 = mk.mlstm_scan_cuda.launches
        logits, cache = model.prefill(params, x, max_len=302)
        dec, cache = model.decode(params, x[:, -1], cache, 300)
        outs[name] = (logits, dec, cache)
        assert mk.mlstm_scan_cuda.launches - n0 == (
            2 if name == "kernel" else 0)
    for got, want in zip(outs["kernel"][:2], outs["reference"][:2]):
        scale = max(1.0, want.abs().max().item())
        assert _err(got, want) <= XLSTM_PATH_TOL * scale
    for key in XLSTM_CACHE["mlstm"] + XLSTM_CACHE["slstm"]:
        want = outs["reference"][2][key]
        scale = max(1.0, want.abs().max().item())
        assert _err(outs["kernel"][2][key], want) <= 1e-4 * scale, key
    toks = {n: static_generate(m, params, x[:, :40].cpu().numpy(), 4)
            for n, m in (("kernel", kern), ("reference", ref))}
    assert np.array_equal(toks["kernel"], toks["reference"])
