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
``AUTOGRAD_RTOL``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cross_entropy import cross_entropy as ce
from repro_torch.kernels.cross_entropy import ref as ce_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.parity import RTOL, rel_l2

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
