"""The repro_torch CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU. Every test here is marked ``cuda`` and skips with a
reason where there is no card; this file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 absolute in fp32 (TF32 off; the kernel sums the
softmax online, the plain version densely) and 2e-2 in bf16 (the two
round to bf16 at different points).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


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
    with pytest.raises(ValueError, match="D == 64"):
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
