"""repro_torch attention against the JAX package: the port's plain
prefill attention vs the Pallas kernel (interpret mode) and the JAX
dense oracle, its paged decode vs the JAX materialize-then-attend
reference, and the ``impl="kernel"`` dispatch on CPU tensors. Inputs are
made with numpy from a seed and handed to both packages.

Tolerances (fp32): 2e-5 absolute where the two sides sum the softmax in
a different order (online vs dense, or another tile size), as the JAX
package's own Pallas-vs-dense test allows; exact equality where the port
runs the very same function on both paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

TOL = 2e-5

# (b, sq, skv, h, hkv, d, causal, q_offset): GQA groups 1, 2 and 4,
# causal and not, q_offset > 0 (chunked prefill), Skv not a tile multiple
PREFILL_CASES = [
    (2, 16, 16, 4, 4, 16, True, 0),          # group 1
    (2, 24, 24, 4, 2, 16, True, 0),          # group 2
    (1, 40, 40, 8, 2, 8, True, 0),           # group 4, ragged vs 8-tiles
    (2, 8, 37, 4, 1, 16, True, 29),          # q_offset, ragged Skv
    (1, 12, 20, 4, 2, 16, False, 0),         # non-causal
]


def _qkv(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,off", PREFILL_CASES)
def test_plain_prefill_matches_pallas_and_dense(b, sq, skv, h, hkv, d,
                                                causal, off):
    q, k, v = _qkv(b, sq, skv, h, hkv, d)
    out_t = tfa.flash_attention_plain(*_t(q, k, v), causal=causal,
                                      q_offset=off).numpy()
    out_p = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=off, block_q=8, block_kv=8, interpret=True))
    out_d = np.asarray(jref.mha_dense(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_offset=off))
    assert out_t.shape == (b, sq, h, d)
    np.testing.assert_allclose(out_t, out_p, atol=TOL, rtol=0)
    np.testing.assert_allclose(out_t, out_d, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_port_reference_and_dense_match_jax_with_kv_len(causal, chunk):
    """Every port impl vs the JAX chunked and dense references, with a
    per-sequence kv_len mask and a chunk size that does not divide Skv."""
    q, k, v = _qkv(2, 10, 45, 8, 2, 16, seed=3)
    kv_len = np.array([17, 45], np.int32)
    tq, tk, tv, tl = _t(q, k, v, kv_len)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, kv_len))
    want = np.asarray(jref.mha_dense(jq, jk, jv, causal=causal,
                                     q_offset=35, kv_len=jl))
    want_c = np.asarray(jref.mha_chunked(jq, jk, jv, causal=causal,
                                         q_offset=35, kv_len=jl,
                                         chunk_size=chunk))
    got_c = tops.flash_attention(tq, tk, tv, causal=causal, q_offset=35,
                                 kv_len=tl, impl="reference",
                                 chunk_size=chunk).numpy()
    got_d = tops.flash_attention(tq, tk, tv, causal=causal, q_offset=35,
                                 kv_len=tl, impl="dense").numpy()
    np.testing.assert_allclose(got_c, want_c, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_c, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_d, want, atol=TOL, rtol=0)


def _paged_case(b, bs, mb, hkv, group, d, seed):
    """Pools with NULL holes inside live windows, one all-NULL inactive
    slot (kv_len 1) and one sequence at exactly mb * bs."""
    rng = np.random.default_rng(seed)
    n = b * mb - 2
    h = hkv * group
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    kv_lens = rng.integers(1, mb * bs + 1, size=b).astype(np.int32)
    kv_lens[0] = mb * bs                 # full window
    kv_lens[-1] = 1                      # inactive slot: all NULL
    used = 0
    for i in range(b - 1):
        nb = -(-int(kv_lens[i]) // bs)
        take = min(nb, n - used)
        tables[i, :take] = perm[used:used + take]
        used += take
        if nb > 1 and i % 2 == 0:
            tables[i, nb // 2] = n       # NULL hole inside the window
    return q, k_pool, v_pool, tables, kv_lens


@pytest.mark.parametrize("b,bs,mb,hkv,group,d", [
    (4, 4, 5, 2, 2, 16),
    (5, 8, 3, 1, 4, 8),
    (3, 16, 2, 2, 1, 16),
])
def test_plain_paged_decode_matches_jax_reference(b, bs, mb, hkv, group, d):
    q, kp, vp, tables, kv_lens = _paged_case(b, bs, mb, hkv, group, d,
                                             seed=b * 10 + bs)
    want = np.asarray(jops.flash_decode_paged(
        *map(jnp.asarray, (q, kp, vp, tables, kv_lens)),
        impl="reference"))
    args = _t(q, kp, vp, tables, kv_lens)
    for impl in ("reference", "kernel"):
        got = tops.flash_decode_paged(*args, impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        # the inactive slot (all NULL, kv_len 1) is exactly zero
        assert not np.any(got[-1])


def test_kernel_impl_on_cpu_runs_plain_version():
    """impl="kernel" on CPU tensors gives the plain version's result, bit
    for bit, and launches nothing."""
    q, k, v = _t(*_qkv(2, 20, 20, 8, 2, 16, seed=5))
    fa0 = tfa.flash_attention_cuda.launches
    dec0 = tfa.flash_decode_paged_cuda.launches
    got = tops.flash_attention(q, k, v, impl="kernel", q_offset=0)
    torch.testing.assert_close(got, tfa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    case = _t(*_paged_case(3, 4, 4, 2, 4, 16, seed=6))
    got = tops.flash_decode_paged(*case, impl="kernel")
    torch.testing.assert_close(got, tfa.flash_decode_paged_plain(*case),
                               rtol=0, atol=0)
    assert tfa.flash_attention_cuda.launches == fa0
    assert tfa.flash_decode_paged_cuda.launches == dec0


def test_kernel_wrappers_refuse_other_devices_and_kv_len():
    """A tensor neither on the CPU nor on CUDA is refused, never computed
    by the plain version; the prefill kernel takes no kv_len."""
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfa.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
    cq, ck, cv = _t(*_qkv(1, 4, 4, 2, 1, 16))
    with pytest.raises(ValueError, match="kv_len"):
        tops.flash_attention(cq, ck, cv, impl="kernel",
                             kv_len=torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.flash_attention(cq, ck, cv, impl="pallas")


# (b, sq, skv, h, hkv, d, q_offset): head dims 64 and 128, GQA groups 1, 2
# and 4, q_offset > 0 and ragged lengths (not multiples of the chunk)
TRAIN_CASES = [
    (2, 24, 24, 4, 4, 64, 0),             # group 1, D=64
    (1, 40, 40, 4, 2, 128, 0),            # group 2, D=128
    (2, 13, 37, 8, 2, 64, 24),            # group 4, q_offset, ragged Skv
    (1, 33, 33, 8, 2, 128, 0),            # group 4 at D=128, ragged S
]
# gradients are sums over up to Skv products: 1e-4 absolute in fp32
GRAD_TOL = 1e-4


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,off", TRAIN_CASES)
def test_lse_forward_matches_jax_chunked(b, sq, skv, h, hkv, d, off):
    """The kernel wrapper's plain version (dense) and the port's chunked
    forward return the lse that JAX ``_mha_chunked_fwd_only(want_lse=True)``
    returns, and the same output."""
    q, k, v = _qkv(b, sq, skv, h, hkv, d, seed=sq + d)
    want, want_lse = jref._mha_chunked_fwd_only(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=off, chunk_size=16, want_lse=True)
    tq, tk, tv = _t(q, k, v)
    got = [tfa.flash_attention_cuda(tq, tk, tv, q_offset=off,
                                    return_lse=True),
           tref.mha_chunked(tq, tk, tv, q_offset=off, chunk_size=16,
                            want_lse=True)]
    for out, lse in got:
        assert lse.shape == (b, sq, h) and lse.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,off", TRAIN_CASES)
def test_attention_grads_match_jax_vjp(impl, b, sq, skv, h, hkv, d, off):
    """``impl="kernel"`` differentiates through ``FlashAttentionFn`` (on
    CPU tensors: the plain forward, then ``flash_bwd_ref``), "reference"
    by autograd through the chunked loop; both give the dq, dk, dv that
    ``jax.vjp`` of JAX ``ref.mha_chunked`` (its custom_vjp ``_flash_bwd``)
    gives."""
    q, k, v = _qkv(b, sq, skv, h, hkv, d, seed=3 * sq + d)
    dout = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jref.mha_chunked(
        a, b_, c, causal=True, q_offset=off, chunk_size=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    n0 = tfa.flash_attention_bwd_cuda.launches
    out = tops.flash_attention(tq, tk, tv, causal=True, q_offset=off,
                               impl=impl, chunk_size=16)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert tfa.flash_attention_bwd_cuda.launches == n0   # CPU: no launch
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=0)


def test_backward_plain_version_is_flash_bwd_ref():
    """The backward wrapper on CPU tensors is ``ref.flash_bwd_ref``, bit
    for bit, and refuses nothing it is given there."""
    q, k, v = _t(*_qkv(1, 20, 20, 4, 2, 64, seed=9))
    out, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.ones_like(out)
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    want = tref.flash_bwd_ref(q, k, v, out, lse, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
