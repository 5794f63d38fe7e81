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
