"""repro_torch's int8 quantization against the JAX package (CPU).

  (a) the plain ``quantize_int8`` is bitwise equal (codes and scales) to
      JAX's ``ref.quantize_int8``, and its codes to
      ``quantize_int8_pallas`` in interpret mode: padded shapes, an
      all-zero block, block sizes 128 and 256, and stochastic rounding
      with the noise the Pallas kernel draws
      (``jax.random.uniform(key, blocks.shape)``) computed in JAX and
      handed to the port. The interpret-mode kernel's scales are within
      1 ulp: XLA compiles its ``absmax / 127.0`` as a product with the
      reciprocal of 127 (checked below), where the reference and the
      port divide;
  (b) ``dequant_accum`` against ``ref.dequant_accum`` and
      ``dequant_accum_pallas(interpret=True)`` at rtol 1e-6 and an atol
      of 1e-6 of the largest term (the JAX oracle is an einsum, the
      kernels a rank loop: fp reassociation), R in {1, 2, 3, 8}, and
      bitwise against the rank loop in numpy;
  (c) ``fuse_payload`` / ``split_payload``: the port's int8 wire bytes
      equal JAX's and round-trip;
  (d) the ``ops`` dispatch: "reference" and "kernel" agree on CPU
      tensors, nothing is launched, and the CUDA wrappers refuse CPU
      tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels.quantize import ref as jref
from repro.kernels.quantize.quantize import (dequant_accum_pallas,
                                             quantize_int8_pallas)
from repro_torch.core import compression as tcomp
from repro_torch.kernels.quantize import ops as tops
from repro_torch.kernels.quantize import quantize as tq
from repro_torch.kernels.quantize import ref as tref

pytestmark = pytest.mark.pallas_interpret

SHAPES = [(1000,), (3, 700), (4, 256), (2, 5, 129)]


def _x(shape, seed, zero_block=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 5.0)).astype(
        np.float32)
    flat = x.reshape(-1)
    if zero_block and flat.size >= 256:
        flat[:256] = 0.0                      # an all-zero block
    return x


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise_vs_jax_ref_and_pallas(shape, bs):
    x = _x(shape, sum(shape) + bs)
    qj, sj = jref.quantize_int8(jnp.asarray(x), block_size=bs)
    qp, sp = quantize_int8_pallas(jnp.asarray(x), block_size=bs,
                                  interpret=True)
    qt, st = tref.quantize_int8(torch.from_numpy(x), block_size=bs)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qp))
    _assert_pallas_scales(x, bs, st.numpy(), np.asarray(sp))
    assert float(st[0]) == np.float32(1e-12) and not qt[0].any()


def _assert_pallas_scales(x, bs, port, pallas):
    """The port's scales are absmax / 127 (a division), the interpret-mode
    kernel's absmax * float32(1/127), bit for bit; so at most 1 ulp
    apart."""
    blocks = tref.to_blocks(torch.from_numpy(x), bs).numpy()
    amax = np.abs(blocks).max(axis=1)
    tiny = np.float32(1e-12)
    np.testing.assert_array_equal(port, np.maximum(amax / np.float32(127),
                                                   tiny))
    np.testing.assert_array_equal(
        pallas, np.maximum(amax * np.float32(1.0 / 127.0), tiny))
    ulps = np.abs(port.view(np.int32).astype(np.int64)
                  - pallas.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("shape", [(1000,), (3, 700)])
def test_stochastic_rounding_bitwise_with_jax_noise(shape, bs):
    """The Pallas kernel's noise, drawn in JAX over the padded blocks,
    given to the port: the same codes and scales as the kernel and as
    JAX's reference (which draws the same uniform from the same key)."""
    x = _x(shape, 7 * bs)
    key = jax.random.PRNGKey(bs)
    nb = -(-x.size // bs)
    rows = min(256, nb)
    nb_p = nb + (-nb) % rows                 # the kernel's row-tile padding
    noise = np.asarray(jax.random.uniform(key, (nb_p, bs)))
    qp, sp = quantize_int8_pallas(jnp.asarray(x), block_size=bs, key=key,
                                  interpret=True)
    qt, st = tref.quantize_int8(torch.from_numpy(x), block_size=bs,
                                noise=torch.from_numpy(noise[:nb].copy()))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qp))
    _assert_pallas_scales(x, bs, st.numpy(), np.asarray(sp))
    if nb_p == nb:                           # the reference draws alike
        qj, sj = jref.quantize_int8(jnp.asarray(x), block_size=bs, key=key)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    # round to nearest would differ somewhere
    qn, _ = tref.quantize_int8(torch.from_numpy(x), block_size=bs)
    assert not torch.equal(qn, qt)


@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
def test_dequant_accum_vs_jax(ranks):
    rng = np.random.default_rng(ranks)
    blocks, bs = 37, 256
    q = rng.integers(-127, 128, (ranks, blocks, bs)).astype(np.int8)
    s = (rng.random((ranks, blocks)) * 0.1).astype(np.float32)
    got = tref.dequant_accum(torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == (blocks, bs) and got.dtype == torch.float32
    # another order of the same sum moves it by a few ulps of its largest
    # term, a large relative error where terms cancel: atol at 1e-6 of
    # the largest term
    atol = 1e-6 * float(np.abs(q).max() * s.max())
    for want in (jref.dequant_accum(jnp.asarray(q), jnp.asarray(s)),
                 dequant_accum_pallas(jnp.asarray(q), jnp.asarray(s),
                                      interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=atol)
    # the rank loop in order, one rounded product and sum per rank
    acc = np.zeros((blocks, bs), np.float32)
    for r in range(ranks):
        acc = acc + q[r].astype(np.float32) * s[r][:, None]
    np.testing.assert_array_equal(got.numpy(), acc)


def test_fuse_split_payload_bytes_equal_jax():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (2, 3, 5, 256)).astype(np.int8)
    s = (rng.random((2, 3, 5)) * 1e-3).astype(np.float32)
    want = np.asarray(jcomp.fuse_payload(jnp.asarray(q), jnp.asarray(s)))
    got = tcomp.fuse_payload(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.int8 and got.shape == (2, 3, 5, 260)
    np.testing.assert_array_equal(got.numpy(), want)
    q2, s2 = tcomp.split_payload(got, 256)
    np.testing.assert_array_equal(q2.numpy(), q)
    np.testing.assert_array_equal(s2.numpy(), s)
    jq, js = jcomp.split_payload(jnp.asarray(want), 256)
    np.testing.assert_array_equal(np.asarray(js), s2.numpy())


def test_compress_tree_and_ratio_match_jax():
    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((300,), (4, 70), (2, 3, 128))]
    errs = [(rng.standard_normal(l.shape) * 1e-3).astype(np.float32)
            for l in leaves]
    (jq, js), jne = jcomp.compress_tree([jnp.asarray(l) for l in leaves],
                                        [jnp.asarray(e) for e in errs])
    (tq_, ts), tne = tcomp.compress_tree([torch.from_numpy(l)
                                          for l in leaves],
                                         [torch.from_numpy(e)
                                          for e in errs])
    for a, b in zip(tq_, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tne, jne):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    back = tcomp.decompress_tree(tq_, ts, [l.shape for l in leaves])
    jback = jcomp.decompress_tree(jq, js, [jnp.asarray(l) for l in leaves])
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tcomp.compression_ratio([torch.from_numpy(l) for l in leaves]) \
        == jcomp.compression_ratio([jnp.asarray(l) for l in leaves])


def test_ops_dispatch_on_cpu():
    x = torch.from_numpy(_x((5, 300), 5))
    n = (tq.quantize_int8_cuda.launches, tq.dequant_accum_cuda.launches)
    qr, sr = tops.quantize_int8(x, impl="reference")
    qk, sk = tops.quantize_int8(x, impl="kernel")
    assert torch.equal(qr, qk) and torch.equal(sr, sk)
    q = torch.stack([qr, qk]).contiguous()
    s = torch.stack([sr, sk])
    assert torch.equal(tops.dequant_accum(q, s, impl="kernel"),
                       tops.dequant_accum(q, s, impl="reference"))
    assert (tq.quantize_int8_cuda.launches,
            tq.dequant_accum_cuda.launches) == n   # nothing launched
    assert tops.impl_of("pallas") == "kernel"
    assert tops.impl_of("reference") == "reference"
    with pytest.raises(ValueError, match="unknown quantize impl"):
        tops.quantize_int8(x, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.quantize_int8_cuda(qr.float())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.dequant_accum_cuda(q, s)
