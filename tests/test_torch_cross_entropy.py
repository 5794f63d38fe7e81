"""repro_torch weighted cross entropy against the JAX package: the
kernel wrapper's plain version and the port's dense and chunked forwards
vs the Pallas kernel (interpret mode) and JAX ``ref.ce_dense``; the
gradients of ``CrossEntropyFn`` (on CPU tensors: the plain forward, then
``ce_bwd_ref`` with the plain dlogits pass) vs ``jax.grad`` of JAX
``ref.ce_chunked`` (its custom_vjp ``_ce_bwd``). Inputs come from a numpy
seed and are handed to both packages.

Tolerances (fp32): 1e-4 relative for the loss sums (sums of ~T terms of
size ~log V, summed in another order); 1e-5 for dh and dW, absolute up to
entries of size 1 and relative to the largest entry above (dW sums T
products: at T=9000 its entries reach ~30).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy import ref as jref
from repro.kernels.cross_entropy.cross_entropy import cross_entropy_pallas
from repro_torch.kernels.cross_entropy import cross_entropy as tce
from repro_torch.kernels.cross_entropy import ops as tops
from repro_torch.kernels.cross_entropy import ref as tref

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5

# (t, d, v, eps, softcap): T and V not multiples of any tile, label
# smoothing, a softcapped forward
CASES = [
    (37, 32, 300, 0.0, 0.0),
    (64, 16, 129, 0.1, 0.0),
    (20, 24, 200, 0.0, 5.0),
    (45, 32, 257, 0.1, 3.0),
]


def _inputs(t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    weights = (rng.random(t) > 0.3).astype(np.float32)   # zeros: dummies
    weights[0] = 0.0
    return h, w, labels, weights


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("t,d,v,eps,cap", CASES)
def test_forward_matches_pallas_and_dense(t, d, v, eps, cap):
    h, w, lab, wt = _inputs(t, d, v, seed=t + v)
    jargs = [jnp.asarray(a) for a in (h, w, lab, wt)]
    want_p = cross_entropy_pallas(*jargs, label_smoothing=eps,
                                  logit_softcap=cap, block_t=16,
                                  block_v=128, interpret=True)
    want_d = jref.ce_dense(*jargs, label_smoothing=eps, logit_softcap=cap)
    np.testing.assert_allclose(float(want_p[0]), float(want_d[0]),
                               rtol=LOSS_RTOL)
    args = _t(h, w, lab, wt)
    got = [tce.cross_entropy_cuda(*args, label_smoothing=eps,
                                  logit_softcap=cap)]
    for impl in tops.CE_IMPLS:
        got.append(tops.weighted_cross_entropy(
            *args, label_smoothing=eps, logit_softcap=cap, impl=impl,
            chunk_size=16))
    for loss_sum, w_sum in got:
        assert loss_sum.dtype == torch.float32
        np.testing.assert_allclose(float(loss_sum), float(want_d[0]),
                                   rtol=LOSS_RTOL)
        assert float(w_sum) == float(want_d[1]) == float(wt.sum())


def test_lse_of_plain_version_matches_jax_chunked():
    h, w, lab, wt = _inputs(50, 16, 300, seed=1)
    (_, _), want = jref._ce_chunked_fwd_only(
        *map(jnp.asarray, (h, w, lab, wt)), chunk_size=16, want_lse=True)
    _, _, lse = tce.cross_entropy_cuda(*_t(h, w, lab, wt), return_lse=True)
    (_, _), lse_c = tref.ce_chunked(*_t(h, w, lab, wt), chunk_size=16,
                                    want_lse=True)
    for got in (lse, lse_c):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("t,d,v,eps", [(37, 32, 300, 0.0),
                                       (64, 16, 129, 0.1),
                                       (9000, 8, 40, 0.1)])
def test_grads_match_jax_custom_vjp(t, d, v, eps, tied):
    """dh and dW of ``loss_sum`` through ``CrossEntropyFn`` and through
    autograd of the chunked "reference" equal ``jax.grad`` of JAX
    ``ce_chunked``; ``tied`` passes the head as the transposed view of a
    (V, D) table, as a tied embedding does. T=9000 spans three backward
    chunks of 4096."""
    h, w, lab, wt = _inputs(t, d, v, seed=t * 3 + v)
    dloss = 0.37

    def jloss(hh, ww):
        return dloss * jref.ce_chunked(hh, ww, jnp.asarray(lab),
                                       jnp.asarray(wt), label_smoothing=eps,
                                       chunk_size=16)[0]

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    for impl in ("kernel", "reference"):
        th = torch.from_numpy(h).requires_grad_(True)
        if tied:
            table = torch.from_numpy(np.ascontiguousarray(w.T))
            table.requires_grad_(True)
            head = table.t()
        else:
            table = head = torch.from_numpy(w).requires_grad_(True)
        loss_sum, w_sum = tops.weighted_cross_entropy(
            th, head, *_t(lab, wt), label_smoothing=eps, impl=impl)
        assert not w_sum.requires_grad
        dh, dtable = torch.autograd.grad(dloss * loss_sum, (th, table))
        dw = dtable.t() if tied else dtable
        for g, r in ((dh, want[0]), (dw, want[1])):
            r = np.asarray(r)
            np.testing.assert_allclose(
                g.numpy(), r, rtol=0,
                atol=GRAD_TOL * max(1.0, float(np.abs(r).max())))
        # dummy (weight-0) rows get exactly no gradient
        assert not dh[torch.from_numpy(wt) == 0].any()


def test_dlogits_plain_pass_zeroes_dummy_rows():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(
        np.float32))
    lse = torch.logsumexp(logits, dim=-1)
    labels = torch.from_numpy(rng.integers(0, 50, 6))
    weights = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.5, 1.0])
    for eps in (0.0, 0.1):
        got = tce.ce_dlogits_cuda(logits, lse, labels, weights,
                                  torch.tensor(2.0), label_smoothing=eps,
                                  dtype=torch.float32)
        assert not got[weights == 0].any()
        # each live row sums to 0: softmax minus a distribution, scaled
        np.testing.assert_allclose(got.sum(-1).numpy(), 0.0, atol=1e-6)


def test_softcap_backward_raises():
    h, w, lab, wt = _t(*_inputs(8, 8, 40, seed=2))
    h.requires_grad_(True)
    loss_sum, _ = tops.weighted_cross_entropy(h, w, lab, wt,
                                              logit_softcap=5.0,
                                              impl="kernel")
    with pytest.raises(NotImplementedError, match="softcap"):
        loss_sum.backward()
    with pytest.raises(ValueError, match="unknown cross-entropy impl"):
        tops.weighted_cross_entropy(h, w, lab, wt, impl="pallas")
