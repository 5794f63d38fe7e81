"""The int8 exchange's three legs (``kernels/quantize/ref.py``:
``exchange_send``, ``exchange_receive``, ``exchange_decode``, through
``ops.py``'s dispatch) against the JAX package's send, receive and
gather arithmetic (CPU, one process, no spawn).

Every rank of a chunk of ``nbc`` buckets over ``p`` ranks is simulated in
this process: each rank's send leg, the ``all_to_all`` as the messages
taken out of the wires, each rank's receive leg, the gather leg's
``all_to_all`` and each rank's decode. Against JAX
(``repro.kernels.quantize.ref``, ``repro.core.compression``):

  * the send leg's codes, scales and wire bytes are bitwise JAX's payload
    of the data rows in message order (as ``test_torch_buckets.py``'s
    ``_expected_wires`` builds it), and the padding rows are never sent;
  * the receive leg's payload is bitwise JAX's ``quantize_int8`` of the
    shard sum taken in rank order (which ``jref.dequant_accum``, an
    einsum, matches within 1e-6: fp reassociation), written once a rank;
  * both residuals are within 1e-6 of JAX's jitted ``corrected - q * s``
    and ``e + (sum - q2 * s2)`` (XLA fuses the product into the
    difference, the port rounds it first: see
    ``test_torch_buckets.py::test_jax_residual_is_a_fused_multiply_add``),
    and the padding rows of the error state are zero;
  * the decoded chunk is bitwise JAX's ``q * s`` of the gathered
    payloads, zero past each rank's data rows.

Cases: p in {1, 2, 3}, nbc in {1, 3}, with and without an error state,
all rows data or a ``d_rows`` cut inside the last bucket.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels.quantize import ref as jref
from repro_torch.kernels.quantize import ops as tops
from repro_torch.kernels.quantize import ref as tref

BS = 256
NS = 3                               # blocks a shard
RESIDUAL_ATOL = 1e-6


def _cut(nbc, p, kind):
    if kind == "full":
        return nbc * p * NS
    # inside the last bucket: rank 0's slot whole and one row of rank 1's
    # (with one rank, all but the slot's last row)
    return (nbc - 1) * p * NS + min(p * NS - 1, NS + 1)


def _inputs(nbc, p, with_err, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((p, nbc, p, NS * BS))
         * rng.uniform(0.1, 3.0, (p, nbc, p, 1))).astype(np.float32)
    x[0, 0, 0, :BS] = 0.0                          # an all-zero block
    err = ((rng.standard_normal(x.shape) * 0.01).astype(np.float32)
           if with_err else None)
    return x, err


def _jax_messages(corrected, d_rows, nbc, p):
    """JAX's payload of the data rows of one rank's corrected chunk, as
    the message to each rank (rows (k, j, b) in (k, b) order)."""
    q, s = jref.quantize_int8(jnp.asarray(corrected.reshape(-1, BS)
                                          [:d_rows]), block_size=BS)
    payload = np.zeros((nbc * p * NS, BS + 4), np.int8)
    payload[:d_rows] = np.asarray(jcomp.fuse_payload(q, s))
    rows = np.arange(nbc * p * NS).reshape(nbc, p, NS)
    payload = payload.reshape(nbc, p, NS, BS + 4)
    return [payload[:, j].reshape(-1, BS + 4)[rows[:, j].reshape(-1)
                                              < d_rows]
            for j in range(p)], (np.asarray(q), np.asarray(s))


@jax.jit
def _jax_residual(c, q, s):
    return c - q.astype(jnp.float32) * s[:, None]


@jax.jit
def _jax_residual2(e, total, q2, s2):
    return e + (total - q2.astype(jnp.float32) * s2[:, None])


@pytest.mark.parametrize("kind", ["full", "cut"])
@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("nbc", [1, 3])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_legs_match_jax(p, nbc, with_err, kind):
    d_rows = _cut(nbc, p, kind)
    x, err = _inputs(nbc, p, with_err, seed=100 * p + 10 * nbc + with_err)
    lens = tref.message_rows(nbc, p, NS, d_rows)
    assert sum(lens) == d_rows
    if kind == "cut":
        assert d_rows % (p * NS) and (p == 1 or min(lens) < max(lens))
    xs = [torch.from_numpy(x[r].copy()) for r in range(p)]
    es = [torch.from_numpy(err[r].copy()) if with_err else None
          for r in range(p)]

    # the send leg, every rank
    wires = []
    for r in range(p):
        corrected = x[r] + (err[r] if with_err else 0.0)
        want_msgs, (jq, js) = _jax_messages(corrected, d_rows, nbc, p)
        wire, got_lens = tops.exchange_send(xs[r], es[r], d_rows,
                                            impl="kernel")
        assert got_lens == lens
        np.testing.assert_array_equal(wire.numpy(),
                                      np.concatenate(want_msgs))
        np.testing.assert_array_equal(xs[r].numpy(), x[r])  # x untouched
        if with_err:
            er = es[r].numpy().reshape(-1, BS)
            want = np.asarray(_jax_residual(jnp.asarray(
                corrected.reshape(-1, BS)[:d_rows]), jq, js))
            np.testing.assert_allclose(er[:d_rows], want, rtol=0,
                                       atol=RESIDUAL_ATOL)
            assert not er[d_rows:].any()
        wires.append(wire)

    # the all_to_all, the receive leg, every rank
    pre = np.concatenate([[0], np.cumsum(lens)])
    outs = []
    for me in range(p):
        rx = torch.stack([w[pre[me]:pre[me + 1]] for w in wires])
        e_before = es[me].numpy().copy() if with_err else None
        out = tops.exchange_receive(rx, es[me], me, impl="kernel")
        q_x, s_x = (np.asarray(a) for a in jcomp.split_payload(
            jnp.asarray(rx.numpy()), BS))
        total = np.zeros((lens[me], BS), np.float32)
        for r in range(p):                        # rank order
            total = total + q_x[r].astype(np.float32) * s_x[r][:, None]
        np.testing.assert_allclose(
            total, np.asarray(jref.dequant_accum(q_x, s_x)), rtol=1e-6,
            atol=1e-6 * float(np.abs(total).max(initial=1.0)))
        q2, s2 = jref.quantize_int8(jnp.asarray(total), block_size=BS)
        payload2 = np.asarray(jcomp.fuse_payload(q2, s2))
        np.testing.assert_array_equal(out.numpy(), np.tile(payload2, (p, 1)))
        if with_err:
            mine = e_before.reshape(nbc, p, NS, BS)[:, me].reshape(-1, BS)
            want = np.asarray(_jax_residual2(
                jnp.asarray(mine[:lens[me]]), jnp.asarray(total), q2, s2))
            got = es[me].numpy().reshape(nbc, p, NS, BS)[:, me].reshape(
                -1, BS)
            np.testing.assert_allclose(got[:lens[me]], want, rtol=0,
                                       atol=RESIDUAL_ATOL)
            np.testing.assert_array_equal(got[lens[me]:],
                                          mine[lens[me]:])
            others = [j for j in range(p) if j != me]
            np.testing.assert_array_equal(
                es[me].numpy().reshape(nbc, p, NS, BS)[:, others],
                e_before.reshape(nbc, p, NS, BS)[:, others])
        outs.append((out, payload2))

    # the gather leg's all_to_all, the decode, every rank
    want_x = np.zeros((nbc, p, NS, BS), np.float32)
    for j, (_, payload2) in enumerate(outs):
        qg, sg = (np.asarray(a) for a in jcomp.split_payload(
            jnp.asarray(payload2), BS))
        vals = np.asarray(jnp.asarray(qg).astype(jnp.float32)
                          * jnp.asarray(sg)[:, None])
        slot = np.zeros((nbc * NS, BS), np.float32)
        slot[:lens[j]] = vals
        want_x[:, j] = slot.reshape(nbc, NS, BS)
    for me in range(p):
        gathered = torch.cat([out[me * lens[j]:(me + 1) * lens[j]]
                              for j, (out, _) in enumerate(outs)])
        got = tops.exchange_decode(gathered, lens, xs[me], impl="kernel")
        assert got is xs[me]
        np.testing.assert_array_equal(
            xs[me].numpy().view(np.int32),
            want_x.reshape(x[me].shape).view(np.int32))


def test_wire_rows_and_empty_messages():
    """The wire's row order, an empty message (a rank whose slot of the
    only bucket holds no data row) and an empty receive."""
    nbc, p = 2, 3
    lens = tref.message_rows(nbc, p, NS, 4)
    assert lens == [3, 1, 0]
    np.testing.assert_array_equal(
        tref.wire_rows(nbc, p, NS, lens).numpy(), [0, 1, 2, 3])
    lens = tref.message_rows(nbc, p, NS, nbc * p * NS)
    order = tref.wire_rows(nbc, p, NS, lens).numpy()
    assert sorted(order) == list(range(nbc * p * NS))
    assert list(order[:2 * NS]) == [0, 1, 2, 9, 10, 11]
    x = torch.ones((nbc, p, NS * BS))
    e = torch.full_like(x, 0.5)
    wire, lens = tops.exchange_send(x, e, 4)
    assert wire.shape == (4, BS + 4) and lens == [3, 1, 0]
    assert not e.view(-1, BS)[4:].any()
    out = tops.exchange_receive(wire[:0].view(p, 0, BS + 4), e, 2)
    assert out.shape == (0, BS + 4)


def test_legs_refuse_a_card_block_size_they_do_not_take():
    """The dispatch keeps the plain legs for CPU tensors at any block
    size; the kernels take 256 only (and CUDA tensors only)."""
    from repro_torch.kernels.quantize import quantize as tq
    x = torch.zeros((1, 2, 2 * 128))
    wire, lens = tops.exchange_send(x, None, 4, block_size=128,
                                    impl="kernel")
    assert wire.shape == (4, 132) and lens == [2, 2]
    for fn, args in ((tq.exchange_send_cuda, (torch.zeros((1, 2, 256)),
                                              None, 2)),
                     (tq.exchange_receive_cuda,
                      (torch.zeros((2, 1, 260), dtype=torch.int8), None, 0)),
                     (tq.exchange_decode_cuda,
                      (torch.zeros((2, 260), dtype=torch.int8), [1, 1],
                       torch.zeros((1, 2, 256))))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
