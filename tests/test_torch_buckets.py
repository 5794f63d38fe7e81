"""repro_torch's bucket engine against the JAX package (CPU, gloo).

  (a) ``build_layout`` equals JAX's (offsets, sizes, shapes, total,
      ``bucket_elems``, ``num_buckets``) on the olmo-1b and tinyllama
      smoke parameter trees at several ``bucket_mb`` and ``multiple_of``:
      the port walks its per-layer list as JAX's stacked (L, ...) leaves,
      in JAX's sorted-key flatten order;
  (b) ``pack_buckets`` / ``unpack_buckets`` are bit-equal to JAX's;
  (c) ``exchange_buckets`` on 2 and 4 gloo ranks (spawned processes)
      against JAX's ``exchange_buckets`` under ``shard_map`` over a
      ``pod`` axis of forced host devices (one child process for the
      file), fed the same per-rank stacks and error states: fp32, int8
      without and with error feedback, and a layout whose stream ends in
      an all-padding block, and stacks exchanged in several chunks of
      whole buckets (against JAX's single pass). The int8 payload each
      rank puts on the wire in the first leg of each chunk is byte-equal
      to the JAX payload (codes and bit-cast scales) of its data rows,
      and the padding rows are never sent; the reduced stack is within 1e-6 relative L2 (the JAX
      oracle's dequant-accumulate is an einsum, the port's a rank loop);
      the new error state differs by at most 1e-6 of the norms of the
      values it is the residual of (the corrected gradient and the
      reduced sum, the second carrying the summation-order difference):
      XLA computes ``corrected - q * s`` as one fused multiply-add, the
      port rounds the product first (checked bit for bit in
      ``test_jax_residual_is_a_fused_multiply_add``); the bytes each rank
      sends add up to ``ranks`` times ``modeled_link_bytes``.
"""
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import buckets as jbkt
from repro.core import compression as jcomp
from repro.kernels.quantize import ref as jref
from repro.models.model import build_model as jbuild
from repro_torch.configs import base as tcfgs
from repro_torch.core import buckets as tbkt
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.convert import params_from_jax, params_to_numpy

REPO = Path(__file__).resolve().parent.parent
ARCHS = ["olmo-1b", "tinyllama-1.1b"]
EXCHANGE_RTOL = 1e-6


def _trees(arch):
    jc = jcfgs.smoke_config(arch)
    tc = tcfgs.smoke_config(arch)
    jparams = jax.tree.map(np.asarray, jbuild(jc).init_params(
        jax.random.PRNGKey(0)))
    return jparams, params_from_jax(jparams, tc, "cpu"), tc


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_pack_unpack_match_jax(arch):
    jparams, tparams, tc = _trees(arch)
    jtree = jax.tree.map(jnp.asarray, jparams)
    for bucket_mb, mult in ((0.05, 512), (0.01, 1024), (1.0, 256),
                            (0.003, 2048)):
        jl = jbkt.build_layout(jtree, bucket_mb=bucket_mb, multiple_of=mult)
        tl = tbkt.build_layout(tparams, bucket_mb=bucket_mb,
                               multiple_of=mult)
        assert (tl.offsets, tl.sizes, tl.shapes, tl.total, tl.bucket_elems,
                tl.num_buckets) == (jl.offsets, jl.sizes, jl.shapes,
                                    jl.total, jl.bucket_elems,
                                    jl.num_buckets), (bucket_mb, mult)
        assert tl.padded_total == jl.padded_total
        assert tl.error_shape(2) == jl.error_shape(2)
        jpack = np.asarray(jbkt.pack_buckets(jtree, jl))
        tpack = tbkt.pack_buckets(tparams, tl)
        np.testing.assert_array_equal(tpack.numpy(), jpack)
        back = params_to_numpy(tbkt.unpack_buckets(tpack * 3, tl, tparams))
        want = jax.tree.map(np.asarray,
                            jbkt.unpack_buckets(jnp.asarray(jpack) * 3, jl))
        got_f, want_f = _flat(back), _flat(want)
        assert set(got_f) == set(want_f)
        for k in want_f:
            np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
    assert tc.num_layers >= 2


def test_unpack_views_and_modeled_bytes():
    _, tparams, _ = _trees("olmo-1b")
    lo = tbkt.build_layout(tparams, bucket_mb=0.05, multiple_of=512)
    stack = tbkt.pack_buckets(tparams, lo)
    tree = tbkt.unpack_buckets(stack, lo, tparams)
    tree["embed"].add_(1.0)                      # a view into the stack
    assert float(stack.reshape(-1)[0]) == float(tparams["embed"].reshape(
        -1)[0] + 1.0)
    jl = jbkt.build_layout(jax.tree.map(
        lambda t: jnp.zeros(t.shape), params_to_numpy(tparams)),
        bucket_mb=0.05, multiple_of=512)
    for p in (2, 3, 4):
        for compress in (False, True):
            assert tbkt.modeled_link_bytes(lo, p, compress=compress) == \
                jbkt.modeled_link_bytes(jl, p, compress=compress)
            assert tbkt.modeled_per_leaf_bytes(
                lo.shapes, p, compress=compress) == \
                jbkt.modeled_per_leaf_bytes(jax.tree.map(
                    lambda t: jnp.zeros(t.shape),
                    params_to_numpy(tparams)), p, compress=compress)


# --------------------------------------------------------------------------
# (c) the exchange on spawned gloo ranks vs JAX under shard_map
# --------------------------------------------------------------------------

# (name, ranks, compress, with_err, leaf sizes, bucket_mb, buckets per
# exchange chunk: None for the default, which covers these stacks whole)
CASES = [
    ("fp32", 2, False, False, (700, 1300, 90), 0.002, None),
    ("int8", 2, True, False, (700, 1300, 90), 0.002, None),
    ("int8_ef", 2, True, True, (700, 1300, 90), 0.002, None),
    ("int8_ef_tail", 2, True, True, (600,), 0.0005, None),
    ("fp32_chunked", 2, False, False, (700, 1300, 90), 0.001, 2),
    ("int8_ef_chunked", 2, True, True, (700, 1300, 90), 0.001, 2),
    ("fp32_4", 4, False, False, (3000, 777), 0.004, None),
    ("int8_ef_4", 4, True, True, (3000, 777), 0.004, None),
    ("int8_ef_tail_4", 4, True, True, (1500,), 0.0005, None),
    ("int8_ef_tail_short_4", 4, True, True, (600,), 0.0005, None),
    ("int8_ef_chunked_4", 4, True, True, (3000, 1777), 0.002, 2),
]

JAX_CHILD = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import buckets as bkt

data = dict(np.load(IN))
out = {}
for name in data["names"]:
    x = jnp.asarray(data[name + "/x"])               # (p, nb, be)
    p = x.shape[0]
    compress = bool(data[name + "/compress"])
    total = int(data[name + "/total"])
    with_err = name + "/err" in data
    mesh = Mesh(np.array(jax.devices()[:p]), ("pod",))

    def f(xl, el):
        red, ne = bkt.exchange_buckets(
            xl[0], el[0] if with_err else None, axis="pod", axis_size=p,
            compress=compress, total=total if compress else None)
        return red[None], (ne[None] if ne is not None
                           else jnp.zeros((1,), jnp.float32))

    err = jnp.asarray(data[name + "/err"]) if with_err else \\
        jnp.zeros((p,), jnp.float32)
    with compat.set_mesh(mesh):
        red, ne = jax.jit(compat.shard_map(
            f, mesh=mesh, in_specs=(P("pod"), P("pod")),
            out_specs=(P("pod"), P("pod")), axis_names={"pod"},
            check_vma=False))(x, err)
    out[name + "/red"] = np.asarray(red)
    if with_err:
        out[name + "/err"] = np.asarray(ne)
np.savez(OUT, **out)
"""


def run_jax_child(code: str, inputs: dict, tmp: Path, devices: int) -> dict:
    """Run ``code`` in a child process with ``devices`` forced host
    devices; ``IN``/``OUT`` name its input and output npz files."""
    src, dst = tmp / "jax_in.npz", tmp / "jax_out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    prog = f"IN = {str(src)!r}\nOUT = {str(dst)!r}\n" + textwrap.dedent(code)
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _case_inputs(name, p, compress, with_err, sizes, bucket_mb, chunk):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    tree = {f"l{i}": torch.zeros(n) for i, n in enumerate(sizes)}
    lo = tbkt.build_layout(tree, bucket_mb=bucket_mb, multiple_of=p * 256)
    x = np.zeros((p, lo.num_buckets, lo.bucket_elems), np.float32)
    flat = x.reshape(p, -1)
    flat[:, :lo.total] = rng.standard_normal((p, lo.total)) * \
        rng.uniform(0.1, 3.0, (p, 1))
    err = None
    if with_err:
        err = np.zeros_like(x)
        err.reshape(p, -1)[:, :lo.total] = \
            rng.standard_normal((p, lo.total)) * 0.01
    return lo, x, err


@pytest.fixture(scope="module")
def jax_exchanges(tmp_path_factory):
    inputs = {"names": np.array([c[0] for c in CASES])}
    layouts = {}
    for name, p, compress, with_err, sizes, mb, chunk in CASES:
        lo, x, err = _case_inputs(name, p, compress, with_err, sizes, mb,
                                  chunk)
        layouts[name] = (lo, x, err)
        inputs[name + "/x"] = x
        inputs[name + "/compress"] = np.array(compress)
        inputs[name + "/total"] = np.array(lo.total)
        if err is not None:
            inputs[name + "/err"] = err
    out = run_jax_child(JAX_CHILD, inputs, tmp_path_factory.mktemp("jx"), 4)
    return layouts, out


def exchange_rank(rank, world, init_method, cases):
    """One gloo rank: the port's exchange of its stack for every case of
    ``world`` ranks; per case the reduced stack, the new error state, the
    first leg's wire buffer and the bytes it sent."""
    mesh_mod.share_cpu(world)
    mesh = mesh_mod.init((world, 1, 1), ("pod", "data", "model"), rank,
                         init_method, "cpu")
    out = {}
    try:
        comm = mesh.pod
        wires = []
        orig = comm.all_to_all

        def recording(buf, send, recv):
            wires.append(buf.clone().numpy())
            return orig(buf, send, recv)

        comm.all_to_all = recording
        default = tbkt.EXCHANGE_CHUNK_BYTES
        for name, x, err, compress, total, chunk in cases:
            wires.clear()
            sent0 = comm.sent_bytes
            tbkt.EXCHANGE_CHUNK_BYTES = (default if chunk is None else
                                         chunk * x.shape[2] * 4)
            stack = torch.from_numpy(x[rank].copy())
            e = (torch.from_numpy(err[rank].copy()) if err is not None
                 else None)
            red, ne = tbkt.exchange_buckets(
                stack, e, comm=comm, compress=compress,
                total=total if compress else None, impl="kernel")
            out[name] = {"red": red.numpy(), "err": None if ne is None
                         else ne.numpy(), "wires": list(wires),
                         "sent": comm.sent_bytes - sent0}
        tbkt.EXCHANGE_CHUNK_BYTES = default
    finally:
        mesh_mod.destroy(mesh)
    return out


@pytest.fixture(scope="module")
def port_exchanges(jax_exchanges):
    """Every case through the port: one spawn of 2 ranks, one of 4."""
    layouts, _ = jax_exchanges
    outs = {}
    for p in sorted({c[1] for c in CASES}):
        cases = [(name, layouts[name][1], layouts[name][2], compress,
                  layouts[name][0].total, chunk)
                 for name, pc, compress, *_, chunk in CASES if pc == p]
        per_rank = mesh_mod.spawn(exchange_rank, p, (cases,),
                                  timeout_s=300)
        for name, *_ in cases:
            outs[name] = [r[name] for r in per_rank]
    return outs


def test_jax_residual_is_a_fused_multiply_add():
    """Why the error states differ in the last bits: jitted JAX rounds
    ``corrected - q * s`` once (a fused multiply-add), the port twice."""
    c = np.random.default_rng(0).standard_normal((64, 256)).astype(
        np.float32)
    q, s = jref.quantize_int8(jnp.asarray(c))
    got = np.asarray(jax.jit(lambda c, q, s: c - q.astype(jnp.float32)
                             * s[:, None])(jnp.asarray(c), q, s))
    qs = np.asarray(q).astype(np.float64) * np.asarray(s)[:, None]
    np.testing.assert_array_equal(got, (c - qs).astype(np.float32))
    from repro_torch.kernels.quantize import ref as tref
    tq, ts = tref.quantize_int8(torch.from_numpy(c))
    port = (torch.from_numpy(c) - tq.float() * ts[:, None]).numpy()
    assert not np.array_equal(port, got)
    np.testing.assert_allclose(port, got, rtol=0, atol=1e-6)


def _rel_l2(got, want):
    return float(np.linalg.norm((got - want).astype(np.float64))
                 / np.linalg.norm(want.astype(np.float64)))


def _expected_wires(x_r, err_r, total, p, chunk):
    """JAX's first-leg payload of one rank for each exchange chunk: the
    data rows only, in message order (rank j's rows of every bucket of
    the chunk)."""
    nb, be = x_r.shape
    ns = be // p // 256
    corrected = x_r + (err_r if err_r is not None else 0.0)
    d_rows = -(-total // 256)
    q, s = jref.quantize_int8(jnp.asarray(corrected.reshape(-1, 256)
                                          [:d_rows]), block_size=256)
    payload = np.zeros((nb * p * ns, 260), np.int8)
    payload[:d_rows] = np.asarray(jcomp.fuse_payload(q, s))
    payload = payload.reshape(nb, p, ns, 260)
    rows = np.arange(nb * p * ns).reshape(nb, p, ns)
    out = []
    for k0 in range(0, nb, chunk):
        pc = payload[k0:k0 + chunk].transpose(1, 0, 2, 3).reshape(p, -1, 260)
        rc = rows[k0:k0 + chunk].transpose(1, 0, 2).reshape(p, -1)
        out.append(np.concatenate([pc[j][rc[j] < d_rows]
                                   for j in range(p)]))
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_exchange_matches_jax(case, jax_exchanges, port_exchanges):
    layouts, jout = jax_exchanges
    _, p, compress, with_err, _, _, chunk = next(c for c in CASES
                                                 if c[0] == case)
    lo, x, err = layouts[case]
    if case.startswith("int8_ef_tail"):
        assert lo.padded_total - lo.total >= 256      # an all-padding block
    if chunk is not None:
        assert lo.num_buckets > chunk and lo.num_buckets % chunk  # ragged
    outs = port_exchanges[case]
    jred = jout[case + "/red"].reshape(p, *x.shape[1:])
    for r, o in enumerate(outs):
        assert _rel_l2(o["red"], jred[r]) <= EXCHANGE_RTOL, (case, r)
        np.testing.assert_array_equal(o["red"], outs[0]["red"])
        if with_err:
            jerr = jout[case + "/err"].reshape(p, *x.shape[1:])
            diff = np.linalg.norm((o["err"] - jerr[r]).astype(np.float64))
            scale = np.linalg.norm((x[r] + err[r]).astype(np.float64)) \
                + np.linalg.norm(jred[r].astype(np.float64))
            assert diff <= EXCHANGE_RTOL * scale, (case, r, diff / scale)
            assert _rel_l2(o["err"], jerr[r]) <= 1e-4, (case, r)
            tail = o["err"].reshape(-1)[-(-lo.total // 256) * 256:]
            assert not tail.any()                  # pinned to zero
        n_chunks = -(-lo.num_buckets // (chunk or lo.num_buckets))
        # all_to_all calls: both legs a chunk int8, the first fp32
        assert len(o["wires"]) == (2 if compress else 1) * n_chunks
        if compress:
            want_wires = _expected_wires(x[r], None if err is None
                                         else err[r], lo.total, p,
                                         chunk or lo.num_buckets)
            assert len(want_wires) == n_chunks
            for got_w, want_w in zip(o["wires"][::2], want_wires):
                np.testing.assert_array_equal(got_w, want_w)
    want = x.sum(axis=0)
    tol = 2e-2 if compress else 1e-6
    assert _rel_l2(outs[0]["red"], want) <= tol
    sent = sum(o["sent"] for o in outs)
    assert abs(sent - p * tbkt.modeled_link_bytes(
        lo, p, compress=compress)) <= p
