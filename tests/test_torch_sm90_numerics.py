"""The arithmetic of the bf16 tensor-core kernels, modelled in plain
PyTorch on the CPU, against the JAX package.

``flash_attention_tiled_plain`` follows ``csrc/flash_attention.cu``'s
bf16 path: fp32 scores of bf16 q and k, scaled after the product, an
online softmax over kv tiles of the kernel's size (32 or 64), and p fed to
the P·V product as the bf16 pair hi = bf16(p), lo = bf16(p - hi).
``cross_entropy_split_plain`` follows ``csrc/cross_entropy.cu``'s bf16
path: per-split partials over the kernel's vocab slabs, merged in split
order. Both are held against the Pallas kernels (interpret mode) and
the port's plain versions on bf16 inputs from a numpy seed.
``flash_attention_bwd_tiled_plain`` follows ``csrc/flash_attention_bwd.cu``'s
bf16 path (fp32 products of bf16 tiles, p and ds rounded to bf16 once,
sums in the kernel's tile order, the GQA group summed in order) and is
held against ``jax.vjp`` of the JAX package's ``ref.mha_chunked`` (its
``_flash_bwd``) and the port's ``flash_bwd_ref``.
``flash_decode_paged_split_plain`` follows ``csrc/paged_decode.cu``
(splits of ``DECODE_SPLIT`` positions, merged in order) and is held
against ``flash_decode_paged_pallas`` in interpret mode and
``paged_decode_ref``, and against itself for batch invariance.
``mla_decode_paged_split_plain`` follows ``csrc/mla_decode.cu``'s bf16
path (splits of ``SPLIT`` positions in tiles of ``TILE``, p rounded to
the cache dtype once a tile, merged in order) and is held against
``mla_decode_paged_pallas`` in interpret mode and
``mla_decode_paged_online_plain``, and against itself for batch
invariance; ``mla_decode_split_plain``, the same arithmetic over the
contiguous cache, against ``mla_decode_pallas`` in interpret mode and
the dense oracle ``ref.mla_decode_dense``, and for batch invariance.
``ssd_scan_tiled_plain`` follows ``csrc/ssd_scan.cu``'s bf16 path
(chunk states, the state passing, the chunk scan in 64-row tiles, the
weighted B, the carried state and the decay-weighted scores fed as
bf16 hi/lo pairs) and is held against ``ssd_scan_pallas`` in interpret
mode and JAX's ``ref.ssd_chunked``. ``mlstm_scan_tiled_plain`` follows
``csrc/mlstm_scan.cu``'s bf16 path (chunk states under the chunk's own
stabiliser, the state passing, the chunk scan in 64-row tiles; the
weighted keys, the carried state and the decay-weighted scores fed as
bf16 hi/lo pairs) and is held against ``mlstm_scan_pallas`` in
interpret mode and JAX's ``ref.mlstm_chunked``.
``ssd_scan_bwd_tiled_plain`` follows ``csrc/ssd_scan_bwd.cu``'s bf16 path
(the chunk states with the weighted B and C as pairs, the carried state
and G as pairs, one pass over the causal pairs of 64-row tiles with M^T
and (dM F)^T as pairs, v summed in fp64) and is held against ``jax.vjp``
of JAX's ``ref.ssd_chunked`` and against ``ssd_scan_bwd_plain``.
``mlstm_scan_bwd_tiled_plain`` follows ``csrc/mlstm_scan_bwd.cu``'s bf16
path (the chunk states with kw k as a pair, the carried state as a pair,
each causal pair of 64-row tiles once with dS and W/lim as pairs, the
weighted q and G as pairs) and is held against ``jax.vjp`` of JAX's
``ref.mlstm_chunked`` and against ``mlstm_scan_bwd_plain``.

Tolerances are the card's limits for the kernels
(``repro_torch.kernels.parity.RTOL``, relative L2): 5e-4 for the bf16
attention output and lse, 2e-6 for the bf16 cross entropy's loss sum,
weight sum and lse. Both sides round the attention output to bf16, so
most of what is left is a 1-ulp rounding of some outputs. The reading of
a single bf16 rounding of p (about 2e-3, above the limit: why the kernel
takes the pair) is printed, not asserted. The backward model is held to
the bf16 backward's limit, 1e-3; the decode model to the card tests'
limits for the decode kernel, 1e-4 absolute in fp32 (outputs are O(1),
only the order of sums differs) and 2e-2 in bf16 (the two round to bf16
at different points), and to equal bits for batch invariance; the MLA
model likewise (1e-4 fp32, 2e-2 bf16, equal bits); the SSD model to the
bf16 scan's limit, ``RTOL[("ssd_scan_cuda", bf16)]`` = 4e-4, on y and on
the final state. The readings of one bf16 rounding of the SSD scan's
made operands and of TF32 (both above the limit: why the kernel takes
pairs) are printed, not asserted. The mLSTM model is held to the bf16
mLSTM scan's limit, ``RTOL[("mlstm_scan_cuda", bf16)]`` = 6e-4, on h, C,
n and m; the readings of one bf16 rounding of each of its made operands
are printed, not asserted. The SSD backward's model is held to the bf16
backward's limit, ``RTOL[("ssd_scan_bwd_cuda", bf16)]`` = 8e-4, on each
of its six gradients; the reading of one bf16 rounding of its made
operands is printed beside it, and the pairs must read closer. The
mLSTM backward's model is held to the bf16 backward's limit,
``RTOL[("mlstm_scan_bwd_cuda", bf16)]`` = 2e-3, on each of its five
gradients, and at large gates to ``RTOL[("mlstm_scan_bwd_large_gates",
bf16)]`` = 0.15, there also against autograd through the port's
reference scan in fp64; the reading of one bf16 rounding of its made
operands is printed, not asserted.
"""
import re

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy import ref as jref
from repro.kernels.cross_entropy.cross_entropy import cross_entropy_pallas
from repro.kernels.flash_attention import ref as fa_jref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas, flash_decode_paged_pallas)
from repro.kernels.mla_decode.mla_decode import (mla_decode_paged_pallas,
                                                 mla_decode_pallas)
from repro.kernels.mlstm_scan import ref as mlstm_jref
from repro.kernels.mlstm_scan.mlstm_scan import mlstm_scan_pallas
from repro.kernels.ssd_scan import ref as ssd_jref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.cross_entropy import cross_entropy as tce
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.mla_decode import mla_decode as tmd
from repro_torch.kernels.mla_decode import ref as tmla_ref
from repro_torch.kernels.mlstm_scan import mlstm_scan as tmk
from repro_torch.kernels.mlstm_scan import ref as tmlstm_ref
from repro_torch.kernels.parity import RTOL, rel_l2
from repro_torch.kernels.ssd_scan import ssd_scan as tsk

ATTN_TOL = RTOL[("flash_attention_cuda", torch.bfloat16)]
BWD_TOL = RTOL[("flash_attention_bwd_cuda", torch.bfloat16)]
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CE_TOL = RTOL[("cross_entropy_cuda", torch.bfloat16)]
SSD_TOL = RTOL[("ssd_scan_cuda", torch.bfloat16)]
MLSTM_TOL = RTOL[("mlstm_scan_cuda", torch.bfloat16)]
SSD_BWD_TOL = RTOL[("ssd_scan_bwd_cuda", torch.bfloat16)]
MLSTM_BWD_TOL = RTOL[("mlstm_scan_bwd_cuda", torch.bfloat16)]
MLSTM_BWD_LARGE_TOL = RTOL[("mlstm_scan_bwd_large_gates", torch.bfloat16)]

# (b, sq, skv, h, hkv, causal, q_offset): ragged Sq = Skv over several q
# and kv tiles (group 2), chunked prefill (q_offset > 0, Skv > Sq, group
# 1), MQA (group 8), non-causal with a ragged Skv
ATTN_CASES = [
    (1, 150, 150, 4, 2, True, 0),
    (2, 20, 100, 2, 2, True, 80),
    (1, 70, 70, 8, 1, True, 0),
    (1, 33, 77, 4, 2, False, 0),
]


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,off", ATTN_CASES)
def test_attention_tile_model_matches_pallas_and_plain(d, b, sq, skv, h,
                                                       hkv, causal, off):
    rng = np.random.default_rng(d + sq + skv)
    q = _bf16(rng, (b, sq, h, d))
    k = _bf16(rng, (b, skv, hkv, d))
    v = _bf16(rng, (b, skv, hkv, d))
    kw = dict(causal=causal, q_offset=off)
    got, got_lse = tfa.flash_attention_tiled_plain(q, k, v, return_lse=True,
                                                   **kw)
    want, want_lse = tfa.flash_attention_plain(q, k, v, return_lse=True,
                                               **kw)
    pallas = torch.from_numpy(np.asarray(flash_attention_pallas(
        _jax(q), _jax(k), _jax(v), block_q=64, block_kv=64, interpret=True,
        **kw).astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    once = tfa.flash_attention_tiled_plain(q, k, v, split_p=False, **kw)
    readings = {"pair vs plain": rel_l2(got, want),
                "pair vs pallas": rel_l2(got, pallas),
                "lse vs plain": rel_l2(got_lse, want_lse),
                "single rounding vs plain": rel_l2(once, want)}
    print(f"[sm90-attention] D={d} {(b, sq, skv, h, hkv, causal, off)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what in ("pair vs plain", "pair vs pallas", "lse vs plain"):
        assert readings[what] <= ATTN_TOL, (what, readings[what])


def _attention_bwd_inputs(rng, b, sq, skv, h, hkv, d):
    q = _bf16(rng, (b, sq, h, d))
    k = _bf16(rng, (b, skv, hkv, d))
    v = _bf16(rng, (b, skv, hkv, d))
    dout = _bf16(rng, (b, sq, h, d))
    return q, k, v, dout


@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("b,sq,skv,h,hkv,causal,off", ATTN_CASES)
def test_attention_bwd_tile_model_matches_jax_vjp_and_plain(d, b, sq, skv,
                                                            h, hkv, causal,
                                                            off):
    import jax
    rng = np.random.default_rng(7 * d + sq + skv)
    q, k, v, dout = _attention_bwd_inputs(rng, b, sq, skv, h, hkv, d)
    kw = dict(causal=causal, q_offset=off)
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    _, vjp = jax.vjp(lambda q_, k_, v_: fa_jref.mha_chunked(
        q_, k_, v_, **kw), jq, jk, jv)
    jgrads = [torch.from_numpy(np.array(g.astype(jnp.float32)))
              for g in vjp(_jax(dout))]
    # the residuals that vjp's backward rebuilds p from: JAX's forward
    # output (p cast to bf16 before P V) and its lse
    _, (*_, jout, jlse) = fa_jref._flash_fwd(
        jq, jk, jv, jnp.full((b,), skv, jnp.int32), causal, off, d ** -0.5,
        512)
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))
    got = tfa.flash_attention_bwd_tiled_plain(q, k, v, out, lse, dout, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    readings = {}
    for name, g, w, j in zip(("dq", "dk", "dv"), got, want, jgrads):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        readings[f"{name} vs plain"] = rel_l2(g, w)
        readings[f"{name} vs jax"] = rel_l2(g, j)
    print(f"[sm90-attention-bwd] D={d} {(b, sq, skv, h, hkv, causal, off)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        assert r <= BWD_TOL, (what, r)


def _decode_inputs(rng, dtype, bs, mb, hkv, group, lens, holes):
    """GQA decode inputs over a pool of B*MB blocks: each sequence maps
    its own blocks up to its length, the rest NULL (== N); ``holes``
    puts a NULL block inside every window of three or more blocks; a
    length of 1 is an all-NULL inactive slot."""
    b = len(lens)
    n = b * mb
    q = torch.from_numpy(rng.standard_normal(
        (b, 1, hkv * group, 64)).astype(np.float32)).to(dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n, bs, hkv, 64)).astype(np.float32)).to(dtype) for _ in range(2))
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    for i, ln in enumerate(lens):
        nb = min(-(-ln // bs), mb)
        if ln > 1:
            tables[i, :nb] = perm[i * mb:i * mb + nb]
        if holes and nb > 2:
            tables[i, nb // 2] = n
    return (q, kp, vp, torch.from_numpy(tables),
            torch.tensor(lens, dtype=torch.int32))


# (bs, mb, hkv, group, lens): three splits with one length exactly
# MB*bs and an inactive slot; a block size that divides neither the
# split nor the stage; a group of 16 over five splits; lengths past the
# window
DECODE_CASES = [
    (16, 12, 2, 4, [192, 1, 37, 150]),
    (12, 5, 2, 4, [60, 1, 13, 59]),
    (8, 40, 1, 16, [320, 1, 129, 300]),
    (16, 9, 2, 8, [200, 144, 1]),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,mb,hkv,group,lens", DECODE_CASES)
def test_decode_split_model_matches_pallas_and_plain(pallas_interpret, dtype,
                                                     bs, mb, hkv, group,
                                                     lens):
    rng = np.random.default_rng(bs * mb + group)
    q, kp, vp, tables, kv_lens = _decode_inputs(rng, dtype, bs, mb, hkv,
                                                group, lens, holes=True)
    got = tfa.flash_decode_paged_split_plain(q, kp, vp, tables, kv_lens)
    want = tfa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = torch.from_numpy(np.array(flash_decode_paged_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, kp, vp)),
        jnp.asarray(tables.numpy()), jnp.asarray(kv_lens.numpy()),
        interpret=pallas_interpret).astype(jnp.float32)))
    assert got.dtype == dtype and got.shape == q.shape
    errs = {"vs plain": (got.float() - want.float()).abs().max().item(),
            "vs pallas": (got.float() - pallas).abs().max().item()}
    print(f"[decode-split] {dtype} {(bs, mb, hkv, group, lens)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    for what, e in errs.items():
        assert e <= DECODE_TOL[dtype], (what, e)
    inactive = [i for i, ln in enumerate(lens) if ln == 1]
    assert not got[inactive].any()


def test_decode_split_model_treats_out_of_pool_entries_as_zeros():
    rng = np.random.default_rng(11)
    q, kp, vp, tables, kv_lens = _decode_inputs(
        rng, torch.float32, 16, 8, 2, 4, [128, 100, 1], holes=False)
    tables[0, 2] = -1                       # below the pool
    tables[1, 3] = kp.shape[0] + 5          # past the NULL sentinel
    got = tfa.flash_decode_paged_split_plain(q, kp, vp, tables, kv_lens)
    want = tfa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    assert (got - want).abs().max().item() <= DECODE_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_model_is_batch_invariant(dtype):
    """One sequence alone and the same sequence inside a batch of 8 with
    a wider table (more splits of the window) give equal bits."""
    rng = np.random.default_rng(3)
    bs, hkv, group = 16, 4, 8
    q, kp, vp, tables, kv_lens = _decode_inputs(
        rng, dtype, bs, 64, hkv, group,
        [1000, 1, 37, 300, 16, 512, 455, 129], holes=True)
    seq = 3
    alone = tfa.flash_decode_paged_split_plain(
        q[seq:seq + 1], kp, vp, tables[seq:seq + 1, :24],
        kv_lens[seq:seq + 1])
    batched = tfa.flash_decode_paged_split_plain(q, kp, vp, tables, kv_lens)
    assert tfa.decode_splits(24, bs) < tfa.decode_splits(64, bs)
    assert torch.equal(alone[0], batched[seq])


def test_decode_splits_come_from_the_window_shape():
    split = tfa.DECODE_SPLIT
    assert tfa.decode_splits(32, 16) == -(-512 // split)   # the serve phase
    assert tfa.decode_splits(128, 16) == -(-2048 // split)
    assert tfa.decode_splits(1, 1) == 1
    for mb, bs in ((5, 12), (9, 16), (40, 8)):
        n = tfa.decode_splits(mb, bs)
        assert (n - 1) * split < mb * bs <= n * split
    assert tfa.DECODE_SPLIT % tfa.DECODE_TILE == 0


def _mla_inputs(rng, dtype, h, bs, mb, lens, holes):
    """deepseek-v2 latent widths (r=512, Dr=64) over a pool of B*MB
    blocks: each sequence maps its own blocks up to its length, the rest
    NULL (== N); ``holes`` puts a NULL block inside every window of three
    or more blocks; a length of 1 is an all-NULL inactive slot."""
    b = len(lens)
    n = b * mb
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    qa, qr = f(b, h, tmd.RANK), f(b, h, tmd.ROPE_DIM)
    cp, kp = f(n, bs, tmd.RANK), f(n, bs, tmd.ROPE_DIM)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    for i, ln in enumerate(lens):
        nb = min(-(-ln // bs), mb)
        if ln > 1:
            tables[i, :nb] = perm[i * mb:i * mb + nb]
        if holes and nb > 2:
            tables[i, nb // 2] = n
    return (qa, qr, cp, kp, torch.from_numpy(tables),
            torch.tensor(lens, dtype=torch.int32))


# (h, bs, mb, lens): the serve shape's heads over three splits with one
# length exactly MB*bs and an inactive slot; heads not a multiple of 64
# and a block size that divides neither the split nor the tile; heads
# over 64 and not a multiple of it, lengths past the window
MLA_CASES = [
    (128, 16, 20, [320, 1, 37, 150]),
    (20, 12, 9, [108, 1, 13, 70]),
    (72, 16, 5, [80, 1, 100, 33]),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,bs,mb,lens", MLA_CASES)
def test_mla_split_model_matches_pallas_and_plain(pallas_interpret, dtype, h,
                                                  bs, mb, lens):
    rng = np.random.default_rng(h + bs * mb)
    args = _mla_inputs(rng, dtype, h, bs, mb, lens, holes=True)
    scale = 192 ** -0.5
    got = tmd.mla_decode_paged_split_plain(*args, scale)
    want = tmla_ref.mla_decode_paged_online_plain(*args, scale)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = torch.from_numpy(np.array(mla_decode_paged_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in args[:4]),
        jnp.asarray(args[4].numpy()), jnp.asarray(args[5].numpy()), scale,
        interpret=pallas_interpret)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    errs = {"vs plain": (got - want).abs().max().item(),
            "vs pallas": (got - pallas).abs().max().item()}
    print(f"[mla-split] {dtype} {(h, bs, mb, lens)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    for what, e in errs.items():
        assert e <= DECODE_TOL[dtype], (what, e)
    inactive = [i for i, ln in enumerate(lens) if ln == 1]
    assert not got[inactive].any()


def test_mla_split_model_treats_out_of_pool_entries_as_zeros():
    rng = np.random.default_rng(12)
    qa, qr, cp, kp, tables, lens = _mla_inputs(
        rng, torch.float32, 16, 16, 8, [128, 100, 1], holes=False)
    tables[0, 2] = -1                       # below the pool
    tables[1, 3] = cp.shape[0] + 5          # past the NULL sentinel
    args = (qa, qr, cp, kp, tables, lens, 0.1)
    got = tmd.mla_decode_paged_split_plain(*args)
    want = tmla_ref.mla_decode_paged_online_plain(*args)
    assert (got - want).abs().max().item() <= DECODE_TOL[torch.float32]
    assert not got[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_split_model_is_batch_invariant(dtype):
    """One sequence alone and the same sequence inside a batch of 6 with
    a wider table (more splits of the window) give equal bits."""
    rng = np.random.default_rng(4)
    qa, qr, cp, kp, tables, lens = _mla_inputs(
        rng, dtype, 20, 16, 40, [600, 1, 37, 300, 16, 455], holes=True)
    seq = 3
    alone = tmd.mla_decode_paged_split_plain(
        qa[seq:seq + 1], qr[seq:seq + 1], cp, kp, tables[seq:seq + 1, :20],
        lens[seq:seq + 1], 0.1)
    batched = tmd.mla_decode_paged_split_plain(qa, qr, cp, kp, tables, lens,
                                               0.1)
    assert tmd.mla_splits(20, 16) < tmd.mla_splits(40, 16)
    assert torch.equal(alone[0], batched[seq])


def _mla_contiguous(rng, dtype, h, s, lens):
    """deepseek-v2 latent widths over a contiguous cache (B, S, .)."""
    b = len(lens)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return (f(b, h, tmd.RANK), f(b, h, tmd.ROPE_DIM), f(b, s, tmd.RANK),
            f(b, s, tmd.ROPE_DIM), torch.tensor(lens, dtype=torch.int32))


# (h, s, lens): the generate path's heads with S not a multiple of the
# split, a length of exactly S and one of 1; heads under 64; heads over
# 64 and not a multiple of it, S a multiple of the split
MLA_CONTIGUOUS_CASES = [
    (128, 300, [300, 1, 129, 77]),
    (20, 200, [1, 200, 64, 128]),
    (72, 256, [256, 5, 130]),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,s,lens", MLA_CONTIGUOUS_CASES)
def test_mla_contiguous_split_model_matches_pallas_and_dense(
        pallas_interpret, dtype, h, s, lens):
    rng = np.random.default_rng(h + s)
    args = _mla_contiguous(rng, dtype, h, s, lens)
    scale = 192 ** -0.5
    got = tmd.mla_decode_split_plain(*args, scale)
    want = tmla_ref.mla_decode_dense(*args, scale)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = torch.from_numpy(np.array(mla_decode_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in args[:4]),
        jnp.asarray(args[4].numpy()), scale, chunk=128,
        interpret=pallas_interpret)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    errs = {"vs dense": (got - want).abs().max().item(),
            "vs pallas": (got - pallas).abs().max().item()}
    print(f"[mla-split contiguous] {dtype} {(h, s, lens)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    for what, e in errs.items():
        assert e <= DECODE_TOL[dtype], (what, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_contiguous_split_model_is_batch_invariant(dtype):
    """One sequence alone over a shorter cache (fewer splits of the
    window) and the same sequence inside a batch of 8 give equal bits;
    the contiguous model equals the paged one on the same rows."""
    rng = np.random.default_rng(9)
    lens = [700, 1, 37, 300, 16, 455, 129, 640]
    qa, qr, ckv, kr, kv_len = _mla_contiguous(rng, dtype, 20, 700, lens)
    seq = 3
    alone = tmd.mla_decode_split_plain(
        qa[seq:seq + 1], qr[seq:seq + 1], ckv[seq:seq + 1, :320],
        kr[seq:seq + 1, :320], kv_len[seq:seq + 1], 0.1)
    batched = tmd.mla_decode_split_plain(qa, qr, ckv, kr, kv_len, 0.1)
    assert tmd.mla_splits(1, 320) < tmd.mla_splits(1, 700)
    assert torch.equal(alone[0], batched[seq])
    # the contiguous cache as a pool of B blocks of S rows
    tables = torch.arange(len(lens), dtype=torch.int32)[:, None]
    paged = tmd.mla_decode_paged_split_plain(qa, qr, ckv, kr, tables,
                                             kv_len, 0.1)
    assert torch.equal(paged, batched)


def test_mla_splits_come_from_the_window_shape():
    split = tmd.SPLIT
    assert tmd.mla_splits(32, 16) == -(-512 // split)     # the serve phase
    assert tmd.mla_splits(128, 16) == -(-2048 // split)
    assert tmd.mla_splits(1, 1) == 1
    for mb, bs in ((5, 12), (9, 16), (40, 8)):
        n = tmd.mla_splits(mb, bs)
        assert (n - 1) * split < mb * bs <= n * split
    assert tmd.SPLIT % tmd.TILE == 0 and tmd.TILE % 16 == 0


def _ssd_inputs(rng, b, s, h, g, use_d):
    """bf16 x, B and C (the kernel's path dtype), fp32 dt, A and D."""
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    x = f(b, s, h, 64).bfloat16()
    dt = torch.nn.functional.softplus(f(b, s, h) - 2.0)
    a = -torch.exp(f(h) * 0.5)
    bm, cm = (f(b, s, g, 64) * 0.3).bfloat16(), (f(b, s, g, 64) * 0.3
                                                 ).bfloat16()
    return x, dt, a, bm, cm, (f(h) if use_d else None)


# (b, s, h, g, chunk, with D): a ragged tail over four chunks; S shorter
# than the chunk and not a multiple of the 64-row tile; chunk 128 with
# two groups and a ragged tail; three groups, no D
SSD_CASES = [
    (1, 1000, 4, 1, 256, True),
    (2, 100, 4, 1, 256, True),
    (1, 300, 4, 2, 128, True),
    (1, 200, 6, 3, 128, False),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("b,s,h,g,chunk,use_d", SSD_CASES)
def test_ssd_tile_model_matches_pallas_and_jax_ref(pallas_interpret, b, s, h,
                                                   g, chunk, use_d):
    rng = np.random.default_rng(s + h + g)
    args = _ssd_inputs(rng, b, s, h, g, use_d)
    y, fin = tsk.ssd_scan_tiled_plain(*args, chunk_size=chunk)
    assert y.dtype == torch.bfloat16 and y.shape == args[0].shape
    assert fin.dtype == torch.float32 and fin.shape == (b, h, 64, 64)

    def jax_of(t):
        if t is None:
            return None
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    jargs = [jax_of(t) for t in args]
    readings = {}
    for name, (jy, jf) in (
            ("pallas", ssd_scan_pallas(*jargs[:5], jargs[5],
                                       chunk_size=chunk,
                                       interpret=pallas_interpret)),
            ("jax ref", ssd_jref.ssd_chunked(*jargs[:5], jargs[5],
                                             chunk_size=chunk))):
        jy = torch.from_numpy(np.asarray(jy.astype(jnp.float32)))
        jf = torch.from_numpy(np.asarray(jf))
        readings[f"y vs {name}"] = rel_l2(y, jy)
        readings[f"state vs {name}"] = rel_l2(fin, jf)
        if name == "jax ref":
            for rnd in ("bf16", "tf32"):
                oy, of = tsk.ssd_scan_tiled_plain(*args, chunk_size=chunk,
                                                  rounding=rnd)
                readings[f"{rnd} y"] = rel_l2(oy, jy)
                readings[f"{rnd} state"] = rel_l2(of, jf)
    print(f"[sm90-ssd] {(b, s, h, g, chunk, use_d)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        if what.split()[0] in ("y", "state"):
            assert r <= SSD_TOL, (what, r)



# (b, s, h, p, g, chunk, with D): P = 32 over chunks of 128 with a ragged
# tail; S shorter than the chunk and not a multiple of the 64-row tile,
# two groups, no D; P = 128 with a 4-row last chunk
SSD_BWD_MODEL_CASES = [
    (1, 320, 2, 32, 1, 128, True),
    (2, 200, 4, 64, 2, 256, False),
    (1, 260, 2, 128, 1, 128, True),
]
SSD_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.mark.parametrize("b,s,h,p,g,chunk,use_d", SSD_BWD_MODEL_CASES)
def test_ssd_bwd_tile_model_matches_jax_vjp_and_plain(b, s, h, p, g, chunk,
                                                      use_d):
    import jax
    rng = np.random.default_rng(s + h + p)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    bf = lambda t: t.bfloat16().float()      # bf16-representable, fp32
    x, dy = bf(f(b, s, h, p)), bf(f(b, s, h, p))
    dt = torch.nn.functional.softplus(f(b, s, h) - 2.0)
    a = -torch.exp(f(h) * 0.5)
    bm, cm = bf(f(b, s, g, 64) * 0.3), bf(f(b, s, g, 64) * 0.3)
    d = f(h) if use_d else None
    args = (x, dt, a, bm, cm, d, dy)

    def y_of(*ins):
        return ssd_jref.ssd_chunked(*ins[:5], ins[5] if use_d else None,
                                    chunk_size=chunk)[0]

    jins = [jnp.asarray(t.numpy()) for t in args[:5]] + (
        [jnp.asarray(d.numpy())] if use_d else [])
    jgrads = jax.vjp(y_of, *jins)[1](jnp.asarray(dy.numpy()))
    oracles = {
        "jax vjp": [torch.from_numpy(np.asarray(v)) for v in jgrads]
        + ([] if use_d else [None]),
        "plain": tsk.ssd_scan_bwd_plain(*args, chunk_size=chunk),
    }
    worst = {}
    readings = {}
    for rnd in ("pair", "bf16"):
        got = tsk.ssd_scan_bwd_tiled_plain(*args, chunk_size=chunk,
                                           rounding=rnd)
        assert got[0].shape == x.shape and got[3].shape == bm.shape
        for oname, want in oracles.items():
            errs = {n: rel_l2(gv, wv) for n, gv, wv in
                    zip(SSD_BWD_GRADS, got, want) if wv is not None}
            readings.update({f"{rnd} {n} vs {oname}": e
                             for n, e in errs.items()})
            worst[(rnd, oname)] = max(errs.values())
    print(f"[sm90-ssd-bwd] {(b, s, h, p, g, chunk, use_d)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        if what.startswith("pair"):
            assert r <= SSD_BWD_TOL, (what, r)
    for oname in oracles:
        assert worst[("pair", oname)] < worst[("bf16", oname)], oname

def _mlstm_inputs(rng, b, s, h, dk, dv):
    """bf16 q, k and v (the kernel's path dtype), fp32 gates as
    xlstm-125m's init sets them up (f~ shifted by its bias)."""
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    return (f(b, s, h, dk).bfloat16(), f(b, s, h, dk).bfloat16(),
            f(b, s, h, dv).bfloat16(), f(b, s, h), f(b, s, h) + 3.0)


# (b, s, h, dk, dv, chunk): a full chunk and a ragged tail (S = 300);
# S shorter than the chunk and not a multiple of the 64-row tile; chunk
# 128 over three chunks with a ragged tail; dk != dv, a dv slice part
# empty; the smoke widths dk = dv = 64 over four chunks
MLSTM_CASES = [
    (1, 300, 2, 128, 128, 256),
    (2, 100, 2, 128, 128, 256),
    (1, 300, 2, 128, 128, 128),
    (1, 150, 2, 192, 64, 128),
    (2, 250, 2, 64, 64, 64),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", MLSTM_CASES)
def test_mlstm_tile_model_matches_pallas_and_jax_ref(pallas_interpret, b, s,
                                                     h, dk, dv, chunk):
    rng = np.random.default_rng(s + h + dk + dv)
    args = _mlstm_inputs(rng, b, s, h, dk, dv)
    hout, state = tmk.mlstm_scan_tiled_plain(*args, chunk_size=chunk)
    assert hout.dtype == torch.bfloat16 and hout.shape == (b, s, h, dv)
    assert [tuple(x.shape) for x in state] == [(b, h, dk, dv), (b, h, dk),
                                               (b, h)]
    assert all(x.dtype == torch.float32 for x in state)

    def jax_of(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    def torch_of(outs):
        jh, jst = outs
        return [torch.from_numpy(np.array(x.astype(jnp.float32)))
                for x in (jh,) + tuple(jst)]

    jargs = [jax_of(t) for t in args]
    names = ("h", "C", "n", "m")
    readings = {}
    for name, want in (
            ("pallas", torch_of(mlstm_scan_pallas(
                *jargs, chunk_size=chunk, interpret=pallas_interpret))),
            ("jax ref", torch_of(mlstm_jref.mlstm_chunked(
                *jargs, chunk_size=chunk)))):
        for what, got, w in zip(names, (hout,) + state, want):
            readings[f"{what} vs {name}"] = rel_l2(got, w)
        if name == "jax ref":
            for op in tmk.MADE_OPERANDS:
                oh, ost = tmk.mlstm_scan_tiled_plain(*args, chunk_size=chunk,
                                                     single=(op,))
                readings[f"bf16 {op} h"] = rel_l2(oh, want[0])
                readings[f"bf16 {op} C"] = rel_l2(ost[0], want[1])
    print(f"[sm90-mlstm] {(b, s, h, dk, dv, chunk)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        if what.split()[0] in names:
            assert r <= MLSTM_TOL, (what, r)


# (b, s, h, dk, dv, chunk, large gates): a ragged tail (chunks of 128, the
# last of 44 rows); S shorter than the chunk and not a multiple of the
# 64-row tile; dk != dv; large gates (i~ ~ U(-30, 30), f~ ~ U(-10, 6)),
# also read against fp64 autograd
MLSTM_BWD_MODEL_CASES = [
    (1, 300, 2, 64, 64, 128, False),
    (2, 100, 2, 64, 64, 256, False),
    (1, 200, 2, 128, 64, 128, False),
    (1, 200, 2, 64, 64, 128, True),
]
MLSTM_BWD_GRADS = ("dq", "dk", "dv", "di", "df")


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,large", MLSTM_BWD_MODEL_CASES)
def test_mlstm_bwd_tile_model_matches_jax_vjp_and_plain(b, s, h, dk, dv,
                                                        chunk, large):
    import jax
    rng = np.random.default_rng(s + h + dk + dv)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    bf = lambda t: t.bfloat16().float()      # bf16-representable, fp32
    q, k = bf(f(b, s, h, dk)), bf(f(b, s, h, dk))
    v, dh = bf(f(b, s, h, dv)), bf(f(b, s, h, dv))
    if large:
        i_pre = torch.from_numpy(rng.uniform(-30, 30, (b, s, h)).astype(
            np.float32))
        f_pre = torch.from_numpy(rng.uniform(-10, 6, (b, s, h)).astype(
            np.float32))
    else:
        # as xlstm-125m's init sets the gates up: f~ shifted by its bias
        i_pre, f_pre = f(b, s, h), f(b, s, h) + 4.5
    args = (q, k, v, i_pre, f_pre, dh)

    def h_of(*ins):
        return mlstm_jref.mlstm_chunked(*ins, chunk_size=chunk)[0]

    jins = [jnp.asarray(t.numpy()) for t in args[:5]]
    jgrads = jax.vjp(h_of, *jins)[1](jnp.asarray(dh.numpy()))
    oracles = {
        "jax vjp": [torch.from_numpy(np.array(x)) for x in jgrads],
        "plain": tmk.mlstm_scan_bwd_plain(*args, chunk_size=chunk),
    }
    if large:
        ins = [t.double().requires_grad_(True) for t in args[:5]]
        y64, _ = tmlstm_ref.mlstm_chunked(*ins, chunk_size=chunk,
                                          acc_dtype=torch.float64)
        oracles["fp64 autograd"] = torch.autograd.grad(y64, ins,
                                                       dh.double())
    tol = MLSTM_BWD_LARGE_TOL if large else MLSTM_BWD_TOL
    readings = {}
    for rnd in ("pair", "bf16"):
        got = tmk.mlstm_scan_bwd_tiled_plain(*args, chunk_size=chunk,
                                             rounding=rnd)
        assert [tuple(x.shape) for x in got] == [tuple(x.shape)
                                                 for x in args[:5]]
        for oname, want in oracles.items():
            readings.update({f"{rnd} {n} vs {oname}": rel_l2(gv, wv)
                             for n, gv, wv in zip(MLSTM_BWD_GRADS, got,
                                                  want)})
    print(f"[sm90-mlstm-bwd] {(b, s, h, dk, dv, chunk, large)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        if what.startswith("pair"):
            assert r <= tol, (what, r)


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tile_constants_match_the_sources_build_hashes():
    """The tiles the CPU models follow are the ones written in the
    sources that ``_build`` compiles and hashes: the decode split and
    stage, the backward's tiles (BwdTiles), the forward's kv tiles
    (Sm90Tiles), the MLA decode's split and tile, the SSD chunk scan's
    row tile, the SSD backward's pair-pass row tile, the mLSTM chunk
    scan's row tile and dv slice, and the mLSTM backward's pair tile and
    accumulator pass."""
    srcs = {p.name: p for p in _build.sources()}
    decode = srcs["paged_decode.cu"].read_text()
    assert _constexpr(decode, "kSplit") == tfa.DECODE_SPLIT
    assert _constexpr(decode, "kTile") == tfa.DECODE_TILE
    bwd = srcs["flash_attention_bwd.cu"].read_text()
    for d in tfa.BWD_HEAD_DIMS:
        dq = re.search(rf"using Dq = DqCfg<{d}, (\d+), (\d+)>;", bwd)
        dkv = re.search(rf"using Dkv = DkvCfg<{d}, (\d+), (\d+)>;", bwd)
        tiles = tuple(int(x) for x in dq.groups() + dkv.groups())
        assert tiles == tfa.BWD_TILES[d], (d, tiles)
    fwd = srcs["flash_attention.cu"].read_text()
    for d in tfa.PREFILL_HEAD_DIMS:
        cfg = re.search(rf"struct Sm90Tiles<{d}> {{ using C = "
                        rf"Sm90Cfg<{d}, (\d+), (\d+)>; }};", fwd)
        assert int(cfg.group(2)) == tfa.KV_TILES[d], d
    mla = srcs["mla_decode.cu"].read_text()
    assert _constexpr(mla, "kSplit") == tmd.SPLIT
    assert _constexpr(mla, "kTile") == tmd.TILE
    ssd = srcs["ssd_scan.cu"].read_text()
    assert _constexpr(ssd, "kRowTile") == tsk.ROW_TILE
    ssd_bwd = srcs["ssd_scan_bwd.cu"].read_text()
    assert _constexpr(ssd_bwd, "kRowTile") == tsk.BWD_ROW_TILE
    mlstm = srcs["mlstm_scan.cu"].read_text()
    assert _constexpr(mlstm, "kRowTile") == tmk.ROW_TILE
    assert _constexpr(mlstm, "kDvSlice") == tmk.DV_SLICE
    mlstm_bwd = srcs["mlstm_scan_bwd.cu"].read_text()
    assert _constexpr(mlstm_bwd, "kRowTile") == tmk.BWD_ROW_TILE
    assert _constexpr(mlstm_bwd, "kPass") == tmk.BWD_PASS


# (t, d, v, eps, softcap, tied, splits): T and V not tile multiples; the
# wrapper's splits (None) and splits that do not divide the 256-column
# vocab tiles (5 in 4 slabs, 20 in 3); label smoothing; softcap
CE_CASES = [
    (100, 64, 300, 0.0, 0.0, False, None),
    (64, 96, 257, 0.1, 0.0, True, 2),
    (33, 32, 1030, 0.0, 5.0, False, 4),
    (300, 48, 5000, 0.1, 3.0, True, 3),
    (130, 16, 5000, 0.0, 0.0, False, None),
]


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("t,d,v,eps,cap,tied,splits", CE_CASES)
def test_cross_entropy_split_model_matches_pallas_and_plain(t, d, v, eps,
                                                            cap, tied,
                                                            splits):
    rng = np.random.default_rng(t + v)
    hid = _bf16(rng, (t, d))
    table = _bf16(rng, (v, d), d ** -0.5)
    head = table.t() if tied else table.t().contiguous()
    lab = torch.from_numpy(rng.integers(0, v, t).astype(np.int32))
    wt = torch.from_numpy((rng.random(t) > 0.3).astype(np.float32))
    kw = dict(label_smoothing=eps, logit_softcap=cap, return_lse=True)
    got = tce.cross_entropy_split_plain(hid, head, lab, wt, splits=splits,
                                        **kw)
    want = tce.cross_entropy_plain(hid, head, lab, wt, **kw)
    jargs = (_jax(hid), _jax(head), jnp.asarray(lab.numpy()),
             jnp.asarray(wt.numpy()))
    pallas = cross_entropy_pallas(*jargs, label_smoothing=eps,
                                  logit_softcap=cap, block_t=16,
                                  block_v=128, interpret=True)
    dense = jref.ce_dense(*jargs, label_smoothing=eps, logit_softcap=cap)
    readings = {f"{n} vs plain": rel_l2(g, w)
                for n, g, w in zip(("loss", "w_sum", "lse"), got, want)}
    for name, ref_out in (("pallas", pallas), ("dense", dense)):
        readings[f"loss vs {name}"] = rel_l2(
            got[0], torch.tensor(float(ref_out[0])))
        assert float(got[1]) == float(ref_out[1])
    print(f"[sm90-ce] {(t, d, v, eps, cap, tied, splits)}: "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in readings.items()))
    for what, r in readings.items():
        assert r <= CE_TOL, (what, r)


def test_vocab_splits_cover_the_vocab_in_order():
    # the train step's shape: 40 token tiles x 64 splits = 2560 blocks
    assert tce.ce_splits(5120, 50304) == 64
    assert tce.ce_splits(10, 100) == 1           # one vocab tile
    for t, v in ((5120, 50304), (33, 1030), (1, 129), (4096, 50304)):
        s = tce.ce_splits(t, v)
        n_vt = -(-v // tce.VOCAB_TILE)
        assert 1 <= s <= n_vt and s & (s - 1) == 0
        bounds = tce.split_bounds(v, s)
        assert bounds[0][0] == 0 and bounds[-1][1] == v
        assert all(a < e for a, e in bounds)
        assert all(e == a2 for (_, e), (a2, _) in zip(bounds, bounds[1:]))
        assert all(a % tce.VOCAB_TILE == 0 for a, _ in bounds)


def test_build_tag_hashes_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.headers()] == ["sm90.cuh"]
    first = _build.tag()
    assert _build.tag() == first
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build.tag()
    assert second != first
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.tag() not in (first, second)
