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

Tolerances are the card's limits for the kernels
(``repro_torch.kernels.parity.RTOL``, relative L2): 5e-4 for the bf16
attention output and lse, 2e-6 for the bf16 cross entropy's loss sum,
weight sum and lse. Both sides round the attention output to bf16, so
most of what is left is a 1-ulp rounding of some outputs. The reading of
a single bf16 rounding of p (about 2e-3, above the limit: why the kernel
takes the pair) is printed, not asserted.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy import ref as jref
from repro.kernels.cross_entropy.cross_entropy import cross_entropy_pallas
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro_torch.kernels import _build
from repro_torch.kernels.cross_entropy import cross_entropy as tce
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.parity import RTOL, rel_l2

ATTN_TOL = RTOL[("flash_attention_cuda", torch.bfloat16)]
CE_TOL = RTOL[("cross_entropy_cuda", torch.bfloat16)]

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
