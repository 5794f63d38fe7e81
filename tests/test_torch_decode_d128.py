"""The GQA paged decode (kernel 2, ``csrc/paged_decode.cu``) at head dim
128, the width of glm4-9b (group 16), phi4-mini-3.8b (group 3) and
arctic-480b (group 7), on the CPU: the kernel's plain version
(``flash_decode_paged_plain``) and its arithmetic model
(``flash_decode_paged_split_plain``: splits of ``DECODE_SPLIT``
positions in stages of ``DECODE_TILE``, merged in order) against
``flash_decode_paged_pallas`` in interpret mode, with NULL pages inside
live windows, an all-NULL inactive slot (kv_len 1), a length exactly
MB * bs and lengths past the window; the split model batch invariant
at D=128 too. The kernel itself is held against its plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17).

Tolerances: the decode limits of ``tests/test_torch_sm90_numerics.py``,
1e-4 absolute in fp32 (outputs are O(1), only the order of sums
differs) and 2e-2 in bf16 (the sides round to bf16 at different
points); equal bits for batch invariance; an inactive slot exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_decode_paged_pallas
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.models import transformer as ttr

D = 128
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (bs, mb, hkv, group, lens): glm4's group of 16 over three splits with
# one length exactly MB * bs; phi4's 3 with a block size that divides
# neither the split nor the stage; arctic's 7 with a length past the
# window and a length of 1 (inactive)
CASES = [
    (16, 12, 2, 16, [192, 1, 37, 150]),
    (12, 9, 8, 3, [100, 1, 13, 108]),
    (16, 5, 8, 7, [64, 1, 80, 33]),
]


def _inputs(rng, dtype, bs, mb, hkv, group, lens, holes=True):
    b = len(lens)
    n = b * mb
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    q, kp, vp = f(b, 1, hkv * group, D), f(n, bs, hkv, D), f(n, bs, hkv, D)
    tables = np.full((b, mb), n, np.int32)
    perm = rng.permutation(n)
    for i, ln in enumerate(lens):
        nb = min(-(-ln // bs), mb)
        if ln > 1:
            tables[i, :nb] = perm[i * mb:i * mb + nb]
        if holes and nb > 2:
            tables[i, nb // 2] = n                # a NULL page
    return (q, kp, vp, torch.from_numpy(tables),
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,mb,hkv,group,lens", CASES)
def test_d128_plain_and_split_model_match_pallas(pallas_interpret, dtype,
                                                 bs, mb, hkv, group, lens):
    rng = np.random.default_rng(bs * mb + group)
    q, kp, vp, tables, kv_lens = _inputs(rng, dtype, bs, mb, hkv, group,
                                         lens)
    split = tfa.flash_decode_paged_split_plain(q, kp, vp, tables, kv_lens)
    plain = tfa.flash_decode_paged_plain(q, kp, vp, tables, kv_lens)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = torch.from_numpy(np.array(flash_decode_paged_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, kp, vp)),
        jnp.asarray(tables.numpy()), jnp.asarray(kv_lens.numpy()),
        interpret=pallas_interpret).astype(jnp.float32)))
    assert split.dtype == plain.dtype == dtype
    assert split.shape == plain.shape == q.shape == (len(lens), 1,
                                                     hkv * group, D)
    errs = {"split vs pallas": (split.float() - pallas).abs().max().item(),
            "plain vs pallas": (plain.float() - pallas).abs().max().item(),
            "split vs plain": (split.float() - plain.float()).abs().max()
            .item()}
    print(f"[decode-d128] {dtype} {(bs, mb, hkv, group, lens)}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for what, e in errs.items():
        assert e <= DECODE_TOL[dtype], (what, e)
    inactive = [i for i, ln in enumerate(lens) if ln == 1]
    assert not split[inactive].any() and not plain[inactive].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d128_split_model_is_batch_invariant(dtype):
    """One sequence alone (a shorter table: fewer splits of the window)
    and inside a batch give equal bits at glm4's group of 16."""
    rng = np.random.default_rng(3)
    q, kp, vp, tables, kv_lens = _inputs(
        rng, dtype, 16, 40, 2, 16, [600, 1, 37, 300, 129], holes=True)
    seq = 3
    alone = tfa.flash_decode_paged_split_plain(
        q[seq:seq + 1], kp, vp, tables[seq:seq + 1, :20],
        kv_lens[seq:seq + 1])
    batched = tfa.flash_decode_paged_split_plain(q, kp, vp, tables, kv_lens)
    assert tfa.decode_splits(20, 16) < tfa.decode_splits(40, 16)
    assert torch.equal(alone[0], batched[seq])


def test_d128_is_a_decode_head_dim_and_the_new_archs_are_servable():
    from repro_torch.configs import base as tcfgs
    import dataclasses
    assert tfa.DECODE_HEAD_DIMS == (64, 128)
    for arch, group in (("glm4-9b", 16), ("phi4-mini-3.8b", 3),
                        ("arctic-480b", 7)):
        cfg = dataclasses.replace(tcfgs.resolve(arch),
                                  attention_impl="kernel")
        assert cfg.head_dim == D and cfg.q_per_kv == group
        assert group <= tfa.MAX_GROUP
        ttr.check_servable(cfg, "cuda")         # the card's widths
