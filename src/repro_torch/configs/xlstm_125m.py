"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304;
alternating mLSTM + sLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: no separate FFN sub-block — the mLSTM block carries an internal
2x up-projection and the sLSTM block a gated 4/3x post-FFN (paper
design). Fully recurrent: each block keeps an O(1) state per sequence
(a conv tail and the cell state). "125m" is the paper's name; these
widths give 173,008,944 parameters with the untied head. Fields as in
the JAX package's file.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        norm="layernorm",
        xlstm=XLSTMConfig(enabled=True, num_heads=4, slstm_every=2,
                          proj_factor_mlstm=2.0, proj_factor_slstm=1.333,
                          conv_kernel=4),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=256,
        norm="layernorm",
        xlstm=XLSTMConfig(enabled=True, num_heads=2, slstm_every=2,
                          proj_factor_mlstm=2.0, proj_factor_slstm=1.333,
                          conv_kernel=4),
        remat="none",
    )


register("xlstm-125m", full, smoke)
