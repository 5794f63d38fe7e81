"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304; non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        norm="nonparam_ln", activation="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256,
        norm="nonparam_ln", activation="swiglu", tie_embeddings=True,
        remat="none",
    )


register("olmo-1b", full, smoke)
