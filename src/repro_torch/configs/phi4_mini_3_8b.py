"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE SwiGLU GQA [arXiv:2412.08905; hf].

The 200k vocabulary makes the lm-head/CE path the dominant activation;
this arch is the motivating case for kernels/cross_entropy.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=200064,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke", family="dense",
        num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=256, vocab_size=1024,
        norm="rmsnorm", activation="swiglu", tie_embeddings=True,
        remat="none",
    )


register("phi4-mini-3.8b", full, smoke)
