"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000; llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=5632, vocab_size=32000,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=256,
        norm="rmsnorm", activation="swiglu", remat="none",
    )


register("tinyllama-1.1b", full, smoke)
