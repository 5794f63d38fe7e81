"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552; RoPE, GQA [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=151552,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=224, vocab_size=512,
        norm="rmsnorm", activation="swiglu", remat="none",
    )


register("glm4-9b", full, smoke)
