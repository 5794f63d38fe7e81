"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion, VQ image tokens [arXiv:2405.09818; unverified].

Backbone only: the VQ-VAE image tokenizer frontend is a STUB —
input_specs() provides precomputed patch/token embeddings (B, S, d).
QK-norm per the Chameleon paper (training-stability fix).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=65536,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        qk_norm=True, frontend="embedding_stub",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=192, vocab_size=512,
        norm="rmsnorm", activation="swiglu", qk_norm=True,
        frontend="embedding_stub", remat="none",
    )


register("chameleon-34b", full, smoke)
