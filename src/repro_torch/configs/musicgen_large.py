"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec tokenizer + codebook-interleaving frontend is
a STUB — input_specs() provides precomputed (summed-codebook) frame
embeddings. The output head predicts one 2048-entry codebook.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048,
        norm="layernorm", activation="gelu", rope_theta=10000.0,
        frontend="embedding_stub",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=192, vocab_size=128,
        norm="layernorm", activation="gelu",
        frontend="embedding_stub", remat="none",
    )


register("musicgen-large", full, smoke)
