"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + weight-shared attention
block every 6 layers [arXiv:2411.15242; hf].

The Mamba2 layers keep an O(1) state per sequence (a conv tail and the
(H, P, N) SSM state); the one shared attention block, applied after
every 6th layer, keeps a contiguous KV cache per application. Fields as
in the JAX package's file.
"""
from repro_torch.configs.base import (HybridConfig, ModelConfig, SSMConfig,
                                      register)


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                      chunk_size=256, ngroups=1),
        hybrid=HybridConfig(enabled=True, attn_every=6,
                            shared_attn_d_ff=10240),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        norm="rmsnorm", activation="swiglu",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk_size=32, ngroups=1),
        hybrid=HybridConfig(enabled=True, attn_every=2,
                            shared_attn_d_ff=128),
        remat="none",
    )


register("zamba2-2.7b", full, smoke)
