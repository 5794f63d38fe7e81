"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400;
MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434; hf].

Multi-head latent attention caches a rank-512 latent and a shared
64-dim RoPE key per token; decode attends in latent space (absorbed
W_uk/W_uv, ``models/kvcache.py``). Fields as in the JAX package's file.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      register)


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=1536, vocab_size=102400, head_dim=192,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                      num_shared_experts=2, shared_d_ff=1536),
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=48,
        norm="rmsnorm", activation="swiglu",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      rope_head_dim=16, nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=96,
                      num_shared_experts=1, shared_d_ff=96),
        remat="none",
    )


register("deepseek-v2-236b", full, smoke)
