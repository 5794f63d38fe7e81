"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000; 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

Arctic's dense-MoE hybrid: every layer runs a small dense FFN residual
branch *in parallel* with the 128-expert top-2 MoE (``dense_residual``).
Optimizer-state dtype is reduced (bf16 m) so ZeRO-1-sharded Adam state
fits 16 GB HBM on the single-pod mesh — noted in EXPERIMENTS.md.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                      dense_residual=True),
        # 480e9 fp32 params alone are 7.5 GB/chip on 256 chips; bf16
        # params + bf16 moments (configs.base.optimizer_for) fit 16 GB
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        norm="rmsnorm", activation="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=96,
                      dense_residual=True),
        remat="none",
    )


register("arctic-480b", full, smoke)
