"""Model configuration and registry (port of ``repro/configs/base.py``).

Only what the dense serving path reads: :class:`ModelConfig` with the
same fields and defaults as the JAX package, the sub-configs it holds,
the attention-impl names, and the arch registry. The training-side
configs (shapes, ``HetConfig``, optimizer, mesh) come with the training
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

# ModelConfig.attention_impl selects the attention on both serving hot
# paths: prefill flash attention (models/blocks.py) and paged decode
# (models/kvcache.py). "reference" is the chunked online-softmax torch
# path, "dense" forces the full-score-matrix oracle, "kernel" runs the
# hand-written CUDA kernels for CUDA tensors and their plain PyTorch
# versions for CPU tensors. The JAX package's "pallas" maps to "kernel".
ATTENTION_IMPLS = ("reference", "dense", "kernel")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard-style top-k routing)."""

    num_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    capacity_factor_eval: float = 2.0
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention settings."""

    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings for hybrid / ssm architectures."""

    state_dim: int = 0
    head_dim: int = 64
    num_heads: int = 0
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    ngroups: int = 1

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-stack settings (alternating mLSTM / sLSTM blocks)."""

    enabled: bool = False
    num_heads: int = 4
    slstm_every: int = 2
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_kernel: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + weight-shared attention block."""

    enabled: bool = False
    attn_every: int = 6
    shared_attn_d_ff: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only backbone configuration (LM family)."""

    name: str = "unnamed"
    family: str = "dense"
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 50304
    head_dim: int = 0               # 0 => d_model // num_heads
    max_seq_len: int = 4096

    norm: str = "rmsnorm"
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)

    frontend: str = "token"

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"
    scan_layers: bool = True
    attention_impl: str = "reference"   # see ATTENTION_IMPLS

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"'{self.attention_impl}'")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def resolve(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def smoke_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _SMOKE:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_SMOKE)}")
    return _SMOKE[arch_id]()


def _ensure_loaded() -> None:
    # the arch modules register themselves on import; the other nine
    # JAX arch files have no counterpart in the port yet
    from repro_torch.configs import tinyllama_1_1b  # noqa: F401
