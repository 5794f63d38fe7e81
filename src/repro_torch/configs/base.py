"""Configuration and registry (port of ``repro/configs/base.py``).

:class:`ModelConfig` with the sub-configs it holds, the training-side
configs (:class:`ShapeConfig`, :class:`HetConfig`,
:class:`OptimizerConfig`, :class:`MeshConfig`, :class:`TrainConfig`) and
the mode constants, all with the same fields and defaults as the JAX
package, plus the arch registry. ``HetConfig.validate`` is the JAX
package's, check for check; which of the valid modes the port runs is
decided by ``launch/steps.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

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

    def param_count(self) -> int:
        """Total parameter count of the dense plan the port builds
        (``transformer.init_params``), computed from the widths."""
        from repro_torch.models.transformer import count_params_analytic
        return count_params_analytic(self)


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")


# --------------------------------------------------------------------------
# Heterogeneous-capacity (the paper's technique) configuration
# --------------------------------------------------------------------------

GRAD_REDUCTION_MODES = ("allreduce", "bucketed_allreduce", "hierarchical")
OVERLAP_MODES = ("none", "buckets", "backward")
COMPRESSION_MODES = ("none", "int8")
QUANTIZE_IMPLS = ("reference", "pallas")
WEIGHTING_MODES = ("tokens", "samples", "canonical")
PIPELINE_MODES = ("1f1b", "gpipe")
EXPLICIT_REDUCTIONS = ("bucketed_allreduce", "hierarchical")


@dataclass(frozen=True)
class HetConfig:
    """HetSeq heterogeneous data-parallel settings (fields, defaults and
    validation as in the JAX package; see its docstring there)."""

    capacities: Tuple[float, ...] = ()      # empty => homogeneous
    weighting: str = "tokens"               # tokens | samples
    grad_reduction: str = "allreduce"       # see GRAD_REDUCTION_MODES
    compression: str = "none"               # see COMPRESSION_MODES
    error_feedback: bool = True
    bucket_mb: float = 0.0                  # >0 => bucketed flat-buffer engine
    quantize_impl: str = "reference"        # see QUANTIZE_IMPLS
    overlap: str = "none"                   # see OVERLAP_MODES
    accum_steps: int = 1                    # delayed update (paper M4)
    straggler_ema: float = 0.9
    replan_interval: int = 100              # steps between capacity replans
    pipeline_stages: int = 1                # >1 => pipelined layer stack
    pipeline_schedule: str = "1f1b"         # see PIPELINE_MODES

    def validate(self) -> "HetConfig":
        """Mesh-independent config validation; raises ``ValueError``.
        Returns self for chaining."""
        def member(name, value, allowed):
            if value not in allowed:
                raise ValueError(
                    f"HetConfig.{name}='{value}' is not one of "
                    f"{' | '.join(allowed)}")

        member("weighting", self.weighting, WEIGHTING_MODES)
        member("grad_reduction", self.grad_reduction, GRAD_REDUCTION_MODES)
        member("compression", self.compression, COMPRESSION_MODES)
        member("quantize_impl", self.quantize_impl, QUANTIZE_IMPLS)
        member("overlap", self.overlap, OVERLAP_MODES)
        member("pipeline_schedule", self.pipeline_schedule, PIPELINE_MODES)
        if self.pipeline_stages < 1:
            raise ValueError(
                f"HetConfig.pipeline_stages must be >= 1, got "
                f"{self.pipeline_stages}")
        if self.bucket_mb < 0:
            raise ValueError(
                f"HetConfig.bucket_mb must be >= 0, got {self.bucket_mb}")
        if self.accum_steps < 1:
            raise ValueError(
                f"HetConfig.accum_steps must be >= 1, got "
                f"{self.accum_steps}")
        if not 0.0 <= self.straggler_ema < 1.0:
            raise ValueError(
                f"HetConfig.straggler_ema must be in [0, 1), got "
                f"{self.straggler_ema}")
        if self.replan_interval < 1:
            raise ValueError(
                f"HetConfig.replan_interval must be >= 1, got "
                f"{self.replan_interval}")
        if any(c < 0 for c in self.capacities):
            raise ValueError(
                f"HetConfig.capacities must be non-negative, got "
                f"{self.capacities}")
        if self.grad_reduction == "bucketed_allreduce" \
                and self.bucket_mb <= 0:
            raise ValueError(
                "HetConfig.grad_reduction='bucketed_allreduce' needs "
                "bucket_mb > 0 (the explicit flat-buffer engine)")
        if self.overlap != "none":
            if self.grad_reduction not in EXPLICIT_REDUCTIONS:
                raise ValueError(
                    f"HetConfig.overlap='{self.overlap}' needs an "
                    f"explicit reduction "
                    f"({' | '.join(EXPLICIT_REDUCTIONS)}), not "
                    f"'{self.grad_reduction}'")
            if self.bucket_mb <= 0:
                raise ValueError(
                    f"HetConfig.overlap='{self.overlap}' needs "
                    f"bucket_mb > 0 (a bucket grid to pipeline over)")
        if self.weighting == "canonical":
            # one fixed reduction tree over global rows — any engine
            # that regroups the sum (buckets, hierarchy, compression,
            # accumulation) would break the bit-identity guarantee
            for field, value, want in (
                    ("grad_reduction", self.grad_reduction, "allreduce"),
                    ("overlap", self.overlap, "none"),
                    ("compression", self.compression, "none")):
                if value != want:
                    raise ValueError(
                        f"HetConfig.weighting='canonical' requires "
                        f"{field}='{want}', got '{value}' (the "
                        f"order-canonical sum must be the only "
                        f"reduction)")
            if self.accum_steps != 1:
                raise ValueError(
                    "HetConfig.weighting='canonical' requires "
                    f"accum_steps=1, got {self.accum_steps}")
        if self.pipeline_stages > 1:
            if self.overlap != "none":
                raise ValueError(
                    f"HetConfig.overlap='{self.overlap}' is incompatible "
                    f"with pipeline_stages={self.pipeline_stages}: the "
                    "overlap pipelines flush grad buckets over the DP "
                    "axes mid-backward, which cannot cross a pipeline "
                    "stage boundary (each stage owns only its layer "
                    "slice); use overlap='none' — the pipeline step "
                    "already reduces grads per-stage")
            if self.weighting == "canonical":
                raise ValueError(
                    "HetConfig.weighting='canonical' is incompatible "
                    f"with pipeline_stages={self.pipeline_stages}: the "
                    "order-canonical executor needs one fixed "
                    "whole-model reduction tree, but 1F1B regroups the "
                    "sum per (stage, microbatch)")
            if self.grad_reduction == "hierarchical":
                raise ValueError(
                    "HetConfig.grad_reduction='hierarchical' is not "
                    f"supported with pipeline_stages="
                    f"{self.pipeline_stages}; use 'allreduce' or "
                    "'bucketed_allreduce' (per-stage bucket flush)")
            if self.accum_steps < self.pipeline_stages:
                raise ValueError(
                    f"HetConfig.pipeline_stages={self.pipeline_stages} "
                    f"needs accum_steps >= pipeline_stages (got "
                    f"{self.accum_steps}): the accumulation microbatches "
                    "are the 1F1B stream and the pipe must fill")
        return self


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.98)    # paper: transformer betas
    eps: float = 1e-9
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "inverse_sqrt"              # inverse_sqrt | linear | cosine | constant
    warmup_steps: int = 4000
    total_steps: int = 100000
    m_dtype: str = "float32"
    v_dtype: str = "float32"


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh. DP spans (pod, data); TP/EP/SP use model."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_size(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("pod", "data"):
                n *= s
        return n

    @property
    def model_size(self) -> int:
        for ax, s in zip(self.axes, self.shape):
            if ax == "model":
                return s
        return 1


@dataclass(frozen=True)
class TrainConfig:
    """One full training-run configuration (fields and defaults as in the
    JAX package)."""

    model: ModelConfig
    shape: ShapeConfig = TRAIN_4K
    het: HetConfig = field(default_factory=HetConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    zero1: bool = True              # shard optimizer state over DP (beyond paper)
    label_smoothing: float = 0.0    # paper translation task uses 0.1
    log_every: int = 10
    ckpt_every: int = 1000
    ckpt_dir: str = "/tmp/hetseq_ckpt"
    ckpt_keep: int = 3


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

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
    # the arch modules register themselves on import; the other eight
    # JAX arch files have no counterpart in the port yet
    from repro_torch.configs import olmo_1b, tinyllama_1_1b  # noqa: F401
