"""Model / shape / mesh configuration schema and the architecture registry.

One module per assigned architecture lives next to this file; each exposes
``CONFIG`` (the exact published configuration) and ``SMOKE`` (a reduced
same-family configuration for CPU smoke tests).  ``repro_torch.configs.get(arch)``
resolves ids like ``"phi3-mini-3.8b"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    """A mixture of experts.  The defaults are mixtral's rule: softmax top-k
    over every expert the layer holds, capacity-bounded dispatch, the Switch
    aux loss.  DeepSeek-V3's (moonlight) sets the fields after ``aux_loss_weight``:
    a router wider than the experts held here (expert parallelism: the layer
    holds ``n_experts`` of ``router_experts`` from ``first_expert`` on and
    computes their part alone), shared experts, sigmoid scores whose top k is
    picked with a correction bias, dropless dispatch, a sequence-wise balance
    loss and the bias update after each step."""

    n_experts: int = 8       # the experts this layer holds and computes
    top_k: int = 2
    d_ff: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    router_experts: int = 0       # the router's outputs; 0 -> n_experts
    first_expert: int = 0         # the first held expert among the router's outputs
    n_shared_experts: int = 0     # one SwiGLU of n_shared_experts * d_ff beside the routed
    score_func: str = "softmax"   # softmax | sigmoid
    routed_scale: float = 1.0     # sigmoid: the gates' factor
    dispatch: str = "capacity"    # capacity | dropless
    balance_alpha: float = 0.0    # sigmoid: the sequence-wise balance loss's weight
    bias_update: float = 0.0      # sigmoid: the correction bias's step (gamma)

    @property
    def n_router(self) -> int:
        return self.router_experts or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block parameters (zamba2)."""

    state_dim: int = 64
    head_dim: int = 64       # P
    n_heads: int = 0         # derived: d_inner // head_dim if 0
    expand: int = 2          # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 128
    n_groups: int = 1        # B/C groups


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack parameters."""

    slstm_every: int = 8     # one sLSTM per this many blocks (7:1 -> 8)
    conv_width: int = 4
    chunk_size: int = 64
    proj_factor: float = 2.0  # mLSTM up-projection
    qk_factor: float = 0.25   # q/k head dim as a fraction of v head dim


@dataclass(frozen=True)
class ZambaConfig:
    shared_period: int = 6   # apply the shared attention block every N layers
    lora_rank: int = 128     # per-application LoRA on the shared block


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    # multi-head latent attention (DeepSeek-V3, no q compression): on where
    # kv_lora_rank > 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # leading dense layers before an MoE stack, their SwiGLU width
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # attention
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    use_qkv_bias: bool = False
    use_bias: bool = False   # dense/MLP bias (starcoder2, whisper)
    # block structure
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"          # swiglu | gelu
    parallel_residual: bool = False   # command-r style
    tie_embeddings: bool = False
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    zamba: ZambaConfig | None = None
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    max_target_positions: int = 0     # decoder positions (whisper: 448)
    # vlm
    n_image_tokens: int = 0           # stub patch-embedding positions
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat: "none" | "full" | "dots"
    remat_policy: str = "full"
    # attention impl: "xla" | "flash" (flash = the hand-written CUDA kernel)
    attention_impl: str = "xla"
    # unroll layer stacks instead of lax.scan — used by the dry-run so that
    # HLO cost analysis (which counts while-loop bodies once) sees the full
    # per-layer FLOPs/bytes; training keeps scan for compact HLO
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

#: archs with sub-quadratic attention paths run long_500k (see DESIGN.md)
LONG_CONTEXT_ARCHS = {"xlstm-1.3b", "zamba2-7b", "mixtral-8x7b"}


def shapes_for(arch: str) -> list[ShapeConfig]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in LONG_CONTEXT_ARCHS:
        out.append(SHAPES["long_500k"])
    return out


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    microbatches: int = 1     # gradient accumulation
    # distributed-optimization tricks
    grad_compression: str = "none"   # none | bf16 | int8
    seed: int = 0


ARCH_IDS = [
    "phi3-mini-3.8b",
    "command-r-35b",
    "starcoder2-15b",
    "internlm2-1.8b",
    "mixtral-8x7b",
    "qwen3-moe-235b-a22b",
    "xlstm-1.3b",
    "zamba2-7b",
    "whisper-medium",
    "internvl2-2b",
]

#: the architectures the JAX package has too: the ones the port is held
#: against it for, and the dry-run's production cells
REFERENCE_ARCH_IDS = list(ARCH_IDS)

#: every architecture the port runs; the ones past the reference's train only
ARCH_IDS += ["moonlight-16b-a3b"]

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "command-r-35b": "command_r_35b",
    "starcoder2-15b": "starcoder2_15b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-7b": "zamba2_7b",
    "whisper-medium": "whisper_medium",
    "internvl2-2b": "internvl2_2b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def get(arch: str, smoke: bool = False) -> ModelConfig:
    """Resolve an architecture id to its (full or smoke) ModelConfig."""
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
