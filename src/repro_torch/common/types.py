"""Config dataclasses of the LM substrate (the port of `repro.common.types`).

Frozen dataclasses, so configs are hashable and compare by value. The
mesh, training and TPU hardware configs of the JAX package wait for the
sharding and training slices (ROADMAP A9/A11).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Layer kinds understood by repro_torch.nn.blocks
#   attn      : global causal self-attention + dense MLP
#   local     : sliding-window causal self-attention + dense MLP
#   attn_moe  : global causal self-attention + MoE MLP          (not ported)
#   rglru     : RG-LRU recurrent mixer + dense MLP (Griffin/RecurrentGemma)
#   rwkv      : RWKV6 time-mix + channel-mix
#   xattn     : cross-attention (to frontend embeddings) + MLP  (not ported)
#   encdec    : causal self-attn + cross-attn to encoder + MLP  (not ported)
#   enc       : bidirectional self-attention + dense MLP        (not ported)
# ---------------------------------------------------------------------------
LAYER_KINDS = ("attn", "local", "attn_moe", "rglru", "rwkv", "xattn", "encdec",
               "enc")


@dataclass(frozen=True)
class AdaptiveDepthConfig:
    """Paper technique (NAI) generalized to depth-adaptive transformer
    inference: early-exit heads + saturation criterion + inception
    distillation. Mirrors (T_s, T_min, T_max, T, lambda, r) of the paper."""
    enabled: bool = False
    exit_layers: Tuple[int, ...] = ()    # block indices carrying exit heads
    t_s: float = 0.05                    # saturation threshold (T_s)
    t_min: int = 1                       # min exit index (T_min)
    t_max: int = -1                      # max exit index; -1 = last (T_max)
    temperature: float = 1.4             # distillation temperature T
    lam: float = 0.9                     # loss mix lambda
    ensemble_r: int = 2                  # online-distillation ensemble size r


@dataclass(frozen=True)
class ModelConfig:
    """One decoder-style (or enc-dec) architecture."""
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                     # citation for the config
    # trunk dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    # block pattern: repeated `pattern` + trailing `remainder`
    pattern: Tuple[str, ...] = ("attn",)
    remainder: Tuple[str, ...] = ()
    # MLP / activations
    mlp_kind: str = "swiglu"             # swiglu | geglu | gelu
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # attention
    rope_theta: float = 10000.0
    sliding_window: int = 0              # used by 'local' layers
    use_rope: bool = True
    # context-parallel attention flag of the sharded JAX package (unused
    # on one device)
    seq_shard_attn: bool = False
    attn_logit_softcap: float = 0.0
    # recurrent (RG-LRU)
    rnn_width: int = 0                   # 0 -> d_model
    conv1d_width: int = 4
    # rwkv
    rwkv_head_dim: int = 64
    # enc-dec / frontend stubs
    encoder_layers: int = 0
    encoder_seq: int = 1500              # stub audio frames
    num_image_tokens: int = 0            # stub vision patches (VLM)
    # misc
    norm_kind: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    pos_embed: str = "none"              # none | sinusoidal (when no RoPE)
    scale_embed_sqrt_d: bool = False     # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False
    final_logit_softcap: float = 0.0
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # long-context serving variant (beyond-paper): cap decode KV to a window
    long_context_window: int = 4096
    # paper technique
    adaptive: AdaptiveDepthConfig = field(default_factory=AdaptiveDepthConfig)

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def pattern_repeats(self) -> int:
        body = self.num_layers - len(self.remainder)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {self.num_layers} layers != r*{len(self.pattern)} + "
            f"{len(self.remainder)}")
        return body // len(self.pattern)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.pattern * self.pattern_repeats + self.remainder

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> str:
        """'native' (sub-quadratic mixer), 'window' (sliding-window variant),
        used to decide how long_500k is served."""
        kinds = set(self.pattern) | set(self.remainder)
        if kinds <= {"rwkv", "rglru", "local"} or (
                "rglru" in kinds and "attn" not in kinds):
            return "native"
        return "window"

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced variant for smoke tests."""
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                            # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}
