"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1].
64L, d_model 6144, 48 heads (GQA kv=8), d_ff 32768 per expert, vocab 131072.
Attention logit soft-cap 30 (grok-1 model card)."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    source="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=("attn_moe",),
    mlp_kind="gelu",
    num_experts=8,
    experts_per_token=2,
    attn_logit_softcap=30.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
)
