"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].
40L, d_model 6144, 48 heads (GQA kv=8), d_ff 10752 per expert, vocab 100352."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=("attn_moe",),
    mlp_kind="swiglu",
    num_experts=16,
    experts_per_token=4,
    norm_kind="layernorm",
    rope_theta=500000.0,
)
