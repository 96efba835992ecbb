"""mistral-large-123b — dense [hf:mistralai/Mistral-Large-Instruct-2407].
88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1000000.0,
)
