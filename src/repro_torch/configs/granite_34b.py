"""granite-34b — dense llama-arch code model [arXiv:2405.04324].
88L, d_model 6144, 48 heads (MQA kv=1), d_ff 24576, vocab 49152."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=10000.0,
)
