"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196].
62L, d_model 7168, 56 heads (GQA kv=8), d_ff 19200, vocab 32256."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    source="arXiv:2401.14196",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    seq_shard_attn=True,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=100000.0,
)
