"""gemma-7b — dense, GeGLU, head_dim 256 [arXiv:2403.08295].
28L, d_model 3072, 16 heads (kv=16; the 2b sibling uses MQA), d_ff 24576,
vocab 256000, tied embeddings, sqrt(d) embedding scale."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=("attn",),
    mlp_kind="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed_sqrt_d=True,
)
