"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427 Griffin / RecurrentGemma model card].
38L, d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000.
Pattern: (rglru, rglru, local) x 12 + (rglru, rglru) = 38 layers.
Local attention window 2048 -> natively sub-quadratic (long_500k runs)."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    remainder=("rglru", "rglru"),
    mlp_kind="geglu",
    sliding_window=2048,
    rnn_width=4096,
    conv1d_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed_sqrt_d=True,
)
