"""whisper-small — audio encoder-decoder [arXiv:2212.04356].
12L decoder (+12L encoder), d_model 768, 12 heads, d_ff 3072, vocab 51865.
The mel-spectrogram + conv frontend is a STUB: input_specs provides
precomputed frame embeddings (B, 1500, d_model)."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    seq_shard_attn=True,
    pattern=("encdec",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_rope=False,
    pos_embed="sinusoidal",
    encoder_layers=12,
    encoder_seq=1500,
)
