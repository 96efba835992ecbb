"""llama-3.2-vision-11b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision]. 40L (32 self + 8 cross-attn),
d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256.
The ViT vision encoder + projector is a STUB: input_specs provides patch
embeddings (B, 1600, d_model)."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    mlp_kind="swiglu",
    rope_theta=500000.0,
    num_image_tokens=1600,
)
