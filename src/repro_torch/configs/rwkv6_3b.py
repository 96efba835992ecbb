"""rwkv6-3b "Finch" — attention-free SSM with data-dependent decay
[arXiv:2404.05892]. 32L, d_model 2560, d_ff 8960, vocab 65536, head_dim 64.
NAP (the paper's exit criterion) is inapplicable to the attention-free scan
(DESIGN.md §Arch-applicability); implemented without it. long_500k native."""
from repro_torch.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # d_model / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    pattern=("rwkv",),
    mlp_kind="gelu",         # unused by rwkv blocks (cmix has its own FFN)
    norm_kind="layernorm",
    use_rope=False,
    rwkv_head_dim=64,
)
