"""Architecture registry + reduced smoke variants.

`get_config(arch_id)` resolves the exact assigned config; `smoke(cfg)`
returns the reduced same-family variant used by CPU smoke tests (2-ish
layers, d_model <= 512, <= 4 experts). The JAX package's `input_specs` /
`input_shardings` describe sharded dry-run inputs and wait for the
sharding slice."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.common import ModelConfig
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.llama32_vision_11b import CONFIG as LLAMA32_VISION_11B
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        GRANITE_34B, DEEPSEEK_CODER_33B, WHISPER_SMALL, GEMMA_7B,
        RECURRENTGEMMA_9B, MISTRAL_LARGE_123B, GROK_1_314B, RWKV6_3B,
        DBRX_132B, LLAMA32_VISION_11B,
    ]
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: identical pattern/kinds, tiny dims."""
    n_body = len(cfg.pattern)            # one pattern repeat
    kw = dict(
        num_layers=n_body + len(cfg.remainder),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        rnn_width=128 if cfg.rnn_width else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        dtype="float32",
        param_dtype="float32",
        long_context_window=64,
    )
    if cfg.pattern == ("rwkv",):
        kw.update(num_heads=2, num_kv_heads=2, rwkv_head_dim=64)
    return dataclasses.replace(cfg, **kw)
