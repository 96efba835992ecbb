"""Architecture registry + reduced smoke variants.

`get_config(arch_id)` resolves the exact assigned config; `smoke(cfg)`
returns the reduced same-family variant used by CPU smoke tests (2-ish
layers, d_model <= 512, <= 4 experts). `input_specs` describes every
model input of a shape as a `meta` tensor (nothing allocated) and
`input_shardings` its partition spec."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.common import ModelConfig, ShapeConfig
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
from repro_torch.nn.params import torch_dtype
from repro_torch.sharding.logical import spec as logical_spec

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


# --------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """`meta` tensors standing in for every model input of (arch, shape):
    "tokens" (B, S) int32, or (B, 1) in decode, and for VLM and
    encoder-decoder models "frontend" (B, N, d) in the model's dtype."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    specs: dict = {}
    if shape.mode in ("train", "prefill"):
        specs["tokens"] = torch.empty((B, S), dtype=tok, device="meta")
    else:  # decode: one new token
        specs["tokens"] = torch.empty((B, 1), dtype=tok, device="meta")
    if cfg.is_encdec:
        specs["frontend"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), dtype=torch_dtype(cfg.dtype),
            device="meta")
    elif cfg.num_image_tokens:
        specs["frontend"] = torch.empty(
            (B, cfg.num_image_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device="meta")
    return specs


def input_shardings(cfg: ModelConfig,
                    shape: Optional[ShapeConfig] = None) -> dict:
    """The inputs' partition specs: the batch over ``data`` (the reference
    takes `shape` too and does not read it)."""
    out = {"tokens": logical_spec("batch", None)}
    if cfg.is_encdec or cfg.num_image_tokens:
        out["frontend"] = logical_spec("batch", None, "embed")
    return out
