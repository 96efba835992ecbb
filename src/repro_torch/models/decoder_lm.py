"""Decoder-only language model over a repeated layer pattern
(`repro.models.decoder_lm`).

The config's `pattern` (repeated) + `remainder` decide what each layer
is. The JAX package stacks each pattern position's parameters and scans
them; here the layers are an `nn.ModuleList` in depth order and the scan
is a loop. Caches are a list with one dict per layer.

Public API:
    model_defs / init_params(cfg, generator, device)
    forward(cfg, params, tokens, mode)         -> logits, aux
    prefill_step(cfg, params, tokens, length)  -> last logits, cache
    init_cache(cfg, batch, length, device)
    decode_step(cfg, params, cache, tokens, pos) -> logits, cache

`aux` is the MoE load-balance loss summed over the `attn_moe` layers (0
for models without them), as the reference's `forward` returns it.
Encoder, frontend seeding, adaptive-depth exit heads, the loss and the
sharding specs wait for ROADMAP A10.2-A10.5.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.nn import blocks as B
from repro_torch.nn.basic import apply_norm, norm_defs
from repro_torch.nn.params import ParamDef, ParamGroup, init_group, torch_dtype

MODES = ("train", "eval")


def _check_supported(cfg) -> None:
    for kind in set(cfg.layer_kinds):
        B.check_kind(kind)
    if cfg.is_encdec or cfg.num_image_tokens or cfg.pos_embed != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder / frontend / positional embeddings are not "
            f"ported yet (ROADMAP A10.2)")


# ------------------------------------------------------------------- params
def model_defs(cfg) -> Dict[str, Any]:
    """The trunk's parameter definitions, one entry per layer in depth
    order under "layers" (the JAX package stacks them per pattern
    position instead)."""
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), "embed"),
        "layers": [B.layer_defs(cfg, kind) for kind in cfg.layer_kinds],
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    return defs


class DecoderLM(nn.Module):
    """The model's parameters: `embed`, `layers[i]` (a `ParamGroup` under
    the JAX names of kind `cfg.layer_kinds[i]`), `final_norm`, `lm_head`
    unless the embeddings are tied; ``model[name]`` reads them as the
    functions below do."""

    def __init__(self, cfg, device):
        super().__init__()
        defs = model_defs(cfg)
        self.top = ParamGroup({k: v for k, v in defs.items()
                               if k != "layers"}, cfg.param_dtype, device)
        self.layers = nn.ModuleList(ParamGroup(d, cfg.param_dtype, device)
                                    for d in defs["layers"])

    def __getitem__(self, name: str):
        return self.layers if name == "layers" else self.top[name]


def init_params(cfg, generator: torch.Generator, device="cuda") -> DecoderLM:
    """Random parameters with the reference's initializers, drawn from
    `generator` (which may live on `device`, so a 9 B-parameter model is
    made on the card without a host copy)."""
    model = DecoderLM(cfg, resolve_device(device))
    init_group(model.top, generator)
    for layer in model.layers:
        init_group(layer, generator)
    return model.eval()


# ------------------------------------------------------------------ helpers
def _embed_tokens(cfg, params, tokens):
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dtype)
    if cfg.scale_embed_sqrt_d:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32
                             ).to(dtype)
    return x


def _project_logits(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.final_logit_softcap:
        logits = torch.tanh(logits / cfg.final_logit_softcap) \
            * cfg.final_logit_softcap
    return logits


def _positions(tokens):
    S = tokens.shape[1]
    return torch.arange(S, device=tokens.device)[None].expand(tokens.shape)


# ------------------------------------------------------------------ forward
@torch.no_grad()
def forward(cfg, params, tokens, *, mode: str = "train"):
    """tokens (B,S) integer. Returns (logits (B,S,V), aux). Inference only
    (no dropout, no gradient); aux () f32 is the reference's MoE
    auxiliary loss summed over the layers."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    positions = _positions(tokens)
    x = _embed_tokens(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        x, _, aux = B.apply_layer(cfg, kind, p, x, mode="train",
                                  positions=positions, aux=aux)
    x = apply_norm(cfg, params["final_norm"], x)
    return _project_logits(cfg, params, x), aux


@torch.no_grad()
def prefill_step(cfg, params, tokens, *, length: Optional[int] = None):
    """Process a full prompt; returns (last-position logits (B, V), cache),
    the cache ready for `decode_step` at pos = S. `length` (default S)
    sizes the KV cache of global-attention layers, zero past S, so that
    decoding can continue; windowed layers keep a ring of `window`."""
    S = tokens.shape[1]
    positions = _positions(tokens)
    x = _embed_tokens(cfg, params, tokens)
    caches: List[dict] = []
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="prefill",
                                positions=positions)
        if (kind in ("attn", "attn_moe") and length is not None
                and length > S):
            c = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, length - S))
                 for n, t in c.items()}
        caches.append(c)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return _project_logits(cfg, params, x)[:, 0, :], caches


# ------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, length: int, device="cuda") -> List[dict]:
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return [B.init_layer_cache(cfg, kind, batch, length, dtype, dev)
            for kind in cfg.layer_kinds]


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int):
    """One decode step. tokens (B,1) integer; pos (int) the absolute
    position of the new token. Returns (logits (B,1,V), new cache); KV
    buffers of `cache` are written in place."""
    x = _embed_tokens(cfg, params, tokens)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                pos=int(pos))
        new_cache.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return _project_logits(cfg, params, x), new_cache
