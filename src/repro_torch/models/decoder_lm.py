"""Decoder-only language model over a repeated layer pattern
(`repro.models.decoder_lm`).

The config's `pattern` (repeated) + `remainder` decide what each layer
is. The JAX package stacks each pattern position's parameters and scans
them; here the layers are an `nn.ModuleList` in depth order and the scan
is a loop. Caches are a list with one dict per layer.

Public API:
    model_defs / init_params(cfg, generator, device)
    forward(cfg, params, tokens, frontend, mode, collect_states,
            differentiable, remat)          -> logits, aux[, states]
    exit_logits(cfg, params, state, i)      -> logits of exit head i
    softmax_xent / loss_fn(cfg, params, batch, remat) -> loss, metrics
    prefill_step(cfg, params, tokens, frontend, length) -> last logits, cache
    init_cache(cfg, batch, length, device)
    seed_frontend_cache(cfg, params, cache, frontend)   -> cache
    decode_step(cfg, params, cache, tokens, pos, frontend) -> logits, cache

`aux` is the MoE load-balance loss summed over the `attn_moe` layers (0
for models without them), as the reference's `forward` returns it.
`frontend` is the (B, N, d) stub of a VLM's image embeddings (N =
`num_image_tokens`) or an encoder-decoder's audio frames (N =
`encoder_seq`, run through the encoder's `enc` layers first); None for
the other models.

A block is one repeat of `cfg.pattern`: layers l*P .. l*P+P-1 for P =
len(pattern); the `remainder` layers follow the R blocks. With
`cfg.adaptive` enabled and exit layers named, the model carries the
early-exit heads `exits` (per-exit adapter and norm gain, and the
ensemble vector `ens_s`), read by `exit_logits` on a block's state,
trained by `loss_fn`'s Inception Distillation term and served by
`repro_torch.core.adaptive_depth`.

Inference (`forward` by default, `prefill_step`, `decode_step`) runs
without autograd through kernels B4 / B5. Training calls `forward(...,
differentiable=True)` (what `loss_fn` does): the plain differentiable
layer paths, each block rematerialised in the backward pass
(`torch.utils.checkpoint`, the counterpart of the reference's
`jax.checkpoint`) unless `remat=False`. The sharding specs wait for the
LM sharding slice.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import blocks as B
from repro_torch.nn.basic import apply_norm, norm_defs
from repro_torch.nn.params import ParamDef, ParamGroup, init_group, torch_dtype

MODES = ("train", "eval")
STACKS = ("layers", "encoder")      # per-layer lists of parameter groups


# ------------------------------------------------------------------- params
def model_defs(cfg) -> Dict[str, Any]:
    """The trunk's parameter definitions, one entry per layer in depth
    order under "layers", and for an encoder-decoder one per encoder
    layer under "encoder" with its final "encoder_norm" (the JAX package
    stacks the layers per pattern position, and the encoder's, instead)."""
    d, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), "embed"),
        "layers": [B.layer_defs(cfg, kind) for kind in cfg.layer_kinds],
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    if cfg.is_encdec:
        defs["encoder"] = [B.layer_defs(cfg, "enc")
                           for _ in range(cfg.encoder_layers)]
        defs["encoder_norm"] = norm_defs(cfg)
    if has_exits(cfg):
        n = len(cfg.adaptive.exit_layers)
        defs["exits"] = {
            "adapter": ParamDef((n, d, d), ("exit", "embed", None), "small"),
            "norm_scale": ParamDef((n, d), ("exit", "embed"), "ones"),
            # self-attention ensemble weight vector s (Eq. 5 of the paper)
            "ens_s": ParamDef((V, 1), ("vocab", None), "small"),
        }
    return defs


def has_exits(cfg) -> bool:
    """Does the model carry early-exit heads (`exits`)?"""
    return bool(cfg.adaptive.enabled and cfg.adaptive.exit_layers)


class DecoderLM(nn.Module):
    """The model's parameters: `embed`, `layers[i]` (a `ParamGroup` under
    the JAX names of kind `cfg.layer_kinds[i]`), `final_norm`, `lm_head`
    unless the embeddings are tied, for an encoder-decoder `encoder[i]`
    (`enc` layers) and `encoder_norm`, and `exits` where `has_exits`;
    ``model[name]`` reads them as the functions below do."""

    def __init__(self, cfg, device):
        super().__init__()
        defs = model_defs(cfg)
        self.top = ParamGroup({k: v for k, v in defs.items()
                               if k not in STACKS}, cfg.param_dtype, device)
        self.layers = nn.ModuleList(ParamGroup(d, cfg.param_dtype, device)
                                    for d in defs["layers"])
        self.encoder = nn.ModuleList(ParamGroup(d, cfg.param_dtype, device)
                                     for d in defs.get("encoder", ()))

    def __getitem__(self, name: str):
        return getattr(self, name) if name in STACKS else self.top[name]


def init_params(cfg, generator: torch.Generator, device="cuda") -> DecoderLM:
    """Random parameters with the reference's initializers, drawn from
    `generator` (which may live on `device`, so a 9 B-parameter model is
    made on the card without a host copy)."""
    model = DecoderLM(cfg, resolve_device(device))
    init_group(model.top, generator)
    for layer in (*model.layers, *model.encoder):
        init_group(layer, generator)
    return model.eval()


# ------------------------------------------------------------------ helpers
def _sinusoid(positions, d: int):
    """positions (B, S) -> (B, S, d) fixed sinusoidal embedding, f32."""
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_tokens(cfg, params, tokens, positions=None):
    """Token embeddings in the model's dtype, scaled by sqrt(d) where the
    config says so, plus the sinusoidal position embedding of `positions`
    (B, S) where `pos_embed == "sinusoidal"` (whisper)."""
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens].to(dtype)
    if cfg.scale_embed_sqrt_d:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32
                             ).to(dtype)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoid(positions, cfg.d_model).to(dtype)
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


# ------------------------------------------------------------------ encoder
def _run_encoder(cfg, params, frontend, differentiable=False):
    """Stub frontend embeddings (B, Se, d) -> encoder output (B, Se, d):
    the `enc` layers (bidirectional self-attention through B4, or its
    plain path when `differentiable`), then `encoder_norm`."""
    x = frontend.to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])
    for p in params["encoder"]:
        x, _, _ = B.apply_layer(cfg, "enc", p, x, mode="train",
                                positions=positions,
                                differentiable=differentiable)
    return apply_norm(cfg, params["encoder_norm"], x)


def _frontend(cfg, params, frontend, differentiable=False):
    """What the cross-attention layers read: the encoder's output for an
    encoder-decoder, else the frontend embeddings as given."""
    if cfg.is_encdec:
        return _run_encoder(cfg, params, frontend, differentiable)
    return frontend


# ------------------------------------------------------------------ forward
def forward(cfg, params, tokens, *, frontend=None, mode: str = "train",
            collect_states: bool = False, differentiable: bool = False,
            remat: bool = True):
    """tokens (B,S) integer; `frontend` (B, N, d) for VLM and
    encoder-decoder models. Returns (logits (B,S,V), aux), and with
    `collect_states` (logits, aux, states): states[l] (B, S, d) the
    hidden state after block l, for l < R (the remainder layers'
    outputs are not collected), as the reference's scan collects them.
    aux () f32 is the reference's MoE auxiliary loss summed over the
    layers.

    By default inference: no autograd, kernels B4 / B5, no dropout.
    `differentiable` runs the layers' plain differentiable paths under
    the caller's grad mode, each block rematerialised in the backward
    pass when `remat` and mode == "train" (the numbers are the same with
    or without it)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    ctx = contextlib.nullcontext() if differentiable else torch.no_grad()
    with ctx:
        positions = _positions(tokens)
        x = _embed_tokens(cfg, params, tokens, positions)
        frontend = _frontend(cfg, params, frontend, differentiable)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        P, R = len(cfg.pattern), cfg.pattern_repeats
        layers = list(zip(params["layers"], cfg.layer_kinds))

        def run(x, aux, lo, hi):
            for p, kind in layers[lo:hi]:
                x, _, aux = B.apply_layer(cfg, kind, p, x, mode="train",
                                          positions=positions,
                                          frontend=frontend, aux=aux,
                                          differentiable=differentiable)
            return x, aux

        states = []
        use_remat = (differentiable and remat and mode == "train"
                     and torch.is_grad_enabled())
        for blk in range(R):
            if use_remat:
                x, aux = checkpoint(run, x, aux, blk * P, (blk + 1) * P,
                                    use_reentrant=False)
            else:
                x, aux = run(x, aux, blk * P, (blk + 1) * P)
            if collect_states:
                states.append(x)
        x, aux = run(x, aux, R * P, len(layers))
        x = apply_norm(cfg, params["final_norm"], x)
        logits = _project_logits(cfg, params, x)
    if collect_states:
        return logits, aux, states
    return logits, aux


def exit_logits(cfg, params, state, exit_index: int):
    """Exit head `exit_index` on a block's state (..., d): the per-exit
    adapter, an f32 rmsnorm (eps `norm_eps`) times the exit's gain, then
    the shared unembedding (`_project_logits`)."""
    e = params["exits"]
    h = state @ e["adapter"][exit_index].to(state.dtype)
    hf = h.float()
    hf = hf * torch.rsqrt(torch.mean(torch.square(hf), -1, keepdim=True)
                          + cfg.norm_eps)
    h = (hf * e["norm_scale"][exit_index].float()).to(state.dtype)
    return _project_logits(cfg, params, h)


# --------------------------------------------------------------------- loss
def softmax_xent(logits, labels, mask=None):
    """logits (B,S,V) any dtype; labels (B,S) integer; mask (B,S)
    optional. Mean next-token negative log-likelihood in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def loss_fn(cfg, params, batch, *, remat: bool = True):
    """Next-token prediction on batch = {"tokens" (B, S), optional
    "frontend"} through the differentiable path: the LM loss plus the MoE
    aux loss, plus the Inception Distillation term of the exit heads
    where the model has them. Returns (loss, metrics)."""
    tokens = batch["tokens"]
    adaptive = has_exits(cfg)
    out = forward(cfg, params, tokens, frontend=batch.get("frontend"),
                  mode="train", collect_states=adaptive,
                  differentiable=True, remat=remat)
    logits, aux = out[0], out[1]
    labels = tokens[:, 1:]
    lm = softmax_xent(logits[:, :-1], labels)
    loss = lm + aux
    metrics = {"lm_loss": lm, "aux_loss": aux}
    if adaptive:
        from repro_torch.core.inception_distill import \
            transformer_inception_loss
        id_loss, id_metrics = transformer_inception_loss(
            cfg, params, out[2], logits, labels)
        loss = loss + id_loss
        metrics.update(id_metrics)
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def prefill_step(cfg, params, tokens, *, frontend=None,
                 length: Optional[int] = None):
    """Process a full prompt (and the `frontend`, as `forward` takes it);
    returns (last-position logits (B, V), cache), the cache ready for
    `decode_step` at pos = S. `length` (default S) sizes the self-attention
    KV cache of global-attention layers, zero past S, so that decoding can
    continue; windowed layers keep a ring of `window`, and the
    cross-attention entries `xk` / `xv` keep the frontend's length."""
    S = tokens.shape[1]
    positions = _positions(tokens)
    x = _embed_tokens(cfg, params, tokens, positions)
    frontend = _frontend(cfg, params, frontend)
    caches: List[dict] = []
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="prefill",
                                positions=positions, frontend=frontend)
        if (kind in ("attn", "attn_moe", "encdec") and length is not None
                and length > S):
            c = dict(c, **{n: torch.nn.functional.pad(
                c[n], (0, 0, 0, 0, 0, length - S)) for n in ("k", "v")})
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
def seed_frontend_cache(cfg, params, cache, frontend):
    """Fill the `xk` / `xv` entries of a fresh decode cache from the
    frontend embeddings (VLM) or the encoder's output (encoder-decoder),
    for decoding from scratch without a prefill. Returns a new list; the
    other entries are `cache`'s own buffers."""
    frontend = _frontend(cfg, params, frontend)
    out = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        if kind in ("xattn", "encdec"):
            k, v = attn.project_kv(cfg, p["xattn"], frontend)
            c = dict(c, xk=k.to(c["xk"].dtype), xv=v.to(c["xv"].dtype))
        out.append(c)
    return out


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int, frontend=None):
    """One decode step. tokens (B,1) integer; pos (int) the absolute
    position of the new token; `frontend` is not read (cross-attention
    reads the cache's `xk` / `xv`), as in the reference. Returns (logits
    (B,1,V), new cache); KV buffers of `cache` are written in place."""
    positions = torch.full(tokens.shape, int(pos), device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                pos=int(pos))
        new_cache.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return _project_logits(cfg, params, x), new_cache
