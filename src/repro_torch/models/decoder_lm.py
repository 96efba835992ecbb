"""Decoder-only language model over a repeated layer pattern
(`repro.models.decoder_lm`).

The config's `pattern` (repeated) + `remainder` decide what each layer
is. The JAX package stacks each pattern position's parameters and scans
them; here the layers are an `nn.ModuleList` in depth order and the scan
is a loop. Caches are a list with one dict per layer.

Public API:
    model_defs / init_params(cfg, generator, device)
    param_specs / abstract_params(cfg)      -> per-leaf specs / meta tensors
    forward(cfg, params, tokens, frontend, mode, collect_states,
            differentiable, remat)          -> logits, aux[, states]
    exit_logits(cfg, params, state, i)      -> logits of exit head i
    softmax_xent / loss_fn(cfg, params, batch, remat) -> loss, metrics
    prefill_step(cfg, params, tokens, frontend, length) -> last logits, cache
    init_cache(cfg, batch, length, device)
    abstract_cache / cache_specs(cfg, batch, length)
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
`jax.checkpoint`) unless `remat=False`.

Sharding (ROADMAP A item 4). `param_specs` gives each parameter's
partition spec over a ("data", "model") mesh and `cache_specs` each
cache entry's, in the port's layout: where the reference stacks the
layers of pattern position i, here block l of kind i is layer
``l * len(pattern) + i`` (the reference's ``blocks[i]`` at index l), the
remainder layers follow (``rem``), and each leaf's spec is the
reference's without its leading "layers" entry (which `fit_spec` freezes
to None anyway). A model placed by `repro_torch.sharding.placement.
shard_params` runs `forward`, `prefill_step`, `decode_step`,
`seed_frontend_cache` and `core.adaptive_depth.adaptive_decode_step`
inside `use_mesh(mesh)`: the batch (and the frontend) split over "data",
the attention layers of every kind tensor-parallel over "model"
(vocab-parallel embedding and logits, column-parallel q / k / v and MLP
inputs, row-parallel `wo` and `w_down` with an all-reduce, B4 once per
position on its heads; cross-attention over the placed frontend or
encoder output, the encoder's `enc` layers bidirectional), the
`attn_moe` experts FSDP over "data" and tensor-parallel over "model"
(`repro_torch.nn.moe`), `rwkv` over its heads (B5 once per position)
and `rglru` over its channels, the logits gathered onto the mesh's first
device and the cache placed by `cache_specs`; `init_cache` inside
`use_mesh` places the cache too. A vocab that the model axis does not
divide puts the axis on d instead: the embedding looks each id up in its
columns and all-gathers them, the head is row-parallel with its partial
logits all-reduced in f32; query heads that it does not divide put it on
d of `wq` and the head dim of `wo`, and the attention splits its query
rows over "model" instead (`nn.attention`), as rwkv splits its (batch,
head) pairs (`placement.FALLBACK_DIMS`). On a mesh of one
position every function runs as unplaced on that position's tensors.

Training on a mesh: a model placed with `shard_params(...,
trainable=True)` runs `forward(..., differentiable=True,
collect_states=...)` and `loss_fn` under the caller's grad mode, every
kind through its plain differentiable path on each position's heads or
channels (B4 and B5 are not launched), each block rematerialised when
`remat` is set; the states come back placed, the logits gathered, and
the loss is taken on the global logits as the reference's loss sees a
global array. `placement.sync_grads` then adds the copies' gradients
over the axes each leaf's spec leaves free, and `optim.adamw_update_`
steps the placed tree (`repro_torch.launch.dryrun.build_train_step`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import blocks as B
from repro_torch.nn.basic import apply_norm, norm_defs
from repro_torch.nn.params import (ParamDef, ParamGroup, abstract_tree,
                                   init_group, spec_tree, torch_dtype)
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import (current_mesh, mesh_size,
                                          named, positions as mesh_positions,
                                          spec as logical_spec)

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


def param_specs(cfg):
    """Each parameter's partition spec, in `model_defs`' tree (the
    reference's `param_specs` leaf for leaf, per layer)."""
    return spec_tree(model_defs(cfg))


def abstract_params(cfg):
    """Each parameter as a `meta` tensor of its shape and dtype."""
    return abstract_tree(model_defs(cfg), cfg.param_dtype)


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
    if pl.is_sharded(tokens):
        return pl.local_map(
            lambda e, p: _scale_embedding(cfg, e.to(dtype), p),
            _lookup_sharded(params["embed"], tokens), positions)
    return _scale_embedding(cfg, params["embed"][tokens].to(dtype),
                            positions)


def _scale_embedding(cfg, x, positions):
    dtype = x.dtype
    if cfg.scale_embed_sqrt_d:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32
                             ).to(dtype)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoid(positions, cfg.d_model).to(dtype)
    return x


def _lookup_sharded(embed, tokens):
    """Vocab-parallel lookup: each position looks up the ids in its rows
    of `embed` (V, d) and gives the others zero; the all-reduce over the
    vocab axis adds exactly one non-zero term. Where the columns (d) are
    split instead, each position looks every id up in its columns and an
    all-gather joins them. Either way the result is the unsharded lookup
    bit for bit."""
    parts = []
    for i, (e, t) in enumerate(zip(embed.locals, tokens.locals)):
        lo, n = embed.block(i, 0)
        local = t - lo
        inside = (local >= 0) & (local < n)
        parts.append(torch.where(inside[..., None], e[local.clamp(0, n - 1)],
                                 torch.zeros((), dtype=e.dtype,
                                             device=e.device)))
    x = pl.wrap(parts, (*tokens.spec, embed.spec[1]), embed.mesh)
    if embed.spec[0] is not None:
        x = pl.all_reduce_sum(x, embed.spec[0])
    return x if embed.spec[1] is None else pl.all_gather(x, embed.spec[1])


def _soft_cap_logits(cfg, logits):
    if cfg.final_logit_softcap:
        logits = torch.tanh(logits / cfg.final_logit_softcap) \
            * cfg.final_logit_softcap
    return logits


def _project_logits(cfg, params, x):
    if pl.is_sharded(x):
        tied = cfg.tie_embeddings
        head = params["embed"] if tied else params["lm_head"]
        vocab, d = (head.spec[0], head.spec[1]) if tied else (head.spec[1],
                                                               head.spec[0])
        if d is not None:
            # row-parallel (a vocab the axis does not divide): each
            # position its d slice, the partial logits summed in f32
            h = pl.local_map(lambda t: t.to(x.dtype), head)
            return pl.local_map(
                lambda lg: _soft_cap_logits(cfg, lg),
                pl.einsum("bsd,vd->bsv" if tied else "bsd,dv->bsv", x, h))
        # vocab-parallel: each position its columns, then an all-gather
        logits = pl.local_map(lambda x_, h: _soft_cap_logits(
            cfg, x_ @ (h.T if tied else h).to(x_.dtype)), x, head,
            spec=(*x.spec[:-1], vocab))
        return logits if vocab is None else pl.all_gather(logits, vocab)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _soft_cap_logits(cfg, x @ head.to(x.dtype))


def _positions(tokens):
    """(B, S) positions 0..S-1 of tokens (B, S, ...), placed as they are."""
    if pl.is_sharded(tokens):
        return pl.local_map(_positions, tokens, spec=tokens.spec[:2])
    S = tokens.shape[1]
    return torch.arange(S, device=tokens.device)[None].expand(
        tokens.shape[:2])


# ------------------------------------------------------------------ encoder
def _run_encoder(cfg, params, frontend, differentiable=False):
    """Stub frontend embeddings (B, Se, d) -> encoder output (B, Se, d):
    the `enc` layers (bidirectional self-attention through B4, or its
    plain path when `differentiable`), then `encoder_norm`. A placed
    frontend runs the layers' sharded paths."""
    dtype = torch_dtype(cfg.dtype)
    x = pl.per_position(lambda t: t.to(dtype), frontend)
    positions = _positions(x)
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
    or without it). A placed model (inside `use_mesh`) takes global
    tokens and frontend, places them by `input_shardings`, and returns
    the logits gathered onto the mesh's first device, aux there, and the
    states placed (the batch over "data")."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    mesh = pl.placed_mesh(params)
    if mesh is not None and mesh_size(mesh) == 1:
        params, mesh = pl.local_tree(params), None
    ctx = contextlib.nullcontext() if differentiable else torch.no_grad()
    with ctx:
        if mesh is None:
            positions = _positions(tokens)
            frontend = _frontend(cfg, params, frontend, differentiable)
        else:
            tokens, positions = _sharded_tokens(cfg, tokens, mesh)
            frontend = _sharded_frontend(cfg, params, frontend, mesh,
                                         differentiable)
        x = _embed_tokens(cfg, params, tokens, positions)
        aux = torch.zeros((), dtype=torch.float32,
                          device=x.device if mesh is None
                          else mesh.devices[0])
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
        logits = pl.as_global(_project_logits(cfg, params, x))
    if collect_states:
        return logits, aux, states
    return logits, aux


def exit_logits(cfg, params, state, exit_index: int):
    """Exit head `exit_index` on a block's state (..., d): the per-exit
    adapter, an f32 rmsnorm (eps `norm_eps`) times the exit's gain, then
    the shared unembedding (`_project_logits`). On a placed state (d
    whole) the replicated adapter and gain run on each position's
    lanes."""
    def adapt(s, adapter, scale):
        hf = (s @ adapter[exit_index].to(s.dtype)).float()
        hf = hf * torch.rsqrt(torch.mean(torch.square(hf), -1, keepdim=True)
                              + cfg.norm_eps)
        return (hf * scale[exit_index].float()).to(s.dtype)
    e = params["exits"]
    return _project_logits(cfg, params, pl.per_position(
        adapt, state, e["adapter"], e["norm_scale"]))


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
    where the model has them. Returns (loss, metrics). A placed model
    (inside `use_mesh`) takes the global batch; the loss is taken on the
    gathered logits, on the mesh's first device."""
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
    mesh = pl.placed_mesh(params)
    if mesh is not None and mesh_size(mesh) > 1:
        return _sharded_prefill(cfg, params, tokens, frontend, length, mesh)
    if mesh is not None:
        logits, cache = prefill_step(cfg, pl.local_tree(params), tokens,
                                     frontend=frontend, length=length)
        return logits, [{n: pl.wrap((t,), fit_cache(cfg, n, t.shape, mesh),
                                    mesh) for n, t in c.items()}
                        for c in cache]
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
def _decode_len(cfg, shape_seq: int) -> int:
    """KV length actually materialized for a decode shape. Full-attention
    configs serving long contexts switch to the sliding-window variant."""
    if shape_seq > 32_768 and cfg.supports_long_context == "window":
        return cfg.long_context_window
    return shape_seq


def init_cache(cfg, batch: int, length: int, device="cuda") -> List[dict]:
    """One dict of zeroed buffers per layer (`blocks.init_layer_cache`).
    Inside `use_mesh(mesh)` (`device` then being the mesh's first device)
    each buffer is placed on the mesh by `cache_specs`, block by block."""
    dev = resolve_device(device)
    mesh = current_mesh()
    if mesh is None:
        dtype = torch_dtype(cfg.dtype)
        return [B.init_layer_cache(cfg, kind, batch, length, dtype, dev)
                for kind in cfg.layer_kinds]
    if dev != mesh.devices[0]:
        raise ValueError(f"init_cache on {dev} inside use_mesh({mesh}): "
                         f"pass the mesh's first device")
    return [{n: pl.zeros(named(mesh, fit_cache(cfg, n, t.shape, mesh)),
                         t.shape, t.dtype) for n, t in c.items()}
            for c in abstract_cache(cfg, batch, length)]


def abstract_cache(cfg, batch: int, length: int) -> List[dict]:
    """`init_cache`'s buffers as `meta` tensors (nothing allocated)."""
    dtype = torch_dtype(cfg.dtype)
    return [B.init_layer_cache(cfg, kind, batch, length, dtype,
                               torch.device("meta"))
            for kind in cfg.layer_kinds]


_CACHE_LOGICAL = {
    "h": ("batch", "rnn"),
    "conv": ("batch", None, "rnn"),
    "state": ("batch", "heads", None, None),
    "x_t": ("batch", "embed"),
    "x_c": ("batch", "embed"),
}

_TP_AXIS = 16  # production model-axis size


def _kv_cache_logical(cfg):
    """KV cache TP dim. NEVER the sequence dim: a seq-sharded cache turns
    the per-step cache write into a whole-cache gather. Prefer kv_heads;
    fall back to head_dim (the partial-logits all-reduce is small); else
    replicate over model.

    (The rule above is the reference's and holds for "model". At a batch
    that the data axes do not divide, `fit_spec` does put "data" or "pod"
    on the sequence dim (`placement.FALLBACK_DIMS`). The port's decode
    runs that layout without a gather: the one position whose block of
    the sequence holds the new token's slot writes it, and the attention
    combines each position's partial softmax over its own keys
    (`nn.attention._split_key_sdpa`).)"""
    if cfg.num_kv_heads % _TP_AXIS == 0:
        return ("batch", "cache_seq", "kv_heads", None)
    if cfg.resolved_head_dim % _TP_AXIS == 0:
        return ("batch", "cache_seq", None, "cache_hd")
    return ("batch", "cache_seq", None, None)


def _cache_logical(cfg, name: str) -> tuple:
    """The logical axes of the cache entry `name`."""
    if name in ("k", "v", "xk", "xv"):
        return _kv_cache_logical(cfg)
    return _CACHE_LOGICAL[name]


def cache_specs(cfg, batch: int, length: int) -> List[dict]:
    """Each cache entry's partition spec, one dict per layer (the
    reference's per-layer spec, without its "layers" entry)."""
    return [{n: logical_spec(*_cache_logical(cfg, n)) for n in c}
            for c in abstract_cache(cfg, batch, length)]


def fit_cache(cfg, name: str, shape, mesh):
    """The spec of the cache entry `name` of `shape` on `mesh`: its
    `cache_specs` entry through `placement.fitted` with its logical axes
    (rwkv's state takes "model" on its key dim where the heads do not
    divide it)."""
    logical = _cache_logical(cfg, name)
    return pl.fitted(logical_spec(*logical), shape, mesh, logical)


@torch.no_grad()
def seed_frontend_cache(cfg, params, cache, frontend):
    """Fill the `xk` / `xv` entries of a fresh decode cache from the
    frontend embeddings (VLM) or the encoder's output (encoder-decoder),
    for decoding from scratch without a prefill. Returns a new list; the
    other entries are `cache`'s own buffers. A placed model fills a
    placed cache, each entry in its layout, bit for bit what its
    `prefill_step` caches."""
    mesh = pl.placed_mesh(params)
    if mesh is not None:
        _check_placed(cache)
        if mesh_size(mesh) == 1:
            return _rewrap(cache, seed_frontend_cache(
                cfg, pl.local_tree(params), pl.local_tree(cache), frontend))
        frontend = _sharded_frontend(cfg, params, frontend, mesh)
    else:
        frontend = _frontend(cfg, params, frontend)

    def like(t, c):
        if pl.is_sharded(t):
            t = pl.relayout(t, c.spec)
        return pl.per_position(lambda t_: t_.to(c.dtype), t)
    out = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        if kind in ("xattn", "encdec"):
            k, v = attn.project_kv(cfg, p["xattn"], frontend)
            c = dict(c, xk=like(k, c["xk"]), xv=like(v, c["xv"]))
        out.append(c)
    return out


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int, frontend=None):
    """One decode step. tokens (B,1) integer; pos (int) the absolute
    position of the new token; `frontend` is not read (cross-attention
    reads the cache's `xk` / `xv`), as in the reference. Returns (logits
    (B,1,V), new cache); KV buffers of `cache` are written in place."""
    mesh = pl.placed_mesh(params)
    if mesh is not None and mesh_size(mesh) > 1:
        return _sharded_decode(cfg, params, cache, tokens, int(pos), mesh)
    if mesh is not None:
        _check_placed(cache)
        logits, new = decode_step(cfg, pl.local_tree(params),
                                  pl.local_tree(cache), tokens, pos)
        return logits, _rewrap(cache, new)
    positions = torch.full(tokens.shape, int(pos), device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                pos=int(pos))
        new_cache.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return _project_logits(cfg, params, x), new_cache


# ------------------------------------------------------------------ sharded
def _check_placed(cache):
    if not all(pl.is_sharded(t) for c in cache for t in c.values()):
        raise TypeError("a placed model decodes a placed cache: make it "
                        "with init_cache inside use_mesh, or shard_cache")


def _rewrap(cache, new):
    """The blocks of a mesh of one position (`new`, unplaced) placed as
    the entries of `cache` are."""
    return [{n: dataclasses.replace(c[n], locals=(t,)) for n, t in nc.items()}
            for c, nc in zip(cache, new)]


def _sharded_tokens(cfg, tokens, mesh):
    """Tokens (B, S) split over "data", and their positions."""
    toks = pl.shard_inputs(cfg, {"tokens": tokens}, mesh)["tokens"]
    return toks, _positions(toks)


def _sharded_frontend(cfg, params, frontend, mesh, differentiable=False):
    """The frontend placed by `input_shardings` (the batch over "data"),
    through the encoder where there is one; None stays None."""
    if frontend is None:
        return None
    placed = pl.shard_inputs(cfg, {"frontend": frontend}, mesh)["frontend"]
    return _frontend(cfg, params, placed, differentiable)


@torch.no_grad()
def _sharded_prefill(cfg, params, tokens, frontend, length, mesh):
    S = tokens.shape[1]
    toks, positions = _sharded_tokens(cfg, tokens, mesh)
    fe = _sharded_frontend(cfg, params, frontend, mesh)
    x = _embed_tokens(cfg, params, toks, positions)
    caches = []
    for p, kind in zip(params["layers"], cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="prefill",
                                positions=positions, frontend=fe)
        if kind in ("attn", "attn_moe", "encdec") and length is not None \
                and length > S:
            c = dict(c, **{n: _padded(cfg, n, c[n], length, mesh)
                           for n in ("k", "v")})
        caches.append({n: pl.relayout(t, fit_cache(cfg, n, t.shape, mesh))
                       for n, t in c.items()})
    x = apply_norm(cfg, params["final_norm"],
                   pl.local_map(lambda t: t[:, -1:, :], x))
    return pl.gather(_project_logits(cfg, params, x))[:, 0, :], caches


def _padded(cfg, name: str, t, length: int, mesh):
    """A placed prefill's k or v (B, S, KV, hd) as the cache entry of
    `length` positions, zero past S, in its fitted layout: re-laid out
    with the sequence whole first (the prompt's S rows move, not the
    cache's), then each position cuts its block of the padded sequence
    (at a batch that the data axes do not divide, the block of the
    sequence they split)."""
    S = t.shape[1]
    shape = (t.shape[0], length, *t.shape[2:])
    spec_ = fit_cache(cfg, name, shape, mesh)
    t = pl.relayout(t, (spec_[0], None, *spec_[2:]))
    sharding = named(mesh, spec_)

    def block(c, b):
        start, size = sharding.block(c, 1, shape)
        out = b.new_zeros((b.shape[0], size, *b.shape[2:]))
        n = max(0, min(S, start + size) - start)
        out[:, :n] = b[:, start:start + n]
        return out
    return pl.wrap([block(c, b) for c, b in zip(mesh_positions(mesh), t.locals)],
                   spec_, mesh)


@torch.no_grad()
def _sharded_decode(cfg, params, cache, tokens, pos, mesh):
    _check_placed(cache)
    toks = pl.shard_inputs(cfg, {"tokens": tokens}, mesh)["tokens"]
    positions = pl.local_map(lambda t: torch.full_like(t, pos), toks)
    x = _embed_tokens(cfg, params, toks, positions)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds):
        x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                pos=pos)
        new_cache.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return pl.gather(_project_logits(cfg, params, x)), new_cache
