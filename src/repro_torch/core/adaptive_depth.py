"""Adaptive-Depth Inference (ADI): the paper's NAP carried over to
transformer decoding (`repro.core.adaptive_depth`).

NAP's exit criterion is the distance to a closed-form stationary state
(Eq. 7). Pre-norm residual transformers have no closed form, but hidden
states saturate with depth; the analogous criterion is the per-token
relative saturation distance

    d_t^(l) = ||h_t^(l) - h_t^(l-1)|| / ||h_t^(l)||      (cf. Eq. 8)

A token exits at the first block l in [t_min, t_max] with d < t_s and is
classified by its exit head (trained by Inception Distillation,
`repro_torch.core.inception_distill`). A block is one repeat of the
config's pattern: the port's layers l*P .. l*P+P-1, P = len(pattern);
the `remainder` layers follow. Exited tokens keep a frozen hidden state
that still flows through the later layers, whose KV it writes, so that
later tokens can attend to it.

The saving is counted, not taken: every layer runs for every token, and
`flops_saved_frac` reports the share of block compute an early exit
would skip, as in the reference. Skipping exited rows is not done.

One difference from the reference (ROADMAP C.6, its fault 5): the
reference lets a token exit at any block in [t_min, t_max] but applies an
exit head only at blocks in `exit_layers`, so a token that exits at a
block with no head is classified by the trunk head on a frozen middle
state. Here a token exits only at a block that has a head. Wherever every
block in [t_min, t_max] carries one, this is the reference exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn import blocks as B
from repro_torch.nn.basic import apply_norm
from repro_torch.sharding import placement as pl


def saturation_distance(x_new: torch.Tensor,
                        x_old: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) -> (B,) relative saturation distance, in f32."""
    num = torch.linalg.vector_norm((x_new - x_old).float(), dim=-1)
    den = torch.linalg.vector_norm(x_new.float(), dim=-1) + 1e-9
    return (num / den)[:, 0]


@torch.no_grad()
def adaptive_decode_step(cfg, params, cache, tokens, pos: int,
                         frontend=None) -> Tuple[torch.Tensor, list, dict]:
    """Early-exit decode step: `decode_step` with the exit test after
    every block. tokens (B, 1) integer; pos (int) the new token's
    position. Returns (logits (B, 1, V), new cache, info) with info =
    {exit_block (B,) int (-1: full depth), saturation (B,) f32 (the last
    distance measured while the token was active), flops_saved_frac ()
    f32}. Needs `cfg.adaptive.enabled`; tokens that never cross the
    threshold take the trunk and its head (Algorithm 1, line 17). KV
    buffers of `cache` are written in place, as `decode_step` does."""
    from repro_torch.models.decoder_lm import (_embed_tokens,
                                               _project_logits, exit_logits)
    if pl.placed_mesh(params) is not None:
        raise NotImplementedError("adaptive decoding of a placed model: not "
                                  "sharded yet (ROADMAP A, item 4a)")
    ad = cfg.adaptive
    if not ad.enabled:
        raise ValueError("adaptive_decode_step needs cfg.adaptive.enabled")
    P, R = len(cfg.pattern), cfg.pattern_repeats
    t_max = ad.t_max if ad.t_max >= 0 else R - 1
    heads = tuple(ad.exit_layers)
    # blocks where a token may exit: in [t_min, t_max] and with a head
    may_exit = [ad.t_min <= blk <= t_max and blk in heads for blk in range(R)]

    positions = torch.full(tokens.shape, int(pos), device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions)
    Bsz = tokens.shape[0]
    exit_block = torch.full((Bsz,), -1, dtype=torch.int64, device=x.device)
    exit_state = torch.zeros_like(x)
    sat = torch.ones((Bsz,), dtype=torch.float32, device=x.device)

    layers = list(zip(params["layers"], cache, cfg.layer_kinds))
    new_cache = []

    def run(x, lo, hi):
        for p, c, kind in layers[lo:hi]:
            x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                    pos=int(pos), frontend=frontend)
            new_cache.append(c)
        return x

    for blk in range(R):
        active = exit_block < 0
        x_old = x
        x_new = run(x, blk * P, (blk + 1) * P)
        # freeze exited tokens (their KV was written above, so later tokens
        # attend to them; the rest of their block's work is counted as
        # saved)
        x = torch.where(active[:, None, None], x_new, x_old)
        d = saturation_distance(x_new, x_old)
        sat = torch.where(active, d, sat)
        if may_exit[blk]:
            crosses = active & (d < ad.t_s)
            exit_block = torch.where(crosses, blk, exit_block)
            exit_state = torch.where(crosses[:, None, None], x_new,
                                     exit_state)
    x = run(x, R * P, len(layers))

    # classify: exited tokens by their exit head, the others by the trunk's
    logits = _project_logits(cfg, params,
                             apply_norm(cfg, params["final_norm"], x))
    for i, blk in enumerate(heads):
        if blk < R and may_exit[blk]:
            zi = exit_logits(cfg, params, exit_state, i)
            logits = torch.where((exit_block == blk)[:, None, None], zi,
                                 logits)

    # share of block compute an early exit skips this step
    depth_used = torch.where(exit_block < 0, R, exit_block + 1)
    flops_saved = 1.0 - torch.mean(depth_used.float()) / R
    info = {"exit_block": exit_block, "saturation": sat,
            "flops_saved_frac": flops_saved}
    return logits, new_cache, info
