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

A placed model (`repro_torch.sharding.placement.shard_params`, inside
`use_mesh`) decodes its lanes where they lie: the batch over "data", d
whole on every position, so each position measures its own lanes'
distances and takes their exit decisions, the masks and the frozen state
position by position. The positions along "model" hold equal copies of
a lane: the row-parallel sums hand every one of them the same bits (a
fixed order, rounded once), so they decide alike. `exit_block`,
`saturation` and the logits are gathered onto the mesh's first device,
and `flops_saved_frac` is the mean over the whole batch.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.nn import blocks as B
from repro_torch.nn.basic import apply_norm
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import mesh_size


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
    from repro_torch.models.decoder_lm import (_check_placed, _embed_tokens,
                                               _rewrap)
    ad = cfg.adaptive
    if not ad.enabled:
        raise ValueError("adaptive_decode_step needs cfg.adaptive.enabled")
    mesh = pl.placed_mesh(params)
    if mesh is not None:
        _check_placed(cache)
        if mesh_size(mesh) == 1:
            logits, new, info = adaptive_decode_step(
                cfg, pl.local_tree(params), pl.local_tree(cache), tokens,
                pos, frontend)
            return logits, _rewrap(cache, new), info
        tokens = pl.shard_inputs(cfg, {"tokens": tokens}, mesh)["tokens"]
    positions = pl.per_position(lambda t: torch.full_like(t, int(pos)),
                                tokens)
    x = _embed_tokens(cfg, params, tokens, positions)
    logits, new_cache, exit_block, sat = adaptive_layers(cfg, params, cache,
                                                         x, pos, frontend)
    if mesh is not None:
        logits, exit_block, sat = (pl.gather(t) for t in (logits, exit_block,
                                                          sat))
    # share of block compute an early exit skips this step
    R = cfg.pattern_repeats
    depth_used = torch.where(exit_block < 0, R, exit_block + 1)
    flops_saved = 1.0 - torch.mean(depth_used.float()) / R
    info = {"exit_block": exit_block, "saturation": sat,
            "flops_saved_frac": flops_saved}
    return logits, new_cache, info


def _exit_test(x_new, x_old, exit_block, exit_state, sat, *, blk: int,
               may_exit: bool, t_s: float):
    """One block's exit test on a batch of lanes: freeze the exited lanes
    (their KV was written, so later tokens attend to them; the rest of
    their block's work is counted as saved), the active lanes' distance,
    and the lanes that cross t_s at a block where they may exit.
    Returns (x, exit_block, exit_state, sat)."""
    active = exit_block < 0
    x = torch.where(active[:, None, None], x_new, x_old)
    d = saturation_distance(x_new, x_old)
    sat = torch.where(active, d, sat)
    if may_exit:
        crosses = active & (d < t_s)
        exit_block = torch.where(crosses, blk, exit_block)
        exit_state = torch.where(crosses[:, None, None], x_new, exit_state)
    return x, exit_block, exit_state, sat


def adaptive_layers(cfg, params, cache, x, pos: int, frontend=None):
    """The layers of `adaptive_decode_step` on the embedded tokens x (B,
    1, d), placed or not: returns (logits (B, 1, V), new cache,
    exit_block (B,), saturation (B,)), placed as x is (the lanes over
    "data", every "model" position with its own copy)."""
    from repro_torch.models.decoder_lm import _project_logits, exit_logits
    ad = cfg.adaptive
    P, R = len(cfg.pattern), cfg.pattern_repeats
    t_max = ad.t_max if ad.t_max >= 0 else R - 1
    heads = tuple(ad.exit_layers)
    # blocks where a token may exit: in [t_min, t_max] and with a head
    may_exit = [ad.t_min <= blk <= t_max and blk in heads for blk in range(R)]
    lanes = (x.spec[0],) if pl.is_sharded(x) else None

    def lane_init(value, dtype):
        return pl.per_position(lambda t: torch.full(
            (t.shape[0],), value, dtype=dtype, device=t.device), x,
            spec=lanes)
    exit_block = lane_init(-1, torch.int64)
    exit_state = pl.per_position(torch.zeros_like, x)
    sat = lane_init(1.0, torch.float32)

    layers = list(zip(params["layers"], cache, cfg.layer_kinds))
    new_cache = []

    def run(x, lo, hi):
        for p, c, kind in layers[lo:hi]:
            x, c, _ = B.apply_layer(cfg, kind, p, x, mode="decode", cache=c,
                                    pos=int(pos), frontend=frontend)
            new_cache.append(c)
        return x

    for blk in range(R):
        x_new = run(x, blk * P, (blk + 1) * P)
        test = functools.partial(_exit_test, blk=blk, may_exit=may_exit[blk],
                                 t_s=ad.t_s)
        args = (x_new, x, exit_block, exit_state, sat)
        x, exit_block, exit_state, sat = (
            test(*args) if lanes is None else pl.local_map_n(
                test, *args, specs=(x.spec, lanes, x.spec, lanes)))
    x = run(x, R * P, len(layers))

    # classify: exited tokens by their exit head, the others by the trunk's
    logits = _project_logits(cfg, params,
                             apply_norm(cfg, params["final_norm"], x))
    for i, blk in enumerate(heads):
        if blk < R and may_exit[blk]:
            zi = exit_logits(cfg, params, exit_state, i)
            logits = pl.per_position(
                lambda z, lg, e: torch.where((e == blk)[:, None, None], z,
                                             lg), zi, logits, exit_block)
    return logits, new_cache, exit_block, sat
