"""Support -> block-ELL packing for the compiled serving path (host side).

The port's copy of the single-device half of `repro.gnn.packing`: it
converts the induced subgraph of a sampled `Support` into the operand set
of the block-ELL SpMM kernel (`repro_torch.kernels.spmm`) and the fused
NAP step kernel (`repro_torch.kernels.nap_step`), padded to *bucket* sizes
so that repeat batches of similar size reuse the same buffer shapes:

* the batch region is padded from `n_batch` to `nb_bucket` rows (pad rows
  have no edges, zero features, zero stationary state — they exit at T_min
  and are dropped by slicing results to `nb_real`);
* support rows follow at `nb_bucket`, and the total row count is padded to
  a multiple of CB so feature blocks index cleanly;
* the per-row-block tile budget `max_tb` is padded to `tb_bucket`.

Buckets grow geometrically ({1,2,3}·2^k). The packer also emits `hop_rb`,
the minimum BFS hop per row block, from which the per-step NAP row-block
predicate follows statically (`step_active_blocks`). The numpy passes are
those of the JAX package, so a pack is array-equal to its pack of the same
support. With ``seeds=`` (the propagated-feature cache) the edges into
cache-hit rows are dropped and the hit rows' stored series are emitted as
seed operands, which the NAP loop writes over those rows after every
step. Sharded and halo packs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.gnn.sampler import Support
from repro_torch.kernels.spmm import CB, FB, RB

_INF_HOP = np.int32(2 ** 30)   # hop assigned to padding rows


def next_bucket(x: int, minimum: int = 1) -> int:
    """Smallest value >= max(x, minimum) in the geometric series
    {1, 2, 3} * 2^k * minimum (ratio <= 1.5)."""
    x = max(int(x), minimum)
    b = minimum
    while True:
        for mult in (1, 2, 3):
            if b * mult >= x:
                return b * mult
        b *= 2


def batch_bucket(n_batch: int) -> int:
    """Bucketed batch-region size (RB-aligned)."""
    return next_bucket(n_batch, RB)


@dataclasses.dataclass
class PackedSupport:
    # block-ELL operands (see repro_torch.kernels.spmm.spmm_block_ell)
    tiles: np.ndarray        # (n_rb, tb, RB, CB) f32 coefficient tiles
    tile_col: np.ndarray     # (n_rb, tb) int32 column-block per tile
    valid: np.ndarray        # (n_rb, tb) int32 1 = real tile
    hop_rb: np.ndarray       # (n_rb,) int32 min BFS hop per row block
    # padded batch layout
    n_batch: int             # bucket-padded batch region (rows [0, n_batch))
    nb_real: int             # true batch size (rows [0, nb_real) are real)
    n_pad: int               # total padded rows (multiple of CB)
    s_real: int              # true support size
    # padded dense operands
    x0: np.ndarray           # (n_pad, f_pad) f32 features at support rows
    x_inf: np.ndarray        # (n_batch, f_pad) f32 stationary state
    # bucket-padded edge list in padded row ids (segment backend; pad
    # edges have coef 0 so they contribute nothing)
    src: np.ndarray          # (e_pad,) int32
    dst: np.ndarray          # (e_pad,) int32
    coef: np.ndarray         # (e_pad,) f32
    # rank-1 stationary-state factors (x_inf = c_inf ⊗ s_inf) for the
    # fused kernel; None unless pack_support got x_inf_factors
    c_inf: Optional[np.ndarray] = None    # (n_batch,) f32
    s_inf: Optional[np.ndarray] = None    # (f_pad,) f32
    # True when pack_support refilled a caller-provided buffer set in
    # place instead of allocating (the steady-state serving path)
    reused: bool = False
    # propagated-feature-cache seed operands (seeds= packs only): padded
    # row ids of cache-hit rows (pad entries point one past the row range
    # and are dropped by the NAP loop) and their per-step series values
    seed_rows: Optional[np.ndarray] = None   # (k_pad,) int32
    seed_vals: Optional[np.ndarray] = None   # (L, k_pad, f_pad) f32

    @property
    def n_rb(self) -> int:
        return self.tiles.shape[0]

    @property
    def seed_pad(self) -> int:
        """Bucket-padded cache-seed rows (0 = no-cache pack)."""
        return 0 if self.seed_rows is None else self.seed_rows.shape[-1]


def _remap_rows(sup: Support, nb_bucket: int) -> np.ndarray:
    """Local support id -> padded row id (batch region padded to
    nb_bucket)."""
    shift = nb_bucket - sup.n_batch
    ids = np.arange(len(sup), dtype=np.int64)
    return np.where(ids < sup.n_batch, ids, ids + shift)


def pack_support(sup: Support, x0: np.ndarray, x_inf: np.ndarray, *,
                 nb_bucket: Optional[int] = None,
                 s_bucket: Optional[int] = None,
                 tb_bucket: Optional[int] = None,
                 e_bucket: Optional[int] = None,
                 build_tiles: bool = True,
                 build_edges: bool = True,
                 x_inf_factors=None,
                 out: Optional[PackedSupport] = None,
                 seeds=None,
                 k_bucket: Optional[int] = None) -> PackedSupport:
    """Pack a sampled `Support` (+ its features and per-batch-node
    stationary state) into bucket-padded block-ELL operands.

    x0 (S, f) support-row features; x_inf (n_batch, f) stationary state (a
    zero-column x_inf means the caller only needs the batch-row count).
    Explicit buckets are FLOORS (s_bucket a CB multiple); the packer grows
    past them when the support needs more — the serving engine passes its
    per-batch-size high-water marks here.

    `build_tiles=False` skips tile construction (the segment backend only
    reads the edge list); `build_edges=False` skips the edge list the
    block-ELL backends never read. `x_inf_factors=(c, s)` also emits the
    bucket-padded rank-1 factors `c_inf` / `s_inf` (zero padding).

    `out` is a previously packed result whose buffers are refilled in
    place when every bucket-padded shape matches (then the result IS
    `out`, with `reused=True`); otherwise a fresh set is allocated.
    Callers overlapping packing with device work must rotate >= 2 buffer
    sets so an in-flight batch's operands are never overwritten.

    `seeds=(hit, vals)` (the propagated-feature cache): `hit` is the
    sampler's per-support-row hit mask, `vals` the (k_hit, L, F) cached
    series in ``nodes[hit]`` order. Edges INTO hit rows are dropped before
    tiling (their values are seeded after every step, not recomputed);
    edges FROM hit rows stay. Hit rows get hop `_INF_HOP`, so row blocks
    that the cache serves entirely are skipped. `k_bucket` is the floor of
    the seed-row pad. Batch rows must never be hits."""
    if s_bucket and s_bucket % CB:
        raise ValueError(f"s_bucket {s_bucket} not a multiple of {CB}")
    nb, S = sup.n_batch, len(sup)
    nb_bucket = max(batch_bucket(nb), nb_bucket or 0)
    if nb_bucket % RB:
        raise ValueError(f"nb_bucket {nb_bucket} not a multiple of {RB}")
    rows_needed = nb_bucket + (S - nb)
    n_pad = max(next_bucket(-(-rows_needed // CB), 1) * CB, s_bucket or 0)

    seeds_on = seeds is not None
    if seeds_on:
        hit_mask, seed_series = seeds
        if hit_mask[:nb].any():
            raise ValueError("batch rows must not be cache hits")
    if seeds_on and hit_mask.any():
        # drop edges INTO hit rows (their values are seeded); edges FROM
        # hit rows stay — miss rows read them
        keep_e = ~hit_mask[sup.dst]
        e_src_l, e_dst_l = sup.src[keep_e], sup.dst[keep_e]
        e_coef = sup.coef[keep_e]
        hop_eff = np.where(hit_mask, _INF_HOP, sup.hop)
    else:
        # no hits: no edge-mask copies (seed operands are still emitted,
        # so shapes stay stable)
        e_src_l, e_dst_l, e_coef = sup.src, sup.dst, sup.coef
        hop_eff = sup.hop

    row_of = _remap_rows(sup, nb_bucket)
    src = row_of[e_src_l]
    dst = row_of[e_dst_l]

    # --- tile geometry (up front, so buffer reuse can be decided before
    # anything is written)
    n_rb, n_cb = n_pad // RB, n_pad // CB
    if build_tiles:
        rb = dst // RB
        cb = src // CB
        key = rb * n_cb + cb
        uniq, inverse = np.unique(key, return_inverse=True)
        tile_rb = (uniq // n_cb).astype(np.int64)
        tile_cb = (uniq % n_cb).astype(np.int32)
        counts = np.bincount(tile_rb, minlength=n_rb)
        tb_needed = max(int(counts.max()) if len(uniq) else 1, 1)
        tb = max(next_bucket(tb_needed, 1), tb_bucket or 0)
    else:
        tb = 0
    f_pad = -(-x0.shape[1] // FB) * FB
    xi_cols = f_pad if x_inf.shape[1] else 0
    e_pad = (max(next_bucket(len(src), 1), e_bucket or 0)
             if build_edges else 0)
    if seeds_on:
        hit_idx = np.flatnonzero(hit_mask)
        k_pad = max(next_bucket(max(len(hit_idx), 1), 1), k_bucket or 0)
        sv_shape = (seed_series.shape[1], k_pad, f_pad)

    reuse = (out is not None
             and out.tiles.shape == (n_rb, tb, RB, CB)
             and out.x0.shape == (n_pad, f_pad)
             and out.x_inf.shape == (nb_bucket, xi_cols)
             and out.src.shape == (e_pad,)
             and (out.c_inf is not None) == (x_inf_factors is not None)
             and (out.seed_rows is not None) == seeds_on
             and (not seeds_on or out.seed_vals.shape == sv_shape))
    if reuse:
        p = out
        p.tiles.fill(0.0)
        p.tile_col.fill(0)
        p.valid.fill(0)
        p.x0.fill(0.0)
        p.x_inf.fill(0.0)
    else:
        p = PackedSupport(
            tiles=np.zeros((n_rb, tb, RB, CB), np.float32),
            tile_col=np.zeros((n_rb, tb), np.int32),
            valid=np.zeros((n_rb, tb), np.int32),
            hop_rb=np.full(n_rb, _INF_HOP, np.int32),
            n_batch=nb_bucket, nb_real=nb, n_pad=n_pad, s_real=S,
            x0=np.zeros((n_pad, f_pad), np.float32),
            x_inf=np.zeros((nb_bucket, xi_cols), np.float32),
            src=np.full(e_pad, 0, np.int32),
            dst=np.full(e_pad, 0, np.int32),
            coef=np.zeros(e_pad, np.float32),
            c_inf=(np.zeros(nb_bucket, np.float32)
                   if x_inf_factors is not None else None),
            s_inf=(np.zeros(f_pad, np.float32)
                   if x_inf_factors is not None else None),
            seed_rows=(np.zeros(k_pad, np.int32) if seeds_on else None),
            seed_vals=(np.zeros(sv_shape, np.float32)
                       if seeds_on else None))
    p.n_batch, p.nb_real, p.n_pad, p.s_real = nb_bucket, nb, n_pad, S
    p.reused = reuse

    # --- vectorized block-ELL build: uniq is sorted, so the tiles of one
    # row block are contiguous and column-sorted
    if build_tiles:
        first_of_rb = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(uniq), dtype=np.int64) - first_of_rb[tile_rb]
        p.tile_col[tile_rb, slot] = tile_cb
        p.valid[tile_rb, slot] = 1
        np.add.at(p.tiles, (rb, slot[inverse], dst % RB, src % CB),
                  e_coef)

    # --- per-row hop -> per-row-block min hop
    hop_row = np.full(n_pad, _INF_HOP, np.int32)
    hop_row[row_of] = hop_eff
    p.hop_rb[:] = hop_row.reshape(n_rb, RB).min(axis=1)

    p.x0[row_of, :x0.shape[1]] = np.asarray(x0, np.float32)
    p.x_inf[:nb, :x_inf.shape[1]] = x_inf

    if x_inf_factors is not None:
        c, s = x_inf_factors
        p.c_inf.fill(0.0)
        p.c_inf[:nb] = np.asarray(c, np.float32)
        p.s_inf.fill(0.0)
        p.s_inf[:len(s)] = np.asarray(s, np.float32)

    # bucket-padded edge list: pad with zero-coef self-edges on the last
    # (always padding or hop-max) row
    if build_edges:
        p.src.fill(n_pad - 1)
        p.dst.fill(n_pad - 1)
        p.coef.fill(0.0)
        p.src[:len(src)] = src
        p.dst[:len(dst)] = dst
        p.coef[:len(e_coef)] = e_coef

    # cache-seed operands: padded row ids of hit rows and their series,
    # padded to k_pad (pad ids point one past the row range)
    if seeds_on:
        p.seed_rows.fill(n_pad)
        p.seed_vals.fill(0.0)
        p.seed_rows[:len(hit_idx)] = row_of[hit_idx].astype(np.int32)
        p.seed_vals[:, :len(hit_idx), :seed_series.shape[2]] = \
            seed_series.transpose(1, 0, 2)
    return p


def step_active_blocks(hop_rb: np.ndarray, t_max: int) -> np.ndarray:
    """(t_max, n_rb) int32: row blocks whose X^(l) value can still reach a
    batch output at step l = 1..t_max (hop <= T_max - l). Row 0 of the
    result is step l=1."""
    ls = np.arange(1, t_max + 1, dtype=np.int64)[:, None]
    return (hop_rb[None, :] <= t_max - ls).astype(np.int32)
