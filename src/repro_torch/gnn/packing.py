"""Support -> block-ELL packing for the device serving path (host side).

The port's copy of `repro.gnn.packing`: it converts the induced subgraph
of a sampled `Support` into the operand set of the block-ELL SpMM kernel
(`repro_torch.kernels.spmm`) and the fused NAP step kernel
(`repro_torch.kernels.nap_step`), padded to *bucket* sizes so that repeat
batches of similar size reuse the same pooled buffer shapes:

* the batch region is padded from `n_batch` to `nb_bucket` rows (pad rows
  have no edges, zero features, zero stationary state — they exit at T_min
  and are dropped by slicing results to `nb_real`);
* support rows follow at `nb_bucket`, and the total row count is padded to
  an `s_bucket` multiple of CB so feature blocks index cleanly;
* the per-row-block tile budget `max_tb` is padded to `tb_bucket`.

Buckets grow geometrically ({1,2,3}·2^k). The packer also emits `hop_rb`,
the minimum BFS hop per row block, from which the per-step NAP row-block
predicate follows statically (`step_active_blocks`). The numpy passes are
those of the JAX package, so a pack is array-equal to its pack of the same
support. With ``seeds=`` (the propagated-feature cache) the edges into
cache-hit rows are dropped and the hit rows' stored series are emitted as
seed operands, which the NAP loop writes over those rows after every step.

Sharded packing (``n_shards=D > 1``, consumed by
`repro_torch.gnn.backends.run_propagation` with a mesh): the padded rows
are PERMUTED into shard-major order — CB-row superblocks dealt
round-robin across shards (superblock j -> shard j % D), each shard's
blocks concatenated — so the d-th contiguous 1/D of every row-split
operand is exactly shard d's round-robin blocks, with equal shapes on
every shard. The permutation granularity is CB (the SpMM kernel's
x-blocking): whole column blocks move, so every coefficient tile keeps its
single-device contents, per-row-block slot order and within-tile layout —
sharded SpMM is bit-identical to single-device, not just close. The
prices of alignment: the batch region pads to a multiple of CB*D and the
total rows to a multiple of CB*D (the paper's batch 500 on 4 shards pads
to 512). Batch rows land permuted too: `shard_batch_perm` maps original
batch position -> packed position, and results gather back through it.

Halo packing (``halo=True`` with ``n_shards > 1``): a shard's tiles only
read the CB column blocks named in its `tile_col`. The packer computes,
per shard, the sorted union of global CB blocks its rows reference — own
blocks plus the remote *halo* — and rewrites `tile_col` (and the segment
path's `src`) into indices of that local **halo frame**. The frame is in
sorted global block order, which groups entries by source shard; the
metadata drives both frame exchanges of `repro_torch.gnn.backends`:

* ``halo_src_shard`` / ``halo_src_block`` (D, H_pad) — where each frame
  block lives (owner shard, owner-local block): a static block gather out
  of the concatenated frontier (``gather_mode="halo"``).
* ``halo_send_block`` (D, D, B_pad) / ``halo_frame_src`` (D, H_pad) — the
  per-pair send lists and the frame positions of the received blocks for
  the block exchange (``gather_mode="alltoall"``), which moves only halo
  blocks between shards.
* ``halo_count`` (D,) — real frame entries per shard (the rest is
  padding; padded entries point at block 0, which no valid tile or real
  edge references).

H_pad and B_pad are bucket-padded like every other operand (capped at the
block counts they index) and pooled by the buffer-reuse path, so
steady-state serving allocates nothing with halo on. Frame rows are
bit-identical copies of the dense frontier rows and tile slot order never
moves, so halo propagation keeps the sharded == single-device identity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


def batch_bucket(n_batch: int, n_shards: int = 1) -> int:
    """Bucketed batch-region size: RB-aligned single-device, CB*D-aligned
    sharded (every shard must own the same number of leading batch
    superblocks)."""
    return next_bucket(n_batch, RB if n_shards == 1 else CB * n_shards)


def pack_rows(n_batch: int, n_rows: int, n_feat: int, *,
              nb_bucket: Optional[int] = None,
              s_bucket: Optional[int] = None,
              n_shards: int = 1) -> Tuple[int, int, int]:
    """The padded row and feature geometry of a pack of `n_rows` support
    rows, `n_batch` of them batch rows, `n_feat` wide: (the batch region's
    bucket, the padded row count, the padded feature width). Explicit
    buckets are floors (legal sizes: `nb_bucket` RB-aligned, CB * D
    sharded; `s_bucket` a multiple of CB * D)."""
    row_align = CB * n_shards
    batch_align = RB if n_shards == 1 else CB * n_shards
    if s_bucket and s_bucket % row_align:
        raise ValueError(f"s_bucket {s_bucket} not a multiple of "
                         f"{row_align} (CB * n_shards)")
    nb_bucket = max(batch_bucket(n_batch, n_shards), nb_bucket or 0)
    if nb_bucket % batch_align:
        raise ValueError(f"nb_bucket {nb_bucket} not a multiple of "
                         f"{batch_align}")
    rows_needed = nb_bucket + (n_rows - n_batch)
    n_pad = max(next_bucket(-(-rows_needed // row_align), 1) * row_align,
                s_bucket or 0)
    return nb_bucket, n_pad, -(-n_feat // FB) * FB


def edge_bucket(n_edges: int, e_bucket: Optional[int] = None) -> int:
    """The padded length of an edge list of `n_edges` (per shard, the
    widest shard's count); `e_bucket` is a floor."""
    return max(next_bucket(n_edges, 1), e_bucket or 0)


def shard_block_perm(n_blocks: int, n_shards: int) -> np.ndarray:
    """Shard-major round-robin permutation of CB superblocks: block j
    goes to shard j % D at local slot j // D, i.e. packed position
    (j % D) * (n_blocks // D) + j // D. Requires n_blocks % D == 0."""
    if n_blocks % n_shards:
        raise ValueError(f"{n_blocks} superblocks not divisible by "
                         f"{n_shards} shards")
    j = np.arange(n_blocks, dtype=np.int64)
    return (j % n_shards) * (n_blocks // n_shards) + j // n_shards


def shard_row_perm(n_rows: int, n_shards: int) -> np.ndarray:
    """Per-row packed position under the superblock round-robin (rows
    move with their CB superblock; within-block offsets are preserved,
    which is what keeps tile contents bit-identical)."""
    if n_rows % (CB * n_shards):
        raise ValueError(f"{n_rows} rows not a multiple of CB*D = "
                         f"{CB * n_shards}")
    r = np.arange(n_rows, dtype=np.int64)
    return shard_block_perm(n_rows // CB, n_shards)[r // CB] * CB + r % CB


def shard_batch_perm(n_batch: int, n_shards: int) -> np.ndarray:
    """Packed position of each original batch row inside the (n_batch,)
    batch-region arrays (x_inf, c_inf, exit orders, series rows). Same
    round-robin formula restricted to the batch region: batch superblocks
    are globally first and round-robin preserves relative order, so they
    are the FIRST nb/(CB*D) superblocks of every shard in both the full
    row space and the batch-only space."""
    return shard_row_perm(n_batch, n_shards)


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
    # bucket-padded edge list in padded row ids (for the segment-sum
    # compiled path; pad edges have coef 0 so they contribute nothing).
    # Sharded (n_shards > 1) the arrays carry a leading shard axis
    # (D, e_pad): src holds PACKED global row ids (indexes the gathered
    # frontier), dst holds shard-LOCAL row ids.
    src: np.ndarray          # (e_pad,) int32
    dst: np.ndarray          # (e_pad,) int32
    coef: np.ndarray         # (e_pad,) f32
    # rank-1 stationary-state factors (x_inf = c_inf ⊗ s_inf), padded to
    # the same buckets — the fused step kernel streams these instead of
    # the dense x_inf; None unless pack_support got x_inf_factors
    c_inf: Optional[np.ndarray] = None    # (n_batch,) f32
    s_inf: Optional[np.ndarray] = None    # (f_pad,) f32
    # True when pack_support refilled a caller-provided buffer set in
    # place instead of allocating (the steady-state serving path)
    reused: bool = False
    # row partition over the serving mesh's data axis (1 = unsharded);
    # sharded operands are in shard-major superblock-permuted row order
    n_shards: int = 1
    # halo-frame metadata (halo=True packs only; see module docstring):
    # per shard, the sorted union of global CB blocks its rows reference,
    # bucket-padded to H_pad entries, plus the block-exchange plan
    halo_src_shard: Optional[np.ndarray] = None   # (D, H_pad) int32
    halo_src_block: Optional[np.ndarray] = None   # (D, H_pad) int32
    halo_count: Optional[np.ndarray] = None       # (D,) int32 real entries
    halo_send_block: Optional[np.ndarray] = None  # (D, D, B_pad) int32
    halo_frame_src: Optional[np.ndarray] = None   # (D, H_pad) int32
    # propagated-feature-cache seed operands (seeds= packs only): padded
    # row ids of cache-hit rows (pad entries point one past the local row
    # range — dropped by the NAP loop's seed write) and
    # their per-step series values. Sharded they carry a leading shard
    # axis and shard-LOCAL row ids, like the edge arrays.
    seed_rows: Optional[np.ndarray] = None   # (k_pad,) / (D, k_pad) int32
    seed_vals: Optional[np.ndarray] = None   # (L, k_pad, f_pad) /
    #                                          (D, L, k_pad, f_pad) f32

    @property
    def n_rb(self) -> int:
        return self.tiles.shape[0]

    @property
    def density(self) -> float:
        return float(self.valid.mean()) if self.valid.size else 0.0

    @property
    def n_halo_pad(self) -> int:
        """Bucket-padded halo-frame blocks per shard (0 = dense pack)."""
        return (0 if self.halo_src_shard is None
                else self.halo_src_shard.shape[1])

    @property
    def halo_send_pad(self) -> int:
        """Bucket-padded block-exchange send-list blocks per shard pair."""
        return (0 if self.halo_send_block is None
                else self.halo_send_block.shape[2])

    @property
    def halo_rows(self) -> int:
        """True halo-frame rows of the widest shard (the boundary the
        exchange actually has to move; n_halo_pad * CB is what the
        padded gather materializes)."""
        return (0 if self.halo_count is None
                else int(self.halo_count.max()) * CB)

    @property
    def seed_pad(self) -> int:
        """Bucket-padded cache-seed rows per shard (0 = no-cache pack)."""
        return 0 if self.seed_rows is None else self.seed_rows.shape[-1]

    @property
    def halo_frac(self) -> float:
        """halo_rows / n_pad — 1.0 means the halo set degenerated to the
        full frontier (no communication saving over the dense gather)."""
        return self.halo_rows / self.n_pad if self.halo_count is not None \
            else 1.0

    def shape_key(self, spmm_impl: str = "block_ell") -> tuple:
        """The operand shapes the device path sees for the given SpMM
        implementation (the JAX package's jit-cache key, the same tuple):
        ``block_ell`` and ``fused`` read the same operand set, ``segment``
        the edge list; `n_shards` is in the key, and halo packs append
        their frame and send-list pads, which size the per-step exchange
        (and tell halo from dense)."""
        if spmm_impl in ("block_ell", "fused"):
            key = (spmm_impl, self.n_shards, self.n_batch, self.n_pad,
                   self.tiles.shape[1], self.x0.shape[1])
        else:
            key = ("segment", self.n_shards, self.n_batch, self.n_pad,
                   self.x0.shape[1], self.src.shape[-1])
        if self.halo_src_shard is not None:
            key += ("halo", self.n_halo_pad, self.halo_send_pad)
        if self.seed_rows is not None:
            key += ("seed", self.seed_vals.shape[-3],
                    self.seed_vals.shape[-2])
        return key


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
                 n_shards: int = 1,
                 halo: bool = False,
                 h_bucket: Optional[int] = None,
                 hb_bucket: Optional[int] = None,
                 seeds=None,
                 k_bucket: Optional[int] = None) -> PackedSupport:
    """Pack a sampled `Support` (+ its features and per-batch-node
    stationary state) into bucket-padded block-ELL operands.

    x0 (S, f) support-row features; x_inf (n_batch, f) stationary state.
    Explicit buckets are FLOORS (must be legal sizes: s_bucket a CB
    multiple); the packer grows past them when the support needs more.
    The serving engine passes its per-shape high-water marks here so that
    a smaller follow-up batch reuses the previous buffer shapes.

    `build_tiles=False` skips tile construction entirely (tiles/tile_col/
    valid come back with a zero tile budget) — the segment-sum path only
    consumes the edge list, and a dense hub row block can push the tile
    tensor to GBs on large supports. Symmetrically `build_edges=False`
    skips the bucket-padded edge list the block-ELL path never reads.

    `x_inf_factors=(c, s)` (the rank-1 stationary-state factors, see
    `repro_torch.gnn.nai.support_stationary_factors`) additionally emits
    bucket-padded `c_inf` (n_batch,) / `s_inf` (f_pad,) — the fused step
    kernel's streamed operands. Padding rows/columns get factor zero,
    matching the zero-padded dense x_inf.

    `out` is a previously packed result whose buffers may be refilled in
    place: when every bucket-padded operand shape matches (the steady
    state, since the engine's high-water marks make bucket shapes
    sticky), the big arrays are cleared and rewritten instead of
    reallocated, and the returned PackedSupport (== `out`, with
    `reused=True`) owns the same buffers. On any shape mismatch a fresh
    set is allocated. Only the bucket-sized operand arrays are pooled;
    O(S)/O(E) scratch (row maps, the tile unique pass) still allocates.
    Callers overlapping host packing with asynchronous device work must
    rotate >= 2 buffer sets so an in-flight batch's operands are never
    overwritten (see NAIServingEngine).

    `n_shards=D > 1` emits the same operand set in the shard-major
    superblock-permuted row order (see the module docstring): equal
    static shapes per shard, tiles bit-identical to a single-device pack
    of the same geometry, edge arrays stacked (D, e_pad) with local dst
    ids. Explicit buckets must respect the sharded alignment (batch and
    rows multiples of CB*D).

    `halo=True` (sharded packs only) additionally computes each shard's
    halo frame — the sorted union of global CB blocks its rows reference
    — emits the `halo_*` metadata, and rewrites `tile_col` / the segment
    `src` ids into FRAME-local coordinates, so the propagation loop can
    gather H_pad·CB frame rows per step instead of the full S_pad
    frontier. `h_bucket` / `hb_bucket` are hwm floors for the frame and
    send-list pads, same contract as the other buckets.

    `seeds=(hit, vals)` (the propagated-feature-cache path, see
    `repro_torch.gnn.propcache`): `hit` is the per-support-row boolean hit
    mask from the sampler, `vals` the (k_hit, L, F) cached series in
    `nodes[hit]` order. Edges INTO hit rows are dropped before tiling —
    their values are not recomputed but scattered from `seed_vals` after
    every SpMM step — while edges FROM hit rows stay (miss rows still
    read them as sources). Hit rows get hop `_INF_HOP` so row blocks
    that are entirely cache-served are skipped by the step-active mask.
    `k_bucket` is the hwm floor for the seed-row pad, same contract as
    the other buckets. Batch rows must never be marked hit (their series
    is the output)."""
    nb, S = sup.n_batch, len(sup)
    nb_bucket, n_pad, f_pad = pack_rows(nb, S, x0.shape[1],
                                        nb_bucket=nb_bucket,
                                        s_bucket=s_bucket, n_shards=n_shards)

    seeds_on = seeds is not None
    if seeds_on:
        hit_mask, seed_series = seeds
        if hit_mask[:nb].any():
            raise ValueError("batch rows must not be cache hits")
    if seeds_on and hit_mask.any():
        # drop edges INTO hit rows (their values are seeded, not
        # recomputed); edges FROM hit rows stay — miss rows read them
        keep_e = ~hit_mask[sup.dst]
        e_src_l, e_dst_l = sup.src[keep_e], sup.dst[keep_e]
        e_coef = sup.coef[keep_e]
        hop_eff = np.where(hit_mask, _INF_HOP, sup.hop)
    else:
        # no hits: skip the edge-mask copies (an all-True fancy index
        # still copies every edge array — measurable at 0% hit rate);
        # seed operands are still emitted below so shapes stay stable
        e_src_l, e_dst_l, e_coef = sup.src, sup.dst, sup.coef
        hop_eff = sup.hop

    row_of = _remap_rows(sup, nb_bucket)
    src = row_of[e_src_l]
    dst = row_of[e_dst_l]

    # --- tile geometry (needed up front so buffer reuse can be decided
    # before anything is written)
    n_rb, n_cb = n_pad // RB, n_pad // CB
    if n_shards > 1:
        # shard-major permutations at every granularity; tile KEYS stay in
        # original coordinates so slot order (and hence accumulation
        # order) matches the single-device pack exactly
        sb_perm = shard_block_perm(n_cb, n_shards)
        spb = CB // RB
        rb_ids = np.arange(n_rb, dtype=np.int64)
        rb_perm = sb_perm[rb_ids // spb] * spb + rb_ids % spb
        row_perm = shard_row_perm(n_pad, n_shards)
        bat_perm = shard_batch_perm(nb_bucket, n_shards)
        row_dest = row_perm[row_of]
        rows_loc = n_pad // n_shards
    else:
        row_dest = row_of
    halo_on = bool(halo) and n_shards > 1
    if n_shards > 1 and (halo_on or build_edges):
        src_p = row_perm[src]
        dst_p = row_perm[dst]
        e_shard = dst_p // rows_loc

    # --- halo frame geometry (sorted union of global CB blocks each
    # shard's rows reference, grouped by source shard because global
    # block ids are shard-major) — needed before the reuse decision
    if halo_on:
        n_cb_loc = n_cb // n_shards
        key_h = e_shard * n_cb + src_p // CB
        uniq_h = np.unique(key_h)
        h_shard = uniq_h // n_cb           # frame OWNER (destination) shard
        h_block = uniq_h % n_cb            # global packed block id
        h_counts = np.bincount(h_shard, minlength=n_shards)
        h_needed = max(int(h_counts.max()) if len(uniq_h) else 1, 1)
        h_pad = min(max(next_bucket(h_needed), h_bucket or 0), n_cb)
        # all_to_all plan: (source shard, destination shard) send lists
        skey = (h_block // n_cb_loc) * n_shards + h_shard
        s_counts = np.bincount(skey, minlength=n_shards * n_shards)
        s_needed = max(int(s_counts.max()), 1)
        hb_pad = min(max(next_bucket(s_needed), hb_bucket or 0), n_cb_loc)
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
    xi_cols = f_pad if x_inf.shape[1] else 0
    if build_edges:
        if n_shards > 1:
            e_counts = np.bincount(e_shard, minlength=n_shards)
            e_pad = edge_bucket(int(e_counts.max()), e_bucket)
        else:
            e_pad = edge_bucket(len(src), e_bucket)
    else:
        e_pad = 0
    e_shape = ((n_shards, e_pad) if n_shards > 1 and build_edges
               else (e_pad,))

    # --- seed geometry (before the reuse decision, like everything else
    # that sizes a pooled buffer)
    if seeds_on:
        hit_idx = np.flatnonzero(hit_mask)
        seed_len = seed_series.shape[1]
        sd_dest = row_dest[hit_idx]
        if n_shards > 1:
            sd_shard = sd_dest // rows_loc
            sd_counts = np.bincount(sd_shard, minlength=n_shards)
            k_needed = max(int(sd_counts.max()) if len(hit_idx) else 1, 1)
        else:
            k_needed = max(len(hit_idx), 1)
        k_pad = max(next_bucket(k_needed, 1), k_bucket or 0)
        sr_shape = (n_shards, k_pad) if n_shards > 1 else (k_pad,)
        sv_shape = ((n_shards, seed_len, k_pad, f_pad) if n_shards > 1
                    else (seed_len, k_pad, f_pad))

    reuse = (out is not None
             and out.n_shards == n_shards
             and out.tiles.shape == (n_rb, tb, RB, CB)
             and out.x0.shape == (n_pad, f_pad)
             and out.x_inf.shape == (nb_bucket, xi_cols)
             and out.src.shape == e_shape
             and (out.c_inf is not None) == (x_inf_factors is not None)
             and (out.halo_src_shard is not None) == halo_on
             and (not halo_on
                  or (out.halo_src_shard.shape == (n_shards, h_pad)
                      and out.halo_send_block.shape
                      == (n_shards, n_shards, hb_pad)))
             and (out.seed_rows is not None) == seeds_on
             and (not seeds_on
                  or (out.seed_rows.shape == sr_shape
                      and out.seed_vals.shape == sv_shape)))
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
            src=np.full(e_shape, 0, np.int32),
            dst=np.full(e_shape, 0, np.int32),
            coef=np.zeros(e_shape, np.float32),
            c_inf=(np.zeros(nb_bucket, np.float32)
                   if x_inf_factors is not None else None),
            s_inf=(np.zeros(f_pad, np.float32)
                   if x_inf_factors is not None else None),
            n_shards=n_shards,
            halo_src_shard=(np.zeros((n_shards, h_pad), np.int32)
                            if halo_on else None),
            halo_src_block=(np.zeros((n_shards, h_pad), np.int32)
                            if halo_on else None),
            halo_count=(np.zeros(n_shards, np.int32) if halo_on else None),
            halo_send_block=(np.zeros((n_shards, n_shards, hb_pad),
                                      np.int32) if halo_on else None),
            halo_frame_src=(np.zeros((n_shards, h_pad), np.int32)
                            if halo_on else None),
            seed_rows=(np.zeros(sr_shape, np.int32) if seeds_on else None),
            seed_vals=(np.zeros(sv_shape, np.float32)
                       if seeds_on else None))
    p.n_batch, p.nb_real, p.n_pad, p.s_real = nb_bucket, nb, n_pad, S
    p.n_shards = n_shards
    p.reused = reuse

    # --- halo metadata + the global-block -> frame-position lookup used
    # to rewrite tile_col/src below. uniq_h is sorted by (owner shard,
    # global block), so each shard's frame entries are contiguous,
    # ascending, and grouped by source shard — the layout both exchange
    # strategies rely on.
    if halo_on:
        for arr in (p.halo_src_shard, p.halo_src_block, p.halo_count,
                    p.halo_send_block, p.halo_frame_src):
            arr.fill(0)
        first_h = np.concatenate([[0], np.cumsum(h_counts)[:-1]])
        h_slot = np.arange(len(uniq_h), dtype=np.int64) - first_h[h_shard]
        h_src = h_block // n_cb_loc        # source shard of each entry
        p.halo_src_shard[h_shard, h_slot] = h_src.astype(np.int32)
        p.halo_src_block[h_shard, h_slot] = \
            (h_block % n_cb_loc).astype(np.int32)
        p.halo_count[:] = h_counts.astype(np.int32)
        # receive slot: rank within the (owner, source) group — entries
        # of one source are contiguous within a frame, ascending block
        g_key = h_shard * n_shards + h_src
        g_first = np.searchsorted(g_key, np.arange(n_shards * n_shards))
        r_slot = np.arange(len(uniq_h), dtype=np.int64) - g_first[g_key]
        p.halo_frame_src[h_shard, h_slot] = \
            (h_src * hb_pad + r_slot).astype(np.int32)
        # send lists, ascending source-local block per (source, dest)
        # pair — exactly the receive order r_slot encodes
        s_sort = np.argsort(skey, kind="stable")
        sk = skey[s_sort]
        s_first = np.searchsorted(sk, np.arange(n_shards * n_shards))
        s_slot = np.arange(len(uniq_h), dtype=np.int64) - s_first[sk]
        p.halo_send_block[sk // n_shards, sk % n_shards, s_slot] = \
            (h_block % n_cb_loc)[s_sort].astype(np.int32)
        pos_lut = np.zeros((n_shards, n_cb), np.int64)
        pos_lut[h_shard, h_block] = h_slot

    # --- vectorized block-ELL build (cf. repro_torch.kernels.spmm.ops,
    # which loops per tile; this path is a handful of numpy passes)
    if build_tiles:
        # slot of each unique tile within its row block: uniq is sorted,
        # so tiles of one rb are contiguous and column-sorted
        first_of_rb = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(uniq), dtype=np.int64) - first_of_rb[tile_rb]
        if n_shards > 1:
            # same tiles, same slots — only the row-block axis moves to
            # its shard position and column ids map to packed superblocks
            # (or, halo, to the owning shard's frame position: every tile
            # exists because of >= 1 edge, so its (shard, block) pair is
            # always in the frame lookup)
            packed_cb = sb_perm[tile_cb]
            if halo_on:
                t_shard = rb_perm[tile_rb] * RB // rows_loc
                p.tile_col[rb_perm[tile_rb], slot] = \
                    pos_lut[t_shard, packed_cb].astype(np.int32)
            else:
                p.tile_col[rb_perm[tile_rb], slot] = \
                    packed_cb.astype(np.int32)
            p.valid[rb_perm[tile_rb], slot] = 1
            np.add.at(p.tiles, (rb_perm[rb], slot[inverse], dst % RB,
                                src % CB), e_coef)
        else:
            p.tile_col[tile_rb, slot] = tile_cb
            p.valid[tile_rb, slot] = 1
            np.add.at(p.tiles, (rb, slot[inverse], dst % RB, src % CB),
                      e_coef)

    # --- per-row hop -> per-row-block min hop; the (n_pad,) scratch is
    # KB-scale and the vectorized scatter + reshape-min beats a buffered
    # ufunc.at by an order of magnitude on large supports
    hop_row = np.full(n_pad, _INF_HOP, np.int32)
    hop_row[row_dest] = hop_eff
    p.hop_rb[:] = hop_row.reshape(n_rb, RB).min(axis=1)

    p.x0[row_dest, :x0.shape[1]] = np.asarray(x0, np.float32)
    # a zero-column x_inf means the caller only needs the batch-row count
    # (fused path: the kernel streams the rank-1 factors instead)
    if n_shards > 1:
        p.x_inf[bat_perm[:nb], :x_inf.shape[1]] = x_inf
    else:
        p.x_inf[:nb, :x_inf.shape[1]] = x_inf

    if x_inf_factors is not None:
        c, s = x_inf_factors
        p.c_inf.fill(0.0)
        if n_shards > 1:
            p.c_inf[bat_perm[:nb]] = np.asarray(c, np.float32)
        else:
            p.c_inf[:nb] = np.asarray(c, np.float32)
        p.s_inf.fill(0.0)
        p.s_inf[:len(s)] = np.asarray(s, np.float32)

    # bucket-padded edge list (segment-sum path): pad with zero-coef
    # self-edges on the last (always padding or hop-max) row
    if build_edges:
        if n_shards > 1:
            # halo: src addresses the shard's frame rows, not the global
            # frontier; padding edges point at the frame's last (padding)
            # row with coef 0
            if halo_on:
                src_x = pos_lut[e_shard, src_p // CB] * CB + src_p % CB
                src_fill = h_pad * CB - 1
            else:
                src_x = src_p
                src_fill = n_pad - 1
            p.src.fill(src_fill)
            p.dst.fill(rows_loc - 1)
            p.coef.fill(0.0)
            # per-shard slices keep the ORIGINAL edge order (all of one
            # row's contributions live in one shard), so segment-sum
            # accumulates each row in the single-device order
            for sh in range(n_shards):
                m = e_shard == sh
                k = int(e_counts[sh])
                p.src[sh, :k] = src_x[m].astype(np.int32)
                p.dst[sh, :k] = (dst_p[m] - sh * rows_loc).astype(np.int32)
                p.coef[sh, :k] = e_coef[m]
        else:
            p.src.fill(n_pad - 1)
            p.dst.fill(n_pad - 1)
            p.coef.fill(0.0)
            p.src[:len(src)] = src
            p.dst[:len(dst)] = dst
            p.coef[:len(e_coef)] = e_coef

    # --- cache-seed operands: padded row ids of hit rows + their series,
    # padded to k_pad (pad ids point one past the [local] row range — the
    # NAP loop's seed write ignores them)
    if seeds_on:
        fh = seed_series.shape[2]
        if n_shards > 1:
            p.seed_rows.fill(rows_loc)
            p.seed_vals.fill(0.0)
            for sh in range(n_shards):
                m = sd_shard == sh
                k = int(sd_counts[sh])
                p.seed_rows[sh, :k] = \
                    (sd_dest[m] - sh * rows_loc).astype(np.int32)
                p.seed_vals[sh, :, :k, :fh] = \
                    seed_series[m].transpose(1, 0, 2)
        else:
            p.seed_rows.fill(n_pad)
            p.seed_vals.fill(0.0)
            p.seed_rows[:len(sd_dest)] = sd_dest.astype(np.int32)
            p.seed_vals[:, :len(sd_dest), :fh] = \
                seed_series.transpose(1, 0, 2)
    return p


def step_active_blocks(hop_rb: np.ndarray, t_max: int) -> np.ndarray:
    """(t_max, n_rb) int32: row blocks whose X^(l) value can still reach a
    batch output at step l = 1..t_max (hop <= T_max - l). Row 0 of the
    result is step l=1."""
    ls = np.arange(1, t_max + 1, dtype=np.int64)[:, None]
    return (hop_rb[None, :] <= t_max - ls).astype(np.int32)
