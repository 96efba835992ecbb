"""Packing per batch, closed loop: the engine's span `serve.host.pack`
(`batch_timings[*]["pack_s"]`: `pack_support` into the pinned pool, the
pinning of a new buffer set, the bucket high-water marks, the shape key
and the tile backends' step predicate), averaged over the window's
batches, in ms."""
from bench.metrics._stages import mean

UNIT = "ms"
LAYER = "host stage: packing"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean(ctx, "pack_s", 1e3)
