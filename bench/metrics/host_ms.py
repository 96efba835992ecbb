"""Host stage per batch, closed loop: the engine's own span `host_s`
(sampling, feature gather, stationary factors and packing into the pinned
pool), averaged over the window's batches, in ms."""
UNIT = "ms"
LAYER = "host stage"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    t = [b["host_s"] for b in ctx.batch_timings]
    return 1e3 * sum(t) / len(t) if t else None
