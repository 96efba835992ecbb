"""Sampling per batch, closed loop: the engine's span `serve.host.sample`
(`batch_timings[*]["sample_s"]`: `sample_support`, the batch's t_max-hop
support and its edges), averaged over the window's batches, in ms."""
from bench.metrics._stages import mean

UNIT = "ms"
LAYER = "host stage: sampling"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean(ctx, "sample_s", 1e3)
