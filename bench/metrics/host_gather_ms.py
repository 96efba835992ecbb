"""Feature gather per batch, closed loop: the engine's span
`serve.host.gather` (`batch_timings[*]["gather_s"]`: the store's
`gather_features` of the support rows and their cast to float32),
averaged over the window's batches, in ms."""
from bench.metrics._stages import mean

UNIT = "ms"
LAYER = "host stage: feature gather"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean(ctx, "gather_s", 1e3)
