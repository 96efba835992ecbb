"""Stationary factors per batch, closed loop: the engine's span
`serve.host.factors` (`batch_timings[*]["factors_s"]`:
`support_stationary_factors`, their float32 casts and the dense x_inf
where the backend takes it), averaged over the window's batches, in ms."""
from bench.metrics._stages import mean

UNIT = "ms"
LAYER = "host stage: stationary factors"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean(ctx, "factors_s", 1e3)
