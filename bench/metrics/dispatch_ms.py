"""Device stage per batch on the host, closed loop: the engine's span
`serve.dispatch` (`batch_timings[*]["dispatch_s"]`: staging the operands,
issuing their copies, launching the loop's and the heads' kernels and
the results' copy back, without waiting for the card), averaged over the
window's batches, in ms."""
from bench.metrics._stages import mean

UNIT = "ms"
LAYER = "device stage, host side"
MOVES = "nodes_per_s"
SOURCE = "program_span"


def read(ctx):
    return mean(ctx, "dispatch_s", 1e3)
