"""Device time of the operands' host-to-device copies (`Memcpy HtoD`,
pinned pool, copy stream) per served batch of the traced window, in ms."""
UNIT = "ms"
LAYER = "device stage copy"
MOVES = "nodes_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.n_batches == 0:
        return None
    return 1e3 * ctx.trace.htod_s / ctx.n_batches
