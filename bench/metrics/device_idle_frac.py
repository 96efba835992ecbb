"""Share of the traced window in which nothing ran on the card: 1 - the
union of the device events' intervals over the window's length."""
UNIT = "frac"
LAYER = "device"
MOVES = "nodes_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
