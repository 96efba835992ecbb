"""The NAP loop's share of its roofline: the least time its steps need on
this chip (bench.metrics._counting: each step's needed edges and rows,
over the f32 and HBM peaks; the bytes set it) over the device time the
loop's kernels took in the traced window, in %."""
UNIT = "%"
LAYER = "propagation"
MOVES = "nodes_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.trace.loop_s <= 0:
        return None
    return 100.0 * ctx.needs["step_roofline_s"] / ctx.trace.loop_s
