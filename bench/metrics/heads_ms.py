"""Device time of the heads per served batch: the device events launched
inside the program's `serve.heads` range (`run_propagation`'s per-order
classification, every head f^(1..t_max) on the batch's rows, the argmax
and the pick by exit order), by the trace's `span_device_s`, over the
window's batches, in ms. None where the program has no such range."""
UNIT = "ms"
LAYER = "heads"
MOVES = "nodes_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.n_batches == 0:
        return None
    s = ctx.trace.span_device_s.get("serve.heads")
    return 1e3 * s / ctx.n_batches if s else None
