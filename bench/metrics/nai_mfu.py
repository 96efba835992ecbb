"""The whole served step's share of the chip's float32 peak: the counted
operations of every batch of the window (the needed propagation steps,
the exit distances, each node's head at its exit order) over the window's
seconds times 67 TFLOP/s, in %. The engine runs float32 with TF32 off."""
UNIT = "%"
LAYER = "whole served step"
MOVES = "nodes_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.window_s <= 0 or ctx.n_batches == 0:
        return None
    flops = ctx.needs["step_flops"] + ctx.needs["head_flops"]
    return 100.0 * flops / (ctx.window_s * ctx.peak["f32_flops"])
