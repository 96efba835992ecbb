"""The heads' share of the chip's float32 peak: the counted operations of
classifying each node of the window once, by the head of its exit order
at its real widths (`ctx.needs["head_flops"]`, the head module's
`macs`), over the device time of the program's `serve.heads` range times
67 TFLOP/s, in %. The engine runs float32 with TF32 off. Operations set
the heads' bound at published widths: GAMLP's heads on Flickr need about
3.8 GFLOP a batch of 500 (57 us at the peak) against about 33 MB of
weights and rows (10 us at 3.35 TB/s). Work the program does beyond the
count (every head on every padded row) lowers the share. None where the
program has no such range."""
UNIT = "%"
LAYER = "heads"
MOVES = "nodes_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.n_batches == 0:
        return None
    s = ctx.trace.span_device_s.get("serve.heads")
    if not s:
        return None
    return 100.0 * ctx.needs["head_flops"] / (s * ctx.peak["f32_flops"])
