"""The engine's per-batch stage record (`batch_timings`), averaged over
the window's batches for the readers of its spans and counters."""


def mean(ctx, key: str, scale: float = 1.0):
    """`scale` times the mean of `key` over the window's batches; None in
    a run without the card's trace (a CPU dry run), where a batch lacks
    the key (a program without that span or counter), or where the
    window's total is 0."""
    vals = [b.get(key) for b in ctx.batch_timings]
    if ctx.trace is None or not vals or None in vals:
        return None
    total = sum(vals)
    return scale * total / len(vals) if total > 0 else None
