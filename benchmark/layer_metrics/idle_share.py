"""Share of the traced window in which the device runs no operation:
1 - (the union of the device operations' intervals) / (the window), as
the result line's ``busy_s`` and ``window_s`` give it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * (1.0 - ctx.trace.busy_ns() / (hi - lo))
