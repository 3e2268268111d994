"""Device milliseconds of the DPT a chunk: the operations launched
inside its forward (the ``dpt`` span), over the forwards."""


def read(ctx):
    n = ctx.trace.span_count("dpt") if ctx.trace else 0
    ops = ctx.trace.span_ops("dpt") if n else []
    if not ops:
        return None
    return sum(e - s for _, s, e, _ in ops) / 1e6 / n
