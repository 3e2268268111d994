"""Device milliseconds of the RGB encoder a chunk: the operations launched
inside its forward (the ``rgb_encoder`` span), over the forwards."""


def read(ctx):
    n = ctx.trace.span_count("rgb_encoder") if ctx.trace else 0
    ops = ctx.trace.span_ops("rgb_encoder") if n else []
    if not ops:
        return None
    return sum(e - s for _, s, e, _ in ops) / 1e6 / n
