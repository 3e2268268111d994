"""K2 (the greedy decode kernel, ``greedy_tiled_kernel``): the least time
of its launches in the traced window (``counts.kernels.greedy_decode``:
each chunk's rows at the steps they ran to their first <end>), over the
kernel's device time."""

from counts import kernels, models

KERNEL = "greedy_tiled_kernel"


def read(ctx):
    ops = ctx.trace.ops_named(KERNEL) if ctx.trace else []
    chunks = ctx.counts.get("chunk_steps") or []
    if not ops or len(ops) != len(chunks):
        return None
    z = models.sizes(ctx.cell.config)
    least = sum(kernels.greedy_decode_seconds(
        rows, length=ctx.cell.config["max_length"], **z) for rows in chunks)
    return 100.0 * least / (sum(e - s for _, s, e, _ in ops) / 1e9)
