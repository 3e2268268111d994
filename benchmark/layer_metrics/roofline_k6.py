"""K6 (the DPT backbone's GroupNorm, ``dcap::gn::stats_kernel`` and
``dcap::gn::apply_kernel``): the least time of its launches in the traced
window (``counts.kernels.group_norm``: x read once, y written once, the
residual read once, over the GroupNorms of one forward that the depth
model's count file lists (``group_norms``), at each chunk's rows), over
the two kernels' device time."""

from counts import kernels
from dcbench.program import DTYPES

KERNELS = ("dcap::gn::stats_kernel", "dcap::gn::apply_kernel")


def read(ctx):
    dpt = ctx.cell.dpt
    norms = getattr(dpt.counts, "group_norms", None) if dpt else None
    if norms is None or ctx.trace is None:
        return None
    ops = [op for k in KERNELS for op in ctx.trace.ops_named(k)]
    chunks = ctx.counts.get("chunk_steps") or []
    cfg = ctx.cell.config["dpt"]
    shapes = norms(cfg)
    if not ops or len(ops) != 2 * len(shapes) * len(chunks):
        return None
    size = DTYPES[cfg["dtype"]].itemsize
    least = sum(kernels.group_norm_seconds(len(rows), side * side, c, res,
                                           size)
                for rows in chunks for side, c, res in shapes)
    return 100.0 * least / (sum(e - s for _, s, e, _ in ops) / 1e9)
