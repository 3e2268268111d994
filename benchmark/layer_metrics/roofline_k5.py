"""K5 (the DPT's attention kernel, ``attention_bf16_kernel``): the least
time of its launches in the traced window (``counts.kernels.
vit_attention``: Z = chunk x heads rows of N tokens of width d, one
launch a ViT block a chunk), over the kernel's device time."""

from counts import kernels

KERNEL = "attention_bf16_kernel"


def read(ctx):
    ops = ctx.trace.ops_named(KERNEL) if ctx.trace else []
    chunks = ctx.counts.get("chunk_steps") or []
    dpt = ctx.cell.config.get("dpt")
    if not ops or dpt is None or len(ops) != len(chunks) * dpt["vit_blocks"]:
        return None
    n = 1 + (dpt["image_size"] // dpt["patch"]) ** 2
    d = dpt["vit_dim"] // dpt["vit_heads"]
    least = dpt["vit_blocks"] * sum(kernels.vit_attention_seconds(
        len(rows) * dpt["vit_heads"], n, d) for rows in chunks)
    return 100.0 * least / (sum(e - s for _, s, e, _ in ops) / 1e9)
