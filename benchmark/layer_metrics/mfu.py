"""Model FLOP utilization of captioning: the operations of the captions
completed in the untraced window of a traced run
(``counts.models.caption``: the frozen stages, the depth CNN and the
decode steps each caption ran, padding rows left out), over the time
from its first request's start to its last one's end, over the card's
dense bfloat16 peak."""

from counts import BF16_FLOPS


def read(ctx):
    plain = ctx.plain or {}
    if not plain.get("model_flops") or not plain.get("work_s"):
        return None
    return 100.0 * plain["model_flops"] / plain["work_s"] / BF16_FLOPS
