"""Plain depth CNN of the depth captioner (the reference repository's
``Depth_Encoder``): three convs, each followed by BatchNorm and ReLU, two
3x3 max-pools, then the 7x7 map pooled to the 14x14 annotation grid.

224 -(7x7 s3 valid)-> 73 -(max 3)-> 24 -(3x3)-> 22 -(max 3)-> 7 -(1x1)-> 7
-> 14. BatchNorm at inference: on the running statistics (eps 1e-5).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reference.ops import F32, Rounding

PREFIX = "depth_module."


def _bn(x, w, p):
    return F.batch_norm(x, w[p + ".running_mean"].to(F32),
                        w[p + ".running_var"].to(F32), w[p + ".weight"],
                        w[p + ".bias"], False, 0.0, 1e-5)


def depth_features(w: Dict[str, torch.Tensor], maps: torch.Tensor,
                   grid: int = 14, r: Rounding = Rounding()) -> torch.Tensor:
    """Depth maps [B, 224, 224, 1] -> [B, grid*grid, C]. ``w`` holds the
    weights under ``depth_module.``."""
    g = {k[len(PREFIX):]: v for k, v in w.items() if k.startswith(PREFIX)}
    x = maps.to(F32).permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        conv = f"conv{i}"
        x = F.conv2d(r(x), r(g[conv + ".weight"]), r(g[conv + ".bias"]),
                     3 if i == 1 else 1)
        x = F.relu(_bn(r(x), g, f"bn{i}"))
        if i < 3:
            x = F.max_pool2d(x, 3)
    x = F.adaptive_avg_pool2d(x, grid)
    return x.flatten(2).transpose(1, 2)
