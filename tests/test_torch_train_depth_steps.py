"""One AdamW train step and one eval step of depth-soft, depth-hard,
mdepth-soft and mdepth-hard, and a 4-step trajectory with dropout on for
depth-soft: the port's ``engine/steps.py`` == the JAX package's jitted
steps, at the bounds and on the set-up of ``tests/test_torch_train_steps.py``
(whose helpers this file shares). The depth CNN runs in f32 on both sides
(bf16 convs round differently in the two frameworks), its BatchNorms on
the batch's statistics, pad row included, and the new running statistics
are held to 1e-5.

The depth-soft trajectory is held to looser bounds than the one-step
checks, for a measured reason. The depth CNN's gradients carry
the f32 convs' rounding at up to ~3e-2 of their max (``DEPTH_SMALL``), and
AdamW turns that rounding into whole steps of lr on the small elements, so
the two packages' trajectories part by a few steps of lr: after four
steps at lr 1e-3 the largest leaf difference is 4.2e-3 (conv2's kernel;
4.4e-4 at lr 1e-4: it scales with lr, not with the rounding), the BN
running means differ by 8e-3 of their largest value, and the loss by 0,
1.0e-5, 2.9e-5 and 5.3e-5 at the four steps (all measured on a CPU;
base-soft and NIC drift below 1e-6 in the loss). Held: the per-step loss
at rtol/atol 2e-5, every leaf within 2 * lr * 4 steps, the statistics
within 2e-2 of their largest value.
"""

import pytest

from test_torch_train_steps import check_one_step, check_trajectory, twin
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("kind", ["depth-soft", "depth-hard",
                                  "mdepth-soft", "mdepth-hard"])
def test_depth_train_and_eval_step_match_jax(kind):
    check_one_step(twin(kind))


def test_depth_soft_four_step_trajectory_matches_jax():
    check_trajectory(twin("depth-soft"), loss_tol=2e-5, stats_rtol=2e-2)
