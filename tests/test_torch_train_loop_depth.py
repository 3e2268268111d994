"""The trainer end to end on depth-soft: the port's ``engine/train.train``
== the JAX package's ``train``, on the set-up of
``tests/test_torch_train_loop.py`` (whose helpers this file shares), with
a depth provider made here (each image's gray levels, nearest-upsampled
to 224x224) for training and validation. The depth CNN trains its
BatchNorms on the batch's statistics. Held, as the depth-soft trajectory
of ``tests/test_torch_train_depth_steps.py`` is (the depth CNN's
Adam-amplified rounding parts the two packages' parameters by a few steps
of lr): the per-epoch train and val losses within rtol/atol 2e-5 (the
second epoch's val loss measured 1.26e-5 apart on a CPU); the same
best-val file names; the frozen encoder's leaves bit for bit; the trained
leaves within 2 * lr * steps of the JAX files'; the BN running statistics
within 5e-2 of their largest value (bn2's mean measured 2.15e-2 apart on
a CPU: four steps of conv kernels parted by up to lr move the batch means
they average); both packages' ``load_eval_components`` read the port's
set.
"""

import numpy as np

from test_torch_train_loop import (
    HW, check_loaders, check_run, coco, run_both)  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def depth_provider(images, indices):
    """Each image's gray levels, nearest-upsampled to 224x224 (at 64x64
    the CNN's last BN would average one position per row)."""
    gray = np.asarray(images, np.float32).mean(axis=-1) / 255.0
    idx = (np.arange(224) * HW) // 224
    return gray[:, idx][:, :, idx][..., None]


def test_train_depth_soft_matches_jax(coco, tmp_path, monkeypatch):
    jcfg, tcfg, jcap, spy = run_both("depth-soft", coco, tmp_path,
                                     monkeypatch, depth_provider)
    tdir = check_run("depth-soft", jcfg, tcfg, spy, within_steps=(
        None, 5e-2), loss_tol=2e-5)
    check_loaders("depth-soft", tdir, jcfg, jcap, coco[1])
