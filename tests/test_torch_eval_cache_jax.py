"""Three-set scored evaluation with the eval cache on in the port against
the JAX package's ``evaluate`` (its own cache on, its default):
hypotheses per set and the seven scores ``==``, for base-soft,
depth-soft, nic and base-hard (the JAX package's per-set region noise
replayed through ``att_noise``, ``tests/test_torch_mdepth.py``'s
``jax_eval_noise``). The port's cache off == on:
``tests/test_torch_eval_cache.py``, whose sets and set-up these are.
"""

import jax
import pytest

from depth_image_captioning_pub_tpu import cli as jcli
from depth_image_captioning_pub_tpu.engine import evaluate as jeval

from test_torch_eval_cache import (
    SETS, hard_sets, port_eval, tables)
from test_torch_evaluate import (
    HW, _cfgs, _jax_cap, _Recorder, coco_dir, dataset, experiments,
    tiny_dpt)
from test_torch_mdepth import jax_eval_noise
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

__all__ = ["coco_dir", "dataset", "experiments", "hard_sets", "tiny_dpt"]


@pytest.mark.parametrize("kind", ["base-soft", "depth-soft", "nic",
                                  "base-hard"])
def test_three_cached_sets_equal_jax(kind, coco_dir, dataset, experiments,
                                     tiny_dpt, hard_sets, monkeypatch):
    root, _, _, w2i, i2w = coco_dir
    jcfg, tcfg = _cfgs(root)
    save_dir, files = tables(tcfg, kind)
    jcap = (experiments[kind][0] if kind in experiments
            else _jax_cap(kind, w2i))
    jrec = _Recorder(jeval.load_textfiles)
    monkeypatch.setattr(jeval, "load_textfiles", jrec)
    jdepth = dict(depth_fn=tiny_dpt[0], dpt_variables=tiny_dpt[1]) \
        if kind == "depth-soft" else {}
    want = jeval.evaluate(
        kind, "coco", jcap,
        lambda i: jcli.load_eval_components(save_dir, files[SETS[i - 1]],
                                            jcap, image_hw=(HW, HW)),
        dataset, w2i, i2w, jcfg, num_sets=3, quiet=True, **jdepth)
    noise = {"att_noise": jax_eval_noise} if kind == "base-hard" else {}
    on = port_eval(kind, coco_dir, dataset, tiny_dpt, **noise)
    assert len(jrec.hypos) == 3
    assert on[1] == jrec.hypos and on[0] == want
    assert on[2].encoder == 2
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(on[0])
