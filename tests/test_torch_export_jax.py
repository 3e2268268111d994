"""The port's artifact == the JAX package's, on the CPU: one base-soft
captioner's weights (the JAX init, f32 encoders in both packages, bridged
with ``params_from_jax``) exported by each package's ``export_pipeline``
and loaded by each ``ExportedPipeline``: equal captions, equal to both
live pipelines' (ResNet blocks 1,1,1,1 on 64x64 images, ``max_length``
8, buckets 2 and 4, three images, so one is padded). Greedy decode: the
JAX artifact's stochastic programs draw from a JAX key, which the port's
generator does not reproduce (``tests/test_torch_sampling.py`` replays
JAX draws through the live decoders instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from depth_image_captioning_pub_tpu import export as jexport
from depth_image_captioning_pub_tpu.models import captioner as jcaptioner
from depth_image_captioning_pub_tpu.pipeline import (
    CaptionPipeline as JCaptionPipeline)
from depth_image_captioning_pub_torch import export as texport
from depth_image_captioning_pub_torch.config import ConfigEval
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
from depth_image_captioning_pub_torch.utils.jax_bridge import params_from_jax

from test_torch_evaluate import _np_tree, _scale_kernels
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAYERS, HW, MAX_LEN = (1, 1, 1, 1), 64, 8


def _vocab():
    w2i = {f"w{i}": i for i in range(16)}
    w2i.update({"<start>": 16, "<end>": 17, "<unk>": 18, "<null>": 19})
    return w2i, {i: w for w, i in w2i.items()}


def test_port_artifact_equals_jax_artifact(tmp_path):
    w2i, i2w = _vocab()
    jcap = jcaptioner.build_captioner("base-soft", len(w2i), ConfigEval(),
                                      encoder_dtype=jnp.float32,
                                      resnet_layers=LAYERS)
    params, frozen, stats = (_np_tree(t) for t in jcap.init(
        jax.random.PRNGKey(0), image_hw=(HW, HW)))
    frozen = {"encoder": _scale_kernels(frozen["encoder"], 3.0)}
    kw = dict(max_length=MAX_LEN, batch_buckets=(2, 4), image_hw=(HW, HW))
    jpipe = JCaptionPipeline(jcap, params, frozen, stats, w2i, i2w,
                             devices=[jax.devices()[0]], **kw)
    tcap = build_captioner("base-soft", len(w2i), ConfigEval(),
                           encoder_dtype=torch.float32, resnet_layers=LAYERS,
                           device="cpu")
    params_from_jax(tcap, params, frozen, stats)
    tpipe = CaptionPipeline(tcap, w2i, i2w, **kw)
    imgs = list(np.random.default_rng(0).integers(
        0, 255, (3, HW, HW, 3), dtype=np.uint8))

    jexport.export_pipeline(jpipe, str(tmp_path / "jax"))
    texport.export_pipeline(tpipe, str(tmp_path / "port"))
    want = jexport.ExportedPipeline.load(str(tmp_path / "jax"))(imgs)
    got = texport.ExportedPipeline.load(str(tmp_path / "port"))(imgs)
    assert got == want == jpipe(imgs) == tpipe(imgs)
    assert len(set(want)) > 1
