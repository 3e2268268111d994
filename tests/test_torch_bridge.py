"""The port's reference-checkpoint bridge == the JAX package's, on the CPU.

* ``utils/torch_bridge``: each of the nine functions (``load_state_dict``
  and the eight converters) gives the JAX bridge's tree leaf for leaf
  (``array_equal``, same dtype) on the same state dicts, taken from the
  reference-layout torch twins of the JAX tests (``TorchTinyResNet``,
  ``TorchSoftDecoder``, ``TorchNICDecoder``, ``_make_tiny_sd``) and from
  a depth CNN / depth MLP twin with the reference's names: torchvision
  and ``backbone.N.`` Sequential names, the Omnidata ``{"state_dict"}``
  layout with its ``model.`` prefix, and a file that needs the full
  unpickler (``weights_only`` refuses it).
* ``utils.convert`` writes the JAX convert's bytes for every kind.
* ``chip_smoke.py``'s inverse maps (the reference-layout files that its
  phase 25 writes) give the twins' key sets, and the bridge turns them
  back into the trees they came from.
"""

import argparse
import functools

import numpy as np
import pytest
import jax
import torch
import torch.nn as nn

import chip_smoke
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.utils import convert as jconvert
from depth_image_captioning_pub_tpu.utils import torch_bridge as jtb
from depth_image_captioning_pub_torch.models.dpt import TINY_DPT
from depth_image_captioning_pub_torch.utils import convert as tconvert
from depth_image_captioning_pub_torch.utils import torch_bridge as ttb
from depth_image_captioning_pub_torch.utils.jax_bridge import flatten_tree

from test_bridge_numeric import TorchTinyResNet, _randomize_bn_stats
from test_dpt import _make_tiny_sd
from test_token_parity import TorchNICDecoder, TorchSoftDecoder
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

TINY = (1, 1, 1, 1)
DPT_TINY = dict(resnet_layers=(1, 1, 1), vit_blocks=3)


class TorchDepthCNN(nn.Module):
    """The reference depth CNN's names (Depth_CNN_endoder)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 128, 7, stride=3)
        self.bn1 = nn.BatchNorm2d(128)
        self.conv2 = nn.Conv2d(128, 512, 3)
        self.bn2 = nn.BatchNorm2d(512)
        self.conv3 = nn.Conv2d(512, 2048, 1)
        self.bn3 = nn.BatchNorm2d(2048)


class TorchDepthMLP(nn.Module):
    """The reference depth MLP's names (Depth_MLP_endoder)."""

    def __init__(self):
        super().__init__()
        self.l1, self.l2, self.l3 = (nn.Linear(256, 128), nn.Linear(128, 64),
                                     nn.Linear(64, 32))


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _resnet_sd(seed=0, sequential=False):
    torch.manual_seed(seed)
    net = TorchTinyResNet().eval()
    _randomize_bn_stats(net, np.random.default_rng(seed))
    sd = _sd(net)
    if sequential:
        sd = {f"backbone.{chip_smoke.REF_SEQ[k.split('.', 1)[0]]}."
              f"{k.split('.', 1)[1]}": v for k, v in sd.items()}
    return sd


@functools.lru_cache(maxsize=None)
def _dpt_shapes():
    model = jdpt.DPTDepthModel(**TINY_DPT)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jax.numpy.zeros((1, 64, 64, 3)))


def _dpt_sd(seed=0):
    return _make_tiny_sd(_dpt_shapes(), seed=seed)


def _nic_encoder_sd():
    sd = _resnet_sd(3, sequential=True)
    torch.manual_seed(3)
    lin = nn.Linear(2048, 300)
    sd["linear.weight"] = lin.weight.detach().numpy()
    sd["linear.bias"] = lin.bias.detach().numpy()
    return sd


# name -> (state dict maker, the converter applied to a bridge module)
CONVERTERS = {
    "resnet_to_flax": (_resnet_sd, lambda b, sd: b.resnet_to_flax(sd, TINY)),
    "resnet_to_flax-sequential": (
        lambda: _resnet_sd(1, sequential=True),
        lambda b, sd: b.resnet_to_flax(sd, TINY)),
    "encoder_to_flax": (_resnet_sd,
                        lambda b, sd: b.encoder_to_flax(sd, TINY)),
    "encoder_to_flax-sequential": (
        lambda: _resnet_sd(2, sequential=True),
        lambda b, sd: b.encoder_to_flax(sd, TINY)),
    "attention_decoder_to_flax": (
        lambda: _sd(TorchSoftDecoder(d_enc=2048)),
        lambda b, sd: b.attention_decoder_to_flax(sd)),
    "nic_decoder_to_flax": (lambda: _sd(TorchNICDecoder()),
                            lambda b, sd: b.nic_decoder_to_flax(sd)),
    "nic_encoder_linear_to_flax": (
        _nic_encoder_sd, lambda b, sd: b.nic_encoder_linear_to_flax(sd)),
    "depth_cnn_to_flax": (lambda: _sd(TorchDepthCNN()),
                          lambda b, sd: b.depth_cnn_to_flax(sd)),
    "depth_mlp_to_flax": (lambda: _sd(TorchDepthMLP()),
                          lambda b, sd: b.depth_mlp_to_flax(sd)),
    "dpt_to_flax": (_dpt_sd, lambda b, sd: b.dpt_to_flax(sd, **DPT_TINY)),
}


def assert_trees_equal(got, want):
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert list(fg) == list(fw)
    for k, w in fw.items():
        g = fg[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_equals_jax(name):
    make, convert = CONVERTERS[name]
    torch.manual_seed(0)
    sd = make()
    assert_trees_equal(convert(ttb, sd), convert(jtb, sd))


def test_canonical_resnet_keys_equal_jax():
    for sd in (_resnet_sd(), _resnet_sd(sequential=True), _nic_encoder_sd(),
               {"fc.weight": np.zeros(3, np.float32)}):
        got, want = (ttb._canonicalize_resnet_keys(sd),
                     jtb._canonicalize_resnet_keys(sd))
        assert list(got) == list(want)
        assert all(got[k] is want[k] for k in got)
    # avgpool (backbone.8) and torchvision's fc carry nothing the bridge reads
    sd = _resnet_sd(sequential=True)
    sd["backbone.8.dummy"] = np.zeros(1, np.float32)
    assert "backbone.8.dummy" not in ttb._canonicalize_resnet_keys(sd)


def _save(path, obj):
    torch.save(obj, path)
    return str(path)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


LAYOUTS = {
    # a plain state dict (the reference's per-run .pth files)
    "plain": lambda sd: _tensors(sd),
    # Omnidata's Lightning checkpoint: keys behind "model.", other entries
    # beside them, a pickled object that weights_only refuses
    "omnidata": lambda sd: {
        "state_dict": {"model." + k: v for k, v in _tensors(sd).items()},
        "epoch": 7, "hyper_parameters": argparse.Namespace(lr=1e-4)},
    "omnidata-tensors-only": lambda sd: {
        "state_dict": {"model." + k: v for k, v in _tensors(sd).items()}},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_state_dict_equals_jax(layout, tmp_path):
    sd = _dpt_sd(seed=4) if layout.startswith("omnidata") else _resnet_sd()
    path = _save(tmp_path / "x.ckpt", LAYOUTS[layout](sd))
    if layout == "omnidata":
        with pytest.raises(Exception):
            torch.load(path, map_location="cpu", weights_only=True)
    got, want = ttb.load_state_dict(path), jtb.load_state_dict(path)
    assert list(got) == list(want) == list(sd)
    for k in sd:
        assert isinstance(got[k], np.ndarray)
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
        assert np.array_equal(got[k], sd[k])


# kind -> (state dict maker, the tiny model's converter arguments)
KINDS = {"resnet152": (_resnet_sd, {"encoder_to_flax": {"layers": TINY}}),
         "dpt": (_dpt_sd, {"dpt_to_flax": DPT_TINY}),
         "decoder": (lambda: _sd(TorchSoftDecoder(d_enc=2048)), {}),
         "nic-decoder": (lambda: _sd(TorchNICDecoder()), {}),
         "depth-cnn": (lambda: _sd(TorchDepthCNN()), {}),
         "depth-mlp": (lambda: _sd(TorchDepthMLP()), {})}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_convert_writes_the_jax_bytes(kind, tmp_path, monkeypatch, capsys):
    make, tiny = KINDS[kind]
    for bridge in (ttb, jtb):     # the tiny twins' stage and block counts
        for fn, kw in tiny.items():
            monkeypatch.setattr(bridge, fn,
                                functools.partial(getattr(bridge, fn), **kw))
    torch.manual_seed(5)
    src = _save(tmp_path / "src.pth", _tensors(make()))
    tconvert.main(["--kind", kind, "--src", src,
                   "--out", str(tmp_path / "port.msgpack")])
    jconvert.main(["--kind", kind, "--src", src,
                   "--out", str(tmp_path / "jax")])
    assert f"wrote {tmp_path / 'port.msgpack'}" in capsys.readouterr().out
    port = (tmp_path / "port.msgpack").read_bytes()
    assert len(port) > 1000 and port == (tmp_path / "jax.msgpack").read_bytes()


def test_convert_rejects_unknown_kind():
    with pytest.raises(SystemExit):
        tconvert.main(["--kind", "warp", "--src", "x", "--out", "y"])


def _sorted_keys(sd):
    return sorted(k for k in sd if not k.endswith("num_batches_tracked"))


def test_smoke_inverse_maps_write_the_reference_layout():
    """The keys of the files phase 25 writes are the twins' keys, and the
    bridge reads them back to the trees they were made from."""
    resnet = jtb.resnet_to_flax(_resnet_sd(), TINY)
    sd = chip_smoke.ref_resnet(resnet)
    assert sorted(sd) == sorted(list(_resnet_sd()) + ["fc.weight",
                                                      "fc.bias"])
    assert_trees_equal(ttb.resnet_to_flax(sd, TINY), resnet)
    enc = jtb.encoder_to_flax(_resnet_sd(1), TINY)
    sd = chip_smoke.ref_encoder(enc)
    assert sorted(sd) == sorted(_resnet_sd(sequential=True))
    assert_trees_equal(ttb.encoder_to_flax(sd, TINY), enc)
    nic = _nic_encoder_sd()
    sd = chip_smoke.ref_nic_encoder(jtb.resnet_to_flax(nic, TINY),
                                    jtb.nic_encoder_linear_to_flax(nic))
    assert sorted(sd) == sorted(nic)
    assert all(np.array_equal(sd[k], nic[k]) for k in nic)
    for twin, to_flax, inverse in (
            (TorchSoftDecoder(d_enc=2048), jtb.attention_decoder_to_flax,
             chip_smoke.ref_decoder),
            (TorchNICDecoder(), jtb.nic_decoder_to_flax,
             chip_smoke.ref_nic_decoder),
            (TorchDepthMLP(), jtb.depth_mlp_to_flax,
             chip_smoke.ref_depth_mlp)):
        want = _sd(twin)
        got = inverse(to_flax(want))
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    want = _sd(TorchDepthCNN())
    bundle = jtb.depth_cnn_to_flax(want)
    got = chip_smoke.ref_depth_cnn(bundle["params"], bundle["batch_stats"])
    assert _sorted_keys(got) == _sorted_keys(want)
    assert all(np.array_equal(got[k], want[k]) for k in _sorted_keys(want))
    want = _dpt_sd(seed=6)
    got = chip_smoke.ref_dpt(jtb.dpt_to_flax(want, **DPT_TINY)["params"])
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
