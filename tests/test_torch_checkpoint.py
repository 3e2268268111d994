"""The port's checkpoint files == the JAX package's, on the CPU.

* ``utils/msgpack_codec`` against the ``msgpack`` package on every wire
  form it reads and writes (both directions byte for byte), and against
  ``flax.serialization`` on the files the JAX ``save_component`` writes:
  plain, chunked (``MAX_CHUNK_SIZE`` made small inside the test) and with
  a bfloat16 leaf. Leaves must be equal in dtype, shape and bytes; the
  port's files must read back through flax the same way, and are
  byte-identical to the JAX package's for the same tree.
* ``params_to_jax`` inverts ``params_from_jax`` for nic, base-soft and
  depth-soft: exactly for an f32 captioner; for the default bf16 encoders
  on trees whose conv weights are bf16 values (the port stores them in
  bf16, so other values round when loaded), and port -> trees -> port is
  bit for bit.
"""

import math

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from depth_image_captioning_pub_tpu.config import ConfigTrain
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.utils import checkpoint as jckpt
from depth_image_captioning_pub_torch.models.captioner import build_captioner
from depth_image_captioning_pub_torch.utils import msgpack_codec as mc
from depth_image_captioning_pub_torch.utils.checkpoint import (
    load_component, save_component)
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    params_from_jax, params_to_jax)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

KINDS = ("nic", "base-soft", "depth-soft")
LAYERS = (1, 1, 1, 1)
VOCAB = 30


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def jax_trees():
    """{kind: (trainable, frozen, batch_stats)} of JAX ``cap.init``."""
    out = {}
    for kind in KINDS:
        jcap = jax_build_captioner(kind, VOCAB, ConfigTrain(),
                                   resnet_layers=LAYERS)
        params, frozen, stats = jcap.init(jax.random.PRNGKey(0),
                                          image_hw=(64, 64))
        out[kind] = (_np_tree(params), _np_tree(frozen), _np_tree(stats))
    return out


def _assert_leaves_equal(got, want, path="", bf16_bits=False):
    """Same structure; every leaf the same dtype, shape and bytes. With
    ``bf16_bits``, the port's ``BFloat16Bits`` stands for flax's bf16."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_leaves_equal(got[k], want[k], f"{path}/{k}", bf16_bits)
        return
    w = np.asarray(want)
    if bf16_bits and w.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, mc.BFloat16Bits), path
        assert got.dtype == np.uint16, path
    else:
        assert not isinstance(got, mc.BFloat16Bits), path
        assert np.asarray(got).dtype == w.dtype, path
    assert np.shape(got) == w.shape, path
    assert np.asarray(got).tobytes() == w.tobytes(), path


def _components(kind, trees):
    """The trees the JAX trainer writes, one file each."""
    trainable, frozen, stats = trees
    comps = {"encoder": frozen["encoder"], "decoder": trainable["decoder"]}
    if kind == "nic":
        comps["enc_linear"] = trainable["enc_linear"]
    if kind == "depth-soft":
        comps["D_encoder"] = {"params": trainable["depth_encoder"],
                              "batch_stats": stats}
    return comps


@pytest.mark.parametrize("kind", KINDS)
def test_reads_jax_component_files(kind, jax_trees, tmp_path):
    for name, tree in _components(kind, jax_trees[kind]).items():
        path = jckpt.save_component(str(tmp_path / f"{name}_best0.pth"),
                                    tree)
        assert path.endswith(".pth.msgpack")
        with open(path, "rb") as f:
            want = fs.msgpack_restore(f.read())
        got = load_component(str(tmp_path / f"{name}_best0.pth"))
        _assert_leaves_equal(got, want)
        _assert_leaves_equal(got, tree)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_reads_port_component_files(kind, jax_trees, tmp_path):
    for name, tree in _components(kind, jax_trees[kind]).items():
        port = save_component(str(tmp_path / f"p_{name}.pth"), tree)
        ref = jckpt.save_component(str(tmp_path / f"j_{name}.pth"), tree)
        assert port.endswith(".pth.msgpack")
        with open(port, "rb") as f:
            data = f.read()
        _assert_leaves_equal(fs.msgpack_restore(data), tree)
        back = jckpt.load_component(str(tmp_path / f"p_{name}.pth"), tree)
        _assert_leaves_equal(back, tree)
        with open(ref, "rb") as f:
            assert data == f.read()


def _small_tree(rng):
    return {"a": {"kernel": rng.standard_normal((3, 5, 7)).astype(np.float32),
                  "bias": np.arange(11, dtype=np.int32)},
            "b": rng.standard_normal((40,)).astype(np.float64),
            "c": np.asarray(rng.standard_normal((8, 6)), ml_dtypes.bfloat16),
            "s": np.float32(2.5), "t": np.bool_(True), "u": np.int64(-7)}


def _port_leaves(tree):
    """The tree with bf16 leaves as the port's BFloat16Bits."""
    return {k: (_port_leaves(v) if isinstance(v, dict) else
                np.asarray(v).view(np.uint16).view(mc.BFloat16Bits)
                if np.asarray(v).dtype == ml_dtypes.bfloat16 else v)
            for k, v in tree.items()}


def test_chunked_leaves(monkeypatch, tmp_path):
    """Leaves over MAX_CHUNK_SIZE bytes go in flax's chunked form; the
    port reads flax's and writes the same bytes."""
    tree = _small_tree(np.random.default_rng(0))
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    path = jckpt.save_component(str(tmp_path / "chunked.pth"), tree)
    with open(path, "rb") as f:
        data = f.read()
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert raw["a"]["kernel"]["__msgpack_chunked_array__"] is True
    assert len(raw["a"]["kernel"]["chunks"]) == math.ceil(3 * 5 * 7 * 4 / 64)
    assert len(raw["c"]["chunks"]) == 2         # 96 bytes of bf16
    assert isinstance(raw["s"], msgpack.ExtType)   # small leaves stay whole
    got = load_component(path)
    _assert_leaves_equal(got, fs.msgpack_restore(data), bf16_bits=True)
    _assert_leaves_equal(got, tree, bf16_bits=True)
    monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 64)
    port = save_component(str(tmp_path / "port.pth"), _port_leaves(tree))
    with open(port, "rb") as f:
        assert f.read() == data


def test_bfloat16_leaves(tmp_path):
    """bf16 reads as its uint16 bits, makes the torch.bfloat16 tensor bit
    for bit, and writes back as flax's "bfloat16"."""
    tree = {"w": jnp.asarray(np.random.default_rng(1).standard_normal(
        (5, 3)), jnp.bfloat16), "x": np.zeros((2,), np.float32)}
    path = jckpt.save_component(str(tmp_path / "bf16.pth"), tree)
    got = load_component(path)
    assert isinstance(got["w"], mc.BFloat16Bits)
    want = np.asarray(tree["w"])
    assert got["w"].tobytes() == want.tobytes()
    t = mc.bf16_tensor(got["w"])
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (5, 3)
    np.testing.assert_array_equal(t.float().numpy(),
                                  want.astype(np.float32))
    with open(path, "rb") as f:
        assert mc.packb(got) == f.read()
    back = fs.msgpack_restore(mc.packb(got))
    assert back["w"].dtype == ml_dtypes.bfloat16
    assert back["w"].tobytes() == want.tobytes()


@pytest.mark.parametrize("code", [2, 4, 5, -1, 127])
def test_unknown_ext_code_raises(code):
    # {"x": fixext 8 of type ``code``}
    data = b"\x81\xa1x\xd7" + bytes([code & 0xff]) + b"12345678"
    with pytest.raises(ValueError, match=f"ext type {code} "):
        mc.unpackb(data)


def test_malformed_input_raises():
    with pytest.raises(ValueError, match="after the object"):
        mc.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="starts no object"):
        mc.unpackb(b"\xc1")
    with pytest.raises(TypeError, match="cannot write"):
        mc.packb({"x": object()})


WIRE_CASES = {
    "nil_bool": [None, True, False],
    "fixint": [0, 1, 127, -1, -32],
    "uint": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
    "int": [-33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "float": [0.0, -1.5, 1e300, float("inf")],
    "str": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    "array": [list(range(15)), list(range(16)), list(range(70000))],
    "map": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {str(i): i for i in range(70000)}],
    "nested": {"a": [1, {"b": [None, "c", b"d"]}], "e": {}},
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_forms_match_msgpack(case):
    obj = WIRE_CASES[case]
    data = msgpack.packb(obj, use_bin_type=True)
    assert mc.packb(obj) == data
    assert mc.unpackb(data) == msgpack.unpackb(data, raw=False,
                                               strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 2, 4, 8, 16, 17, 255, 256, 70000])
def test_ext_lengths(n):
    """Every ext form (fixext 1-16, ext 8/16/32) around a byte payload of
    length n: an array of n - 25 bytes makes a payload of about n."""
    arr = np.arange(max(n, 1), dtype=np.uint8)[:n]
    data = fs.msgpack_serialize({"x": arr})
    assert mc.packb({"x": arr}) == data
    got = mc.unpackb(data)["x"]
    assert got.dtype == np.uint8 and got.tobytes() == arr.tobytes()


def test_float32_and_npscalars():
    data = msgpack.packb([1.5], use_single_float=True)
    assert data[1] == 0xca and mc.unpackb(data) == [1.5]
    for x in (np.float32(1.25), np.int8(-3), np.uint64(2**63), np.bool_(0)):
        data = fs.msgpack_serialize({"x": x})
        assert mc.packb({"x": x}) == data
        got = mc.unpackb(data)["x"]
        assert type(got) is type(x) and got == x


def test_load_component_paths(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.pth.msgpack"):
        load_component(str(tmp_path / "nope.pth"))
    (tmp_path / "ref.pth").write_bytes(b"torch zip")
    with pytest.raises(ValueError, match="cli.load_eval_components or "
                       "convert it with utils.convert"):
        load_component(str(tmp_path / "ref.pth"))
    path = save_component(str(tmp_path / "x.msgpack"), {"a": [1.0, 2]})
    assert path == str(tmp_path / "x.msgpack")
    got = load_component(path)
    assert list(got) == ["a"] and list(got["a"]) == ["0", "1"]
    assert got["a"]["0"].dtype == np.float64 and got["a"]["1"] == 2


def _bf16_values(tree, convs=True):
    """Conv kernels (4-D leaves) rounded to bf16 values (kept f32), as the
    port's bf16 encoders store them."""
    return {k: (_bf16_values(v) if isinstance(v, dict) else
                np.asarray(v).astype(ml_dtypes.bfloat16).astype(np.float32)
                if np.ndim(v) == 4 else v)
            for k, v in tree.items()}


def _port_cap(kind, dtype):
    return build_captioner(kind, VOCAB, ConfigTrain(), encoder_dtype=dtype,
                           resnet_layers=LAYERS, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_params_to_jax_inverts_params_from_jax(kind, dtype, jax_trees):
    trainable, frozen, stats = jax_trees[kind]
    rng = np.random.default_rng(2)
    # every leaf distinct from its init, so a swapped leaf shows
    trainable, frozen, stats = (
        jax.tree_util.tree_map(
            lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(x.dtype), t)
        for t in (trainable, frozen, stats))
    if kind == "depth-soft":
        trainable["depth_encoder"] = _bf16_values(trainable["depth_encoder"])
        # the bf16 depth convs store their biases in bf16 too
        for conv in ("conv1", "conv2", "conv3"):
            b = trainable["depth_encoder"][conv]["bias"]
            trainable["depth_encoder"][conv]["bias"] = b.astype(
                ml_dtypes.bfloat16).astype(np.float32)
    if dtype == "bfloat16":
        frozen = _bf16_values(frozen)
    cap = _port_cap(kind, getattr(torch, dtype))
    params_from_jax(cap, trainable, frozen, stats)
    got = params_to_jax(cap)
    for g, w in zip(got, (trainable, frozen, stats)):
        _assert_leaves_equal(g, w)

    # port -> trees -> port is bit for bit
    again = _port_cap(kind, getattr(torch, dtype))
    params_from_jax(again, *got)
    want = cap.state_dict()
    for name, t in again.state_dict().items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name]), name


def test_params_from_jax_loads_bf16_bits():
    """A checkpoint's bf16 leaf (BFloat16Bits) loads as its value."""
    cap = _port_cap("base-soft", torch.float32)
    trainable, frozen, _ = params_to_jax(cap)
    w = np.random.default_rng(3).standard_normal(
        trainable["decoder"]["out_w"].shape).astype(ml_dtypes.bfloat16)
    trainable["decoder"]["out_w"] = w.view(np.uint16).view(mc.BFloat16Bits)
    params_from_jax(cap, trainable, frozen)
    np.testing.assert_array_equal(cap.decoder.out_w.detach().numpy(),
                                  w.astype(np.float32))
