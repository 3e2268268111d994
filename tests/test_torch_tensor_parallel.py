"""Tensor and sequence parallelism (``parallel/tp.py``, the DPT's
``token_sharding``) against the JAX package, on the CPU: a case for each
test of the JAX ``tests/test_tensor_parallel.py``, on a (data 2, model 2)
mesh of four gloo ranks (``tests/torch_parallel_child.py``, one group for
the file, tasks in ``tests/torch_tp_tasks.py``) where JAX uses (4, 2) of
its 8 virtual devices.

The JAX tests hold the JAX sharded results to the JAX unsharded ones; here
the target is the JAX package's unsharded result on the same weights:
base-soft, base-hard and NIC (ResNet blocks 1,1,1,1 at 64x64, f32
encoders, V=24, drawn by the port and bridged with ``params_to_jax``) and
the tiny DPT (2 blocks of dim 64, 4 heads, at 64x64: 17 tokens, drawn by
the JAX package, its norms and biases randomized, bridged with
``dpt_params_from_jax``). Bounds: tokens equal; depth maps atol 1e-4; one
dp x tp train step on the JAX step's own dropout draws: the loss 1e-5,
every trained tensor's gradient rtol/atol 1e-5 (so that a gradient
counted T times fails), every trained element 5e-4, plus 2 * lr where the
port's gradient was below 1e-6 (AdamW's first step is lr * sign(g), which
rounding decides for such a gradient: ``tests/test_torch_train_steps.py``).
Each sharded parameter, and its AdamW moments, holds 1/2 of its split
dimension on every rank (``mesh.assert_partitioned``), a replicated one
all of it; the token-sharded blocks' outputs hold 1/2 of the 17 tokens
padded to 18. Without a group, or with a model axis of one rank, nothing
changes; a rank that fails ends its group's run at once. The split
decoders' other paths, which the JAX tests do not run (sampling, greedy
with its alphas, soft beam search, hard attention's greedy and beam
search), give the JAX package's tokens on the JAX package's own noise
(its keys' draws for the global batch, each data row taking its rows, as
``tests/test_torch_sampling.py`` and ``tests/test_torch_hard.py`` replay
them), the alphas within 2e-5.
"""

import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from depth_image_captioning_pub_tpu.config import ConfigTrain as JaxConfig
from depth_image_captioning_pub_tpu.engine import steps as jsteps
from depth_image_captioning_pub_tpu.engine.evaluate import (
    make_caption_fn as jax_make_caption_fn)
from depth_image_captioning_pub_tpu.models import dpt as jdpt
from depth_image_captioning_pub_tpu.models.captioner import (
    build_captioner as jax_build_captioner)
from depth_image_captioning_pub_tpu.models.decoder import (
    AttentionDecoder as JaxAttentionDecoder)
from depth_image_captioning_pub_tpu.ops.image_ops import (
    imagenet_normalize, to_unit_float)
from depth_image_captioning_pub_tpu.parallel import tp as jtp
from depth_image_captioning_pub_torch.models.decoder import AttentionDecoder
from depth_image_captioning_pub_torch.models.dpt import (
    DPTDepthEstimator, ViTBlock)
from depth_image_captioning_pub_torch.engine.train import trainable_modules
from depth_image_captioning_pub_torch.parallel import mesh, tp
from depth_image_captioning_pub_torch.utils.jax_bridge import (
    flatten_tree, flax_trees, params_to_jax)

import torch_parallel_child as child
import torch_tp_tasks as tasks
from test_torch_dpt import _perturb
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

WORLD = tasks.N_DATA * tasks.N_MODEL
KINDS = ("base-soft", "nic")
RESULT = {"base-soft": ("train", "greedy"), "nic": ("nic_train", "nic_greedy")}
SMALL_GRAD, PARAM_ATOL, LOSS_TOL, DEPTH_ATOL = 1e-6, 5e-4, 1e-5, 1e-4
GRAD_TOL, ALPHA_TOL = 1e-5, 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_dpt():
    """The tiny DPT's JAX estimator and variables (norms and biases
    randomized, as ``tests/test_torch_dpt.py`` does)."""
    est = jdpt.DPTDepthEstimator(dtype=jnp.float32, image_size=tasks.HW)
    est.model = jdpt.DPTDepthModel(dtype=jnp.float32, **tasks.TINY_DPT)
    variables = _np(jax.jit(est.model.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, tasks.HW, tasks.HW, 3))))
    return est, {"params": _perturb(variables["params"],
                                    np.random.default_rng(2))}


def _jax_captioner(kind, cap):
    """The JAX captioner of ``kind`` and ``cap``'s weights bridged to it:
    (captioner, params, frozen, stats)."""
    jcfg = JaxConfig()
    jcfg.lr, jcfg.max_caption_len = tasks.LR, tasks.L
    jcap = jax_build_captioner(kind, tasks.V, jcfg,
                               encoder_dtype=jnp.float32,
                               resnet_layers=tasks.LAYERS)
    return (jcap, *(jax.tree_util.tree_map(jnp.asarray, t)
                    for t in params_to_jax(cap)))


def _gradients():
    """An optax transformation that passes the gradients on unchanged
    and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _jax_references(kind, cap, dcap):
    """The JAX package's single-device results: one train step (dropout
    from PRNGKey(7)) and its gradients on ``cap``'s weights, greedy tokens
    on ``dcap``'s."""
    jcap, params, frozen, stats = _jax_captioner(kind, cap)
    opt = optax.chain(_gradients(), jsteps.make_optimizer(tasks.LR))
    state = jsteps.TrainState(params, opt.init(params), frozen, stats,
                              jnp.int32(0))
    batch = {k: jnp.asarray(v) for k, v in tasks.train_batch().items()}
    rng = jax.random.PRNGKey(7)
    if kind == "nic":
        step = jsteps.make_nic_train_step(
            jcap.encoder_apply(), jcap.decoder_apply(), opt, donate=False)
        state, metrics = step(state, batch, rng)
    else:
        step = jsteps.make_attention_train_step(
            jcap.encoder_apply(), jcap.decoder_apply(), opt,
            alpha_reg=tasks.ALPHA_REG, donate=False)
        state, metrics = step(state, batch, rng, jnp.float32(1.0))
    jcap, params, frozen, stats = _jax_captioner(kind, dcap)
    fn = jax_make_caption_fn(jcap, start_id=tasks.START,
                             max_length=tasks.GREEDY_LEN)
    tokens = fn(frozen, params, stats, jnp.asarray(tasks.greedy_images()),
                jax.random.PRNGKey(0))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": flatten_tree(_np(state.params)),
            "grads": flatten_tree(_np(state.opt_state[0])),
            "tokens": np.asarray(tokens)}


def _jax_draws(n_regions):
    """The JAX package's noise of the decodes that draw, for the global
    batch, by step: sampling's token draws ``gumbel(split(fold_in(key,
    t))[1], [B, V])`` (JAX ``stochastic_sample``), hard greedy's region
    draws ``gumbel(fold_in(key, t), [B, K])`` and hard beam search's
    ``[B, W, K]``."""
    b, steps = tasks.GREEDY_BATCH, range(tasks.GREEDY_LEN)
    key = {c: jax.random.PRNGKey(k) for c, k in tasks.NOISE_KEYS.items()}
    shape = {"sample": (b, tasks.V), "hard_greedy": (b, n_regions),
             "hard_beam": (b, tasks.BEAM, n_regions)}

    def step_key(case, t):
        k = jax.random.fold_in(key[case], t)
        return jax.random.split(k)[1] if case == "sample" else k
    return {case: [np.array(jax.random.gumbel(step_key(case, t),
                                              shape[case]))
                   for t in steps] for case in shape}


def _jax_decodes(soft, hard, feats):
    """``tasks.DECODES`` by the JAX package on the greedy images (``soft``
    and ``hard``: ``_jax_captioner``'s), each on its key of
    ``tasks.NOISE_KEYS``; "alphas" is the JAX ``greedy_sample`` without
    ``end_id`` on ``feats``."""
    images = jnp.asarray(tasks.greedy_images())
    keys = tasks.NOISE_KEYS

    def caption(trees, key=0, **kw):
        jcap, params, frozen, stats = trees
        fn = jax_make_caption_fn(jcap, start_id=tasks.START,
                                 max_length=tasks.GREEDY_LEN, **kw)
        return np.asarray(fn(frozen, params, stats, images,
                             jax.random.PRNGKey(key)))
    tokens, alphas = soft[0].decoder.apply(
        {"params": soft[1]["decoder"]}, feats, tasks.START,
        max_length=tasks.GREEDY_LEN,
        method=JaxAttentionDecoder.greedy_sample)
    return {"sample": caption(soft, keys["sample"],
                              sampling={"top_p": tasks.TOP_P}),
            "alphas": (np.asarray(tokens), np.asarray(alphas)),
            "beam": caption(soft, end_id=tasks.END, beam_size=tasks.BEAM),
            "hard_greedy": caption(hard, keys["hard_greedy"],
                                   end_id=tasks.END),
            "hard_beam": caption(hard, keys["hard_beam"], end_id=tasks.END,
                                 beam_size=tasks.BEAM)}


def _dropout_draws(kind, cap):
    """The JAX train step's dropout keep-masks for PRNGKey(7) at the
    global batch's shape (``tests/test_torch_train_steps.py``'s
    ``jax_hooks``): one a teacher-forced step, NIC's one for all steps."""
    rng = jax.random.PRNGKey(7)
    hidden = cap.decoder.dim_hidden if kind == "nic" else \
        cap.decoder.init_w.shape[1] // 2
    if kind == "nic":
        return np.asarray(jax.random.bernoulli(
            rng, 1.0 - cap.decoder.dropout,
            (tasks.TRAIN_BATCH, tasks.L, hidden)))[None]
    return np.stack([np.asarray(jax.random.bernoulli(
        jax.random.split(jax.random.fold_in(rng, t))[1], 0.5,
        (tasks.TRAIN_BATCH, hidden))) for t in range(tasks.L - 1)])


def _as_jax(kind, flat):
    """Whole trained tensors ``{"module.name": tensor}`` of ``kind`` as the
    JAX package's flattened trainable tree."""
    cap = tasks.port_captioner(kind)
    modules = trainable_modules(cap)
    with torch.no_grad():
        for key, t in flat.items():
            mod, name = key.split(".", 1)
            modules[mod].get_parameter(name).copy_(t)
    return flatten_tree(params_to_jax(cap)[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results of ``task_tp``, started once; the JAX
    references computed in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    data = tmp / "data"
    data.mkdir()
    caps = {kind: tasks.port_captioner(kind) for kind in KINDS}
    for kind, cap in caps.items():
        np.save(data / f"keep_{kind}.npy", _dropout_draws(kind, cap))
    group = child.start_ranks(tmp, WORLD, "tp", data=str(data))
    dcaps = {kind: tasks.decode_captioner(kind)
             for kind in KINDS + ("base-hard",)}
    soft = _jax_captioner("base-soft", dcaps["base-soft"])
    feats = soft[0].encoder_apply()(soft[2]["encoder"], imagenet_normalize(
        to_unit_float(jnp.asarray(tasks.greedy_images()))))
    tasks.save_atomic(_jax_draws(feats.shape[1]), str(data / "noise.pt"))
    est, variables = _jax_dpt()
    tasks.save_atomic(variables, str(data / "dpt.pt"))
    refs = {kind: _jax_references(kind, cap, dcaps[kind])
            for kind, cap in caps.items()}
    refs["depth"] = np.asarray(jax.jit(est.depth_fn())(
        variables, jnp.asarray(tasks.dpt_images())))
    refs["decodes"] = _jax_decodes(soft, _jax_captioner(
        "base-hard", dcaps["base-hard"]), feats)
    return child.wait_ranks(group), refs


def _by_data_row(ranks, key):
    """A result of the ranks of model rank 0, in data-row order, after
    checking that the model ranks of each row agree."""
    rows = []
    for d in range(tasks.N_DATA):
        row = [ranks[d * tasks.N_MODEL + m] for m in range(tasks.N_MODEL)]
        got = [key(r) for r in row]
        for g in got[1:]:
            assert torch.equal(g, got[0])
        rows.append(got[0])
    return torch.cat(rows).numpy()


def test_mesh_2d_shape(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        assert res["coords"] == (r // 2, 2, r % 2, 2)
        assert res["data_mesh"] == (r // 2, 2)
        assert res["too_few"] == "need 8 devices, have 4"
        assert "data axis is set already" in res["second_layout"]
        assert res["after"] == (r, WORLD)       # the layout's block ended
    one = tp.make_mesh_2d(1, 1)          # no process group: this process
    assert one.shape == {"data": 1, "model": 1} and not one.data.active
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tp.make_mesh_2d(1, 2)


def _jax_split_dim(spec, ndim, transposed):
    """The dim of a JAX spec split over "model", in the port's layout."""
    if "model" not in tuple(spec):
        return None
    dim = tuple(spec).index("model")
    return ndim - 1 - dim if transposed else dim


def test_spec_rules():
    """The port's rules on the port's names == the JAX rules on the same
    parameters' flax paths: ViT qkv/fc1 column, proj/fc2 row (an
    ``nn.Linear.weight`` is the flax kernel transposed), the decoder's
    vocab head, LSTM gate kernels and biases and embedding column,
    everything else replicated."""
    block = ViTBlock(8, 2, device="cpu")
    dec = AttentionDecoder(64, dim_attention=16, dim_embedding=8,
                           dim_encoder=24, dim_decoder=16, device="cpu")
    jblock = jtp.tp_specs(flax_trees(block)[0])
    for name, p in block.named_parameters():
        sub, leaf = name.split(".")
        leaf = {"weight": "kernel" if p.dim() == 2 else "scale"}.get(
            leaf, leaf)
        spec = jblock[sub][leaf]
        assert tp.spec_for(name, p) == _jax_split_dim(
            spec, p.dim(), leaf == "kernel"), name
    jdec = jtp.tp_specs({"decoder": {n: p.detach().numpy()
                                     for n, p in dec.named_parameters()}})
    for name, p in dec.named_parameters():
        assert tp.spec_for(name, p) == _jax_split_dim(
            jdec["decoder"][name], p.dim(), False), name
    specs = {name: tp.spec_for(name, p) for name, p in
             [(f"block0.{n}", p) for n, p in block.named_parameters()]
             + list(dec.named_parameters())}
    assert {n: d for n, d in specs.items() if d is not None} == {
        "block0.qkv.weight": 0, "block0.qkv.bias": 0, "block0.proj.weight": 1,
        "block0.fc1.weight": 0, "block0.fc1.bias": 0, "block0.fc2.weight": 1,
        "embed": 1, "lstm_w_ih": 1, "lstm_w_hh": 1, "lstm_b_ih": 0,
        "lstm_b_hh": 0, "out_w": 1, "out_b": 0}


def test_no_group_leaves_everything_as_it_is():
    """A 1x1 mesh (no process group): ``shard_tree`` and ``token_sharding``
    change nothing, and the DPT's depth maps are bit-equal."""
    one = tp.make_mesh_2d(1, 1)
    plain = DPTDepthEstimator(dtype=torch.float32, image_size=tasks.HW,
                              device="cpu", **tasks.TINY_DPT)
    plain.init(torch.Generator().manual_seed(3))
    other = DPTDepthEstimator(dtype=torch.float32, image_size=tasks.HW,
                              device="cpu", token_sharding=one,
                              **tasks.TINY_DPT)
    other.model.load_state_dict(plain.model.state_dict())
    before = {n: p for n, p in other.model.named_parameters()}
    tp.shard_tree(one, other.model)
    assert all(p is before[n] and p.shape == plain.model.get_parameter(
        n).shape for n, p in other.model.named_parameters())
    assert other.model.token_axis is None
    assert all(b.tp is None and b.sp is None for b in other.model.modules()
               if isinstance(b, ViTBlock))
    imgs = torch.from_numpy(tasks.dpt_images()[:2])
    assert torch.equal(other.depth_fn()(imgs), plain.depth_fn()(imgs))
    for kind in KINDS:
        cap = tasks.port_captioner(kind)
        tp.shard_tree(one, cap)
        assert cap.decoder.tp is None
        assert cap.decoder.seq_weights() is not None


def test_failed_rank_ends_the_group(tmp_path):
    """A rank that raises before a collective ends its group's run within
    seconds (its peers' collectives would otherwise wait for it), with
    its output in the failure."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError,
                       match="rank 1 fails before its collective"):
        child.run_ranks(tmp_path, 2, "fail", raise_on=1)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("kind", KINDS)
def test_tp_train_step_matches_single_device(kind, runs):
    """dp=2 x tp=2: one AdamW step on the same batch and dropout draws
    gives the JAX single-device step's loss, gradients and update (every
    trained tensor: NIC's projection and decoder too)."""
    ranks, refs = runs
    key, want = RESULT[kind][0], refs[kind]
    for res in ranks:
        got = res[key]
        assert got["tp"]
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    got = ranks[0][key]
    for r in ranks[1:]:
        for name, p in got["params"].items():
            assert torch.equal(r[key]["params"][name], p), name
    grads = _as_jax(kind, got["grads"])
    assert set(grads) == set(want["grads"])
    for name, w in want["grads"].items():
        np.testing.assert_allclose(grads[name], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    have = _as_jax(kind, got["params"])
    assert set(have) == set(want["params"]) == set(grads)
    for name, w in want["params"].items():
        room = PARAM_ATOL + 2 * tasks.LR * (np.abs(grads[name]) < SMALL_GRAD)
        assert (np.abs(have[name] - w) <= room).all(), (
            name, np.abs(have[name] - w).max())


@pytest.mark.parametrize("kind", KINDS)
def test_tp_greedy_decode_token_equality(kind, runs):
    """The TP-sharded vocab head and embedding (and the attention
    decoder's LSTM) greedy-decode (the step loop; the kernels refuse split
    weights) the JAX package's tokens."""
    ranks, refs = runs
    key = RESULT[kind][1]
    assert all("whole weight matrices" in r[key]["kernels_refused"]
               for r in ranks)
    tokens = _by_data_row(ranks, lambda r: r[key]["tokens"])
    np.testing.assert_array_equal(tokens, refs[kind]["tokens"])
    assert len({tuple(r) for r in tokens}) > 1


@pytest.mark.parametrize("case", tasks.DECODES)
def test_tp_decode_paths_match_one_process(case, runs):
    """Sampling, ``greedy_alphas``, soft beam search and hard attention's
    greedy and beam search with the decoder split: the JAX package's
    tokens on the JAX package's noise (alphas within 2e-5)."""
    ranks, refs = runs
    want = refs["decodes"][case]
    if case == "alphas":
        got = _by_data_row(ranks, lambda r: r["decodes"][case][0])
        np.testing.assert_array_equal(got, want[0])
        alphas = _by_data_row(ranks, lambda r: r["decodes"][case][1])
        np.testing.assert_allclose(alphas, want[1], rtol=ALPHA_TOL,
                                   atol=ALPHA_TOL)
        return
    got = _by_data_row(ranks, lambda r: r["decodes"][case])
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in want}) > 1


@pytest.mark.parametrize("case", sorted(tasks.DPT_CASES))
def test_dpt_forward_matches_replicated(case, runs):
    """The tiny DPT with Megatron-split ViT blocks (``tp``: heads and MLP
    over the model axis), its tokens split over it (``sp``), or both
    (``sp_tp``, the JAX test's token-sharding case): the JAX unsharded
    depth maps within 1e-4."""
    ranks, refs = runs
    depth = _by_data_row(ranks, lambda r: r["dpt"][case]["depth"])
    np.testing.assert_allclose(depth, refs["depth"], rtol=0,
                               atol=DEPTH_ATOL)


def _partitioned(local, dim, extent):
    mesh.assert_partitioned(torch.empty(local), dim, tasks.N_MODEL, extent)


def test_tp_weights_actually_partitioned(runs):
    """Each rank holds 1/2 of the split dimension of every sharded
    parameter and of its AdamW moments, all of a replicated one; a
    partition claimed for a replicated parameter raises. The ViT blocks'
    shards likewise (qkv by heads: 3 x 2 of 4 heads)."""
    ranks, _ = runs
    for res in ranks:
        got = res["train"]
        split = 0
        for name, full in got["shapes"].items():
            dim = tp.spec_for(name, torch.empty(full))
            local = got["local"][name]
            if dim is None:
                assert local == full, name
                assert got["moments"][name] == (full, full)
                continue
            split += 1
            _partitioned(local, dim, full[dim])
            for moment in got["moments"][name]:
                _partitioned(moment, dim, full[dim])
        assert split == 7
        att = got["local"]["att_w_full"]
        with pytest.raises(AssertionError, match="not 2-way partitioned"):
            _partitioned(att, 0, att[0])
        dim, heads = tasks.TINY_DPT["vit_dim"], tasks.TINY_DPT["vit_heads"]
        block = res["dpt"]["tp"]["local"]
        assert block == {
            "norm1.weight": (dim,), "norm1.bias": (dim,),
            "qkv.weight": (3 * dim // 2, dim), "qkv.bias": (3 * dim // 2,),
            "proj.weight": (dim, dim // 2), "proj.bias": (dim,),
            "norm2.weight": (dim,), "norm2.bias": (dim,),
            "fc1.weight": (4 * dim // 2, dim), "fc1.bias": (4 * dim // 2,),
            "fc2.weight": (dim, 4 * dim // 2), "fc2.bias": (dim,)}
        assert heads % 2 == 0


def test_sp_token_axis_actually_partitioned(runs):
    """Every ViT block's output under token sharding holds this data
    row's 4 of 8 images and 9 of the 17 tokens padded to 18: 2-way on the
    batch and on the token axis; 17 itself does not split, which the
    check refuses."""
    ranks, _ = runs
    n_tok = (tasks.HW // 16) ** 2 + 1
    for res in ranks:
        for case in ("sp", "sp_tp"):
            outs = res["dpt"][case]["block_outputs"]
            assert len(outs) == tasks.TINY_DPT["vit_blocks"]
            for shape in outs:
                assert len(shape) == 3
                mesh.assert_partitioned(torch.empty(shape), 0, 2,
                                        tasks.DPT_BATCH)
                _partitioned(shape, 1, n_tok + 1)
                with pytest.raises(AssertionError, match="not divisible"):
                    _partitioned(shape, 1, n_tok)
        for shape in res["dpt"]["tp"]["block_outputs"]:
            assert shape[1] == n_tok
