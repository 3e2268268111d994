"""Rank tasks of the tensor-, sequence- and pipeline-parallel tests
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_pipeline_
parallel.py``), run by ``tests/torch_parallel_child.py`` in a gloo group of
four ranks on the CPU. Like the child, this module imports torch, numpy and
the port only; the inputs that both packages read are made here from
seeds (the port's captioner from a ``torch.Generator``, bridged to the JAX
package by the test process), or handed over as files by the test
process (the JAX package's dropout draws and tiny DPT), which it may write
while the ranks already run (``wait_load``)."""

import os
import time
from pathlib import Path

import numpy as np
import torch

V, L, HW, LAYERS = 24, 8, 64, (1, 1, 1, 1)
TRAIN_BATCH, LR, ALPHA_REG = 16, 1e-3, 0.7
GREEDY_BATCH, GREEDY_LEN, START = 16, 6, 1
DPT_BATCH = 8
TINY_DPT = dict(vit_blocks=2, hooks=(0, 1), resnet_layers=(1, 1, 1),
                vit_dim=64, vit_heads=4, features=32)
N_DATA, N_MODEL = 2, 2
DPT_CASES = {"tp": (False, True), "sp": (True, False), "sp_tp": (True, True)}
# the pipeline cases: (stages, data rows, microbatches, blocks, dim, batch,
# block seed, input seed)
PP_CASES = {"s4_m4": (4, 1, 4, 8, 16, 12, 0, 1),
            "s2_m6": (2, 2, 6, 8, 16, 12, 0, 1)}
PP_DP = (2, 2, 4, 8, 16, 16, 5, 6)         # (data 2, stage 2), batch_axis
PP_GRAD = (4, 1, 2, 8, 8, 8, 2, 3)
VIT_DIM, VIT_HEADS, VIT_BLOCKS = 16, 2, 12
VIT_BATCH, VIT_TOKENS, VIT_PAD, VIT_STAGES, VIT_MB = 8, 10, 6, 4, 4


END = 2
BEAM = 3
TOP_P = 0.9
DECODES = ("sample", "alphas", "beam", "hard_greedy", "hard_beam")
# the JAX keys of the decodes that draw noise
NOISE_KEYS = {"sample": 21, "hard_greedy": 22, "hard_beam": 23}


def port_captioner(kind="base-soft"):
    """``kind`` (ResNet blocks 1,1,1,1, f32 encoders, V=24, L=8) drawn
    from seed 0 on the CPU, the vocab head's bias too (its init is
    zero)."""
    from depth_image_captioning_pub_torch.config import ConfigTrain
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    cfg = ConfigTrain()
    cfg.max_caption_len, cfg.lr = L, LR
    cap = build_captioner(kind, V, cfg, encoder_dtype=torch.float32,
                          resnet_layers=LAYERS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cap.init(gen)
    with torch.no_grad():
        cap.decoder.out_b.normal_(0.0, 0.1, generator=gen)
    return cap


def decode_captioner(kind="base-soft"):
    """``port_captioner(kind)`` made to caption: the frozen CNN's conv
    kernels x3 (features that differ between images), the vocab head x20
    (a peaked distribution), <end> 4 less likely (captions of many
    lengths)."""
    cap = port_captioner(kind)
    cnn = cap.backbone if kind == "nic" else cap.encoder
    with torch.no_grad():
        for p in cnn.parameters():
            if p.dim() == 4:
                p.mul_(3.0)
        cap.decoder.out_w.mul_(20.0)
        cap.decoder.out_b[END] -= 4.0
    return cap


def decode(cap, images, case, draws, rows):
    """Tokens of one decode ``case`` of ``DECODES`` on ``images`` (the
    alphas too for "alphas"); its noise is this data row's ``rows`` of the
    JAX package's draws for the global batch (``draws[case][t]``)."""
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)

    def hook(t, shape=None):
        z = torch.from_numpy(draws[case][t][rows])
        assert shape is None or tuple(shape) == tuple(z.shape), shape
        return z
    if case == "alphas":
        feats = make_caption_fn(cap, START, GREEDY_LEN).frozen(
            images)["feats"]
        return cap.decoder.greedy_alphas(feats, START,
                                         max_length=GREEDY_LEN)
    kwargs = {"sample": dict(sampling={"top_p": TOP_P},    # the hook draws
                             generator=torch.Generator()),
              "beam": dict(end_id=END, beam_size=BEAM),
              "hard_greedy": dict(end_id=END),
              "hard_beam": dict(end_id=END, beam_size=BEAM)}[case]
    fn = make_caption_fn(cap, START, GREEDY_LEN, **kwargs)
    if case == "sample":
        return fn(images, noise=hook)
    if case.startswith("hard"):
        return fn(images, att_noise=hook)
    return fn(images)


def train_batch():
    """The global batch of the train step: uint8 images, <start>-led
    captions of lengths 2..L, the last row a pad row."""
    rng = np.random.default_rng(11)
    caps = rng.integers(0, V - 4, (TRAIN_BATCH, L)).astype(np.int32)
    caps[:, 0] = START
    return {"images": rng.integers(0, 256, (TRAIN_BATCH, HW, HW, 3),
                                   dtype=np.uint8),
            "captions": caps,
            "lengths": rng.integers(2, L + 1, (TRAIN_BATCH,)).astype(
                np.int32),
            "pad_mask": np.array([True] * (TRAIN_BATCH - 1) + [False])}


def greedy_images():
    return np.random.default_rng(12).random(
        (GREEDY_BATCH, HW, HW, 3), dtype=np.float32)


def dpt_images():
    return np.random.default_rng(13).random((DPT_BATCH, HW, HW, 3),
                                            dtype=np.float32)


def toy_blocks(n_blocks, dim, seed):
    """The JAX test's ``make_toy_blocks``: the same draws, as arrays."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 0.3, (dim, dim)).astype(np.float32),
             "b": rng.normal(0, 0.1, (dim,)).astype(np.float32)}
            for _ in range(n_blocks)]


def toy_input(batch, dim, seed):
    return np.random.default_rng(seed).normal(0, 1, (batch, dim)).astype(
        np.float32)


def vit_block_params(i):
    """Block i's flax parameter tree (``ViTBlock(16, 2)``), seeded."""
    rng = np.random.default_rng(100 + i)
    d = VIT_DIM

    def dense(n_in, n_out):
        return {"kernel": rng.normal(0, n_in ** -0.5, (n_in, n_out)),
                "bias": rng.normal(0, 0.1, (n_out,))}

    def norm():
        return {"scale": rng.uniform(0.5, 1.5, (d,)),
                "bias": rng.normal(0, 0.1, (d,))}
    tree = {"norm1": norm(), "qkv": dense(d, 3 * d), "proj": dense(d, d),
            "norm2": norm(), "fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}
    return {k: {n: v.astype(np.float32) for n, v in p.items()}
            for k, p in tree.items()}


def vit_tokens():
    """[B, N + pad, D] tokens, the pad rows zero."""
    t = np.random.default_rng(7).normal(
        0, 1, (VIT_BATCH, VIT_TOKENS + VIT_PAD, VIT_DIM)).astype(np.float32)
    t[:, VIT_TOKENS:] = 0.0
    return t


def toy_apply(p, a):
    return a + torch.tanh(a @ p["w"] + p["b"])


def wait_load(path, timeout=240):
    """The file the test process writes (renamed into place when whole)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def save_atomic(obj, path):
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


# ---- tensor and sequence parallelism ---------------------------------------

def _full(p, dim, axis):
    """The whole tensor of a shard split along ``dim`` (contiguous)."""
    from depth_image_captioning_pub_torch.parallel import tp
    return p.detach() if dim is None else tp._all_gather(p.detach(), axis,
                                                         dim)


def _tp_train(mesh, data, kind="base-soft"):
    """One AdamW step of ``kind`` split over the mesh, on its data row's
    rows and the JAX step's dropout draws: the global metrics, every
    trained tensor and its gradient (whole), and the decoder's local and
    AdamW moment shapes."""
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.engine.train import (
        trainable_modules)
    from depth_image_captioning_pub_torch.parallel import tp
    cap = port_captioner(kind)
    shapes = {n: tuple(p.shape) for n, p in cap.decoder.named_parameters()}
    tp.shard_tree(mesh, cap)
    opt = steps.make_optimizer(cap, LR)
    batch = {k: torch.from_numpy(v) for k, v in
             tp.shard_batch_2d(mesh, train_batch()).items()}
    keep = np.load(os.path.join(data, f"keep_{kind}.npy"))

    def dropout_keep(t, shape):
        assert tuple(shape) == keep.shape[1:], shape
        return torch.from_numpy(keep[t])
    if kind == "nic":
        metrics = steps.nic_train_step(cap, opt, batch,
                                       dropout_keep=dropout_keep)
    else:
        metrics = steps.attention_train_step(
            cap, opt, batch, alpha_reg=ALPHA_REG, dropout_keep=dropout_keep)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "shapes": shapes, "params": {}, "grads": {}, "local": {},
           "moments": {}}
    for name, p in cap.decoder.named_parameters():
        out["local"][name] = tuple(p.shape)
        state = opt.state[p]
        out["moments"][name] = (tuple(state["exp_avg"].shape),
                                tuple(state["exp_avg_sq"].shape))
    for mod, module in trainable_modules(cap).items():
        for name, p in module.named_parameters():
            dim = tp.spec_for(name, p)
            key = f"{mod}.{name}"
            out["params"][key] = _full(p, dim, mesh.model)
            out["grads"][key] = _full(p.grad, dim, mesh.model)
    out["tp"] = cap.decoder.tp is not None
    return out


def _tp_greedy(mesh, kind="base-soft"):
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.parallel import tp
    cap = decode_captioner(kind)
    tp.shard_tree(mesh, cap)
    fn = make_caption_fn(cap, start_id=START, max_length=GREEDY_LEN)
    imgs = tp.shard_batch_2d(mesh, greedy_images())
    tokens = fn(torch.from_numpy(imgs))
    try:
        cap.decoder.seq_weights()
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"tokens": tokens, "kernels_refused": refused}


def _tp_decodes(mesh, draws):
    """Each of ``DECODES`` with the decoder split over the model axis, on
    this data row's greedy images and its rows of ``draws``."""
    from depth_image_captioning_pub_torch.parallel import tp
    from depth_image_captioning_pub_torch.parallel.mesh import (
        batch_sharding)
    imgs = torch.from_numpy(tp.shard_batch_2d(mesh, greedy_images()))
    rows = batch_sharding(mesh.data, GREEDY_BATCH)
    caps = {kind: tp.shard_tree(mesh, decode_captioner(kind))
            for kind in ("base-soft", "base-hard")}
    return {case: decode(caps["base-hard" if case.startswith("hard")
                              else "base-soft"], imgs, case, draws, rows)
            for case in DECODES}


def _tp_dpt(mesh, variables):
    from depth_image_captioning_pub_torch.models.dpt import (
        DPTDepthEstimator, ViTBlock)
    from depth_image_captioning_pub_torch.parallel import tp
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        dpt_params_from_jax)
    imgs = torch.from_numpy(tp.shard_batch_2d(mesh, dpt_images()))
    out = {}
    for name, (sp, shard) in DPT_CASES.items():
        est = DPTDepthEstimator(
            dtype=torch.float32, image_size=HW, device="cpu",
            token_sharding=mesh if sp else None, **TINY_DPT)
        dpt_params_from_jax(est, variables)
        if shard:
            tp.shard_tree(mesh, est.model)
        blocks = [m for m in est.model.modules() if isinstance(m, ViTBlock)]
        seen = []
        handles = [b.register_forward_hook(
            lambda m, a, y: seen.append(tuple(y.shape))) for b in blocks]
        depth = est.depth_fn()(imgs)
        for h in handles:
            h.remove()
        out[name] = {
            "depth": depth, "block_outputs": seen,
            "local": {n: tuple(p.shape) for n, p in
                      blocks[0].named_parameters()}}
    return out


def task_tp(data):
    """The (data 2, model 2) mesh, and on it: one dp x tp train step of
    base-soft and NIC on the JAX package's dropout draws, their greedy
    decoding and the other decodes, and the tiny DPT under TP, token
    sharding, and both."""
    from depth_image_captioning_pub_torch.parallel import tp
    from depth_image_captioning_pub_torch.parallel.mesh import make_mesh
    out = {}
    try:
        tp.make_mesh_2d(4, 2)
    except ValueError as e:
        out["too_few"] = str(e)
    with tp.make_mesh_2d(N_DATA, N_MODEL) as mesh:
        out["coords"] = (mesh.data.rank, mesh.data.size, mesh.model.rank,
                         mesh.model.size)
        out["data_mesh"] = (make_mesh().rank, make_mesh().size)
        try:
            tp.make_mesh_2d(N_DATA, N_MODEL)
        except ValueError as e:
            out["second_layout"] = str(e)
        out["train"] = _tp_train(mesh, data)
        out["greedy"] = _tp_greedy(mesh)
        out["nic_train"] = _tp_train(mesh, data, "nic")
        out["nic_greedy"] = _tp_greedy(mesh, "nic")
        out["decodes"] = _tp_decodes(mesh, wait_load(
            os.path.join(data, "noise.pt")))
        out["dpt"] = _tp_dpt(mesh, wait_load(os.path.join(data, "dpt.pt")))
    out["after"] = (make_mesh().rank, make_mesh().size)
    return out


# ---- pipeline parallelism ----------------------------------------------------

def _stacked(blocks):
    from depth_image_captioning_pub_torch.parallel.pp import (
        stack_block_params)
    return stack_block_params([{k: torch.from_numpy(v) for k, v in b.items()}
                               for b in blocks])


def _pp_case(mesh, case, batch_axis=None):
    from depth_image_captioning_pub_torch.parallel.pp import (
        pipeline_stage_outputs)
    _, _, n_mb, n_blocks, dim, batch, bseed, xseed = case
    x = torch.from_numpy(toy_input(batch, dim, xseed))
    return pipeline_stage_outputs(toy_apply, _stacked(
        toy_blocks(n_blocks, dim, bseed)), x, mesh, n_mb,
        batch_axis=batch_axis)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def task_pp():
    """Every pipeline case on meshes of 4 stages, (data 2, stage 2) and 3
    stages (rank 3 outside)."""
    from depth_image_captioning_pub_torch.models.dpt import ViTBlock
    from depth_image_captioning_pub_torch.parallel import pp
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        flax_state_dict)
    meshes = {4: pp.make_stage_mesh(4), 2: pp.make_stage_mesh(2, n_data=2),
              3: pp.make_stage_mesh(3)}
    out = {"coords": {s: (m.data.rank, m.data.size, m.stage.rank,
                          m.stage.size, m.member)
                      for s, m in meshes.items()}}
    for name, case in PP_CASES.items():
        out[name] = _pp_case(meshes[case[0]], case)
    out["dp_pp"] = _pp_case(meshes[2], PP_DP, batch_axis="data")
    out["dp_pp_error"] = _raises(lambda: _pp_case(
        meshes[2], PP_DP[:2] + (16,) + PP_DP[3:], batch_axis="data"))

    # gradients of this stage's blocks
    _, _, n_mb, n_blocks, dim, batch, bseed, xseed = PP_GRAD
    local = pp.shard_stacked_params(meshes[4], _stacked(
        toy_blocks(n_blocks, dim, bseed)))
    for v in local.local.values():
        v.requires_grad_(True)
    y = pp.pipeline_stage_outputs(
        toy_apply, local, torch.from_numpy(toy_input(batch, dim, xseed)),
        meshes[4], n_mb)
    loss = torch.sum(y[-1] ** 2)
    loss.backward()
    out["grad"] = {"loss": float(loss),
                   "grads": {k: v.grad for k, v in local.local.items()}}

    # the ViT stack with padded tokens
    blocks = []
    for i in range(VIT_BLOCKS):
        blk = ViTBlock(VIT_DIM, VIT_HEADS, device="cpu")
        blk.load_state_dict({k: torch.from_numpy(v) for k, v in
                             flax_state_dict(vit_block_params(i)).items()})
        blocks.append(blk)
    with torch.no_grad():
        out["vit"] = pp.vit_taps_pipelined(
            blocks, torch.from_numpy(vit_tokens()), meshes[VIT_STAGES],
            VIT_MB, n_valid=VIT_TOKENS)

    # errors
    toy8 = _stacked(toy_blocks(8, 4, 0))
    errors = {"batch": _raises(lambda: pp.pipeline_stage_outputs(
        toy_apply, toy8, torch.zeros(6, 4), meshes[4], 4))}
    if meshes[3].member:
        errors["blocks"] = _raises(lambda: pp.pipeline_stage_outputs(
            toy_apply, toy8, torch.zeros(6, 4), meshes[3], 2))
    errors["hooks"] = _raises(lambda: pp.vit_taps_pipelined(
        blocks, torch.zeros(4, 8, VIT_DIM), meshes[2], 2))
    out["errors"] = errors

    # stage weights partitioned: 2 of 8 blocks a stage, and the pipeline
    # from them
    placed = pp.shard_stacked_params(meshes[4], toy8)
    out["placed"] = {k: tuple(v.shape) for k, v in placed.local.items()}
    out["placed_out"] = pp.pipeline_stage_outputs(
        toy_apply, placed, torch.from_numpy(toy_input(8, 4, 3)), meshes[4],
        4)
    return out
