"""Pipeline parallelism (``parallel/pp.py``) against the JAX package, on
the CPU: a case for each test of the JAX ``tests/test_pipeline_parallel.py``,
on four gloo ranks (``tests/torch_parallel_child.py``, one group for the
file, tasks in ``tests/torch_tp_tasks.py``) where JAX uses its 8 virtual
devices: the GPipe schedule over S = 4 and 2 stages (JAX also runs 8), dp x
pp on (data 2, stage 2) where JAX has (2, 4), the gradients through the
schedule, the DPT's 12 ViT blocks with padded tokens over 4 stages, the
errors, and each stage holding only its blocks. The target is the JAX
package's sequential fold of the same blocks (the JAX tests pin the JAX
pipeline to it): taps and gradients within rtol/atol 2e-5 (the
microbatches' matmuls sum in another order than the whole batch's).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from depth_image_captioning_pub_tpu.models.dpt import ViTBlock as JViTBlock
from depth_image_captioning_pub_torch.parallel import mesh

import torch_parallel_child as child
import torch_tp_tasks as tasks
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

TOL = 2e-5
WORLD = 4


def _toy(p, a):
    return a + jnp.tanh(a @ p["w"] + p["b"])


def _sequential(case):
    """Every block's output of the JAX fold of ``case``'s toy blocks."""
    *_, n_blocks, dim, batch, bseed, xseed = case
    x = jnp.asarray(tasks.toy_input(batch, dim, xseed))
    outs = []
    for p in tasks.toy_blocks(n_blocks, dim, bseed):
        x = _toy(jax.tree_util.tree_map(jnp.asarray, p), x)
        outs.append(np.asarray(x))
    return outs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _jax_grads():
    *_, n_blocks, dim, batch, bseed, xseed = tasks.PP_GRAD
    blocks = tasks.toy_blocks(n_blocks, dim, bseed)
    stacked = {k: jnp.stack([b[k] for b in blocks]) for k in blocks[0]}
    x = jnp.asarray(tasks.toy_input(batch, dim, xseed))

    def loss(sp):
        def body(a, p):
            return _toy(p, a), None
        y, _ = jax.lax.scan(body, x, sp)
        return jnp.sum(y ** 2)
    return float(loss(stacked)), jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(stacked))


def _jax_vit_taps():
    block = JViTBlock(dim=tasks.VIT_DIM, heads=tasks.VIT_HEADS,
                      dtype=jnp.float32)
    apply = jax.jit(lambda p, t: block.apply({"params": p}, t,
                                             n_valid=tasks.VIT_TOKENS))
    t = jnp.asarray(tasks.vit_tokens())
    taps = {}
    for i in range(tasks.VIT_BLOCKS):
        t = apply(tasks.vit_block_params(i), t)
        if i in (8, 11):
            taps[i] = np.asarray(t)
    return taps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results of ``task_pp``, started once; the JAX
    references computed in this process meanwhile."""
    group = child.start_ranks(tmp_path_factory.mktemp("pp"), WORLD, "pp")
    refs = {name: _sequential(case)
            for name, case in {**tasks.PP_CASES, "dp_pp": tasks.PP_DP,
                               "placed": (0, 0, 0, 8, 4, 8, 0, 3)}.items()}
    refs["grad"] = _jax_grads()
    refs["vit"] = _jax_vit_taps()
    return child.wait_ranks(group), refs


@pytest.mark.parametrize("name", sorted(tasks.PP_CASES))
def test_stage_outputs_match_sequential(name, runs):
    ranks, refs = runs
    n_stages, _, _, n_blocks, dim, batch = tasks.PP_CASES[name][:6]
    per = n_blocks // n_stages
    for res in ranks:
        out = res[name]
        assert tuple(out.shape) == (n_stages, batch, dim)
        for s in range(n_stages):
            _close(out[s], refs[name][(s + 1) * per - 1])


def test_dp_pp_composition_matches_sequential(runs):
    """(data 2, stage 2): each data row pipelines its rows of every
    microbatch; the whole batch's outputs are the sequential fold's, and
    a microbatch of 1 row cannot split over 2 data rows."""
    ranks, refs = runs
    for r, res in enumerate(ranks):
        assert res["coords"][2] == (r // 2, 2, r % 2, 2, True)
        out = res["dp_pp"]
        _close(out[-1], refs["dp_pp"][-1])
        _close(out[0], refs["dp_pp"][3])
        assert res["dp_pp_error"] == \
            "microbatch 1 not divisible by mesh axis 'data'=2"


def test_grads_match_sequential(runs):
    """The schedule's backward (the reverse shift) gives each stage its
    blocks' gradients of the sequential fold's loss."""
    ranks, refs = runs
    loss, grads = refs["grad"]
    n_stages, per = tasks.PP_GRAD[0], tasks.PP_GRAD[3] // tasks.PP_GRAD[0]
    for stage, res in enumerate(ranks[:n_stages]):
        assert res["grad"]["loss"] == pytest.approx(loss, rel=1e-6)
        for k, g in res["grad"]["grads"].items():
            _close(g, grads[k][stage * per:(stage + 1) * per])


def test_vit_taps_pipelined_match_loop(runs):
    """The real ViT block stack, 16 tokens of which 10 real (K5 masks the
    pad keys), over 4 stages of 3 blocks: the taps after blocks 8 and 11
    on the real tokens equal the JAX block loop's."""
    ranks, refs = runs
    for res in ranks:
        tap3, tap4 = res["vit"]
        n = tasks.VIT_TOKENS
        _close(tap3[:, :n], refs["vit"][8][:, :n])
        _close(tap4[:, :n], refs["vit"][11][:, :n])


def test_validation_errors(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        errors = res["errors"]
        assert errors["batch"] == "batch 6 not divisible by M=4 microbatches"
        assert errors["hooks"].startswith(
            "hook 8 not on a stage boundary with 2 stages (6 blocks/stage)")
        if r < 3:
            assert errors["blocks"] == "8 blocks not divisible by 3 stages"
        else:       # the fourth rank is outside a mesh of 3 stages
            assert res["coords"][3][4] is False and "blocks" not in errors


def test_pp_stage_weights_actually_partitioned(runs):
    """Each stage rank holds its 2 of the 8 blocks (1/S of the stacked
    block axis), and the pipeline from those shards matches the fold."""
    ranks, refs = runs
    for res in ranks:
        assert res["placed"] == {"w": (2, 4, 4), "b": (2, 4)}
        for shape in res["placed"].values():
            mesh.assert_partitioned(np.empty(shape), 0, 4, 8)
        _close(res["placed_out"][-1], refs["placed"][-1])
