"""Ranks of the data-parallel tests: each child process is one rank of a
gloo group over the CPU, joined through a ``file://`` store under the
test's ``tmp_path`` (xdist workers never share a port), with one intra-op
thread (bit-equal CPU runs need it, ``tests/test_torch_resume.py``). A
child imports torch, numpy and the port only: the JAX references are
computed by the test process, which hands the children data (arrays,
files) and reads back what each rank returns.

    run_ranks(tmp_path, world, task, **args) -> [rank 0's result, ...]

starts ``world`` children of this file on ``TASKS[task]`` and waits for
them; ``start_ranks`` returns them running (``wait_ranks`` collects), so
that the test process can compute its references meanwhile.
"""

import builtins
import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
LAYERS, HW = (1, 1, 1, 1), 64
SMALL_GRAD = 1e-6     # tests/test_torch_train_steps.py's rounding room


# ---- the test process's side --------------------------------------------

def start_ranks(tmp_path, world, task, plain=False, **args):
    """Start ``world`` ranks of ``task`` (its keyword arguments: JSON), or
    with ``plain`` one process of it that joins no group; returns the
    running group for ``wait_ranks``."""
    run = Path(tempfile.mkdtemp(dir=tmp_path, prefix=f"ranks_{task}_"))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    env.pop("WORLD_SIZE", None)
    procs = []
    for rank in range(world):
        job = {"rank": rank, "world": world, "task": task, "args": args,
               "store": str(run / "store"), "out": str(run / f"{rank}.pt"),
               "plain": plain}
        path = run / f"job{rank}.json"
        path.write_text(json.dumps(job))
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "torch_parallel_child.py"),
             str(path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return run, procs


def wait_ranks(group, timeout=300):
    """Every rank's result, in rank order; AssertionError with a rank's
    output if it failed."""
    run, procs = group
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(run / f"{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_ranks(tmp_path, world, task, **args):
    return wait_ranks(start_ranks(tmp_path, world, task, **args))


# ---- training -----------------------------------------------------------

def train_words():
    from depth_image_captioning_pub_torch.data.synthetic import (
        synthetic_words)
    words = ["<start>", "<end>", "<unk>", "<null>"] + synthetic_words()
    return {w: i for i, w in enumerate(words)}


def depth_table(n, seed):
    """Seeded depth maps [n, 224, 224, 1] in [0, 1], keyed by index."""
    return np.random.default_rng(seed).random(
        (n, 224, 224, 1)).astype(np.float32)


def gray_depth(images, indices):
    """Each image's gray levels, nearest-upsampled to 224x224: the depth
    of ``tests/test_torch_train_loop_depth.py``, a function of the
    images (at 64x64 the CNN's last BN would average one position a row)."""
    gray = np.asarray(images, np.float32).mean(axis=-1) / 255.0
    idx = (np.arange(224) * HW) // 224
    return gray[:, idx][:, :, idx][..., None]


def train_cfg(root, batch=4, dropout=0.5, max_len=8, accum=1):
    """The port's ConfigTrain of a test run: lr 1e-3, every save directory
    under ``root``."""
    from depth_image_captioning_pub_torch.config import ConfigTrain
    cfg = ConfigTrain()
    cfg.batch_size, cfg.max_caption_len, cfg.dropout = batch, max_len, dropout
    cfg.lr, cfg.moving_avg, cfg.grad_accum = 1e-3, 10, accum
    for field in ("save_directory_soft", "save_directory_hard",
                  "save_directory_Cdep_soft", "save_directory_Cdep_hard",
                  "save_directory_nic"):
        setattr(cfg, field, os.path.join(root, field))
    return cfg


def train_case(root, kind, accum, epochs=2, checkpoint_every=0,
               resume=False, preempt_at=None, coco=None, initial=None,
               batch=4, dropout=0.5, max_len=8):
    """Train ``kind`` (ResNet blocks 1,1,1,1 at 64x64, f32 encoders, batch
    ``batch``, dropout ``dropout``, ``accum`` microbatches) for ``epochs``
    epochs under ``root``: on 8 + 4 in-memory images and seeded depth, or
    with ``coco`` ({"images", "annotations", "words"}: a synthetic COCO
    read for training and validation, with ``gray_depth``) from
    ``initial`` (a file of the JAX package's init). Returns {"losses": the
    steps' global losses, "bn": the BN running statistics after each
    step, "small": per trainable tensor, the steps at which an element's
    summed gradient was below ``SMALL_GRAD``, "grad1": the trainable
    gradients of step 1, "state1" and "state": the trainable modules'
    state (BN running statistics included) after step 1 and at the end,
    "summary"}. ``preempt_at``: the step after which the last rank (the
    only one) sets its preempt event."""
    import threading

    from depth_image_captioning_pub_torch.data.coco import CocoCaptions
    from depth_image_captioning_pub_torch.data.synthetic import (
        SyntheticCaptions)
    from depth_image_captioning_pub_torch.engine import train as ttrain
    from depth_image_captioning_pub_torch.models import captioner
    from depth_image_captioning_pub_torch.parallel import multihost

    cfg = train_cfg(root, batch, dropout, max_len, accum)
    extra = {}
    if coco is not None:
        ds = CocoCaptions(coco["images"], coco["annotations"],
                          image_size=(HW, HW))
        data, words = (ds, ds), coco["words"]
        if kind.startswith("depth"):
            extra["depth_provider"] = gray_depth
        extra["initial"] = torch.load(initial, weights_only=False)
    else:
        data = (SyntheticCaptions(8, (HW, HW), seed=1),
                SyntheticCaptions(4, (HW, HW), seed=2))
        words = train_words()
        if kind.startswith("depth"):
            tables = depth_table(8, 3), depth_table(4, 4)
            extra = {"depth_provider": lambda images, idx: tables[0][idx],
                     "val_depth_provider":
                         lambda images, idx: tables[1][idx]}
    record = {"losses": [], "small": None, "bn": []}
    event = threading.Event()
    real = ttrain.attention_train_step

    def state(cap):
        return {f"{name}.{k}": v.detach().clone()
                for name, m in ttrain.trainable_modules(cap).items()
                for k, v in m.state_dict().items()}

    def step(cap, opt, batch, **kw):
        out = real(cap, opt, batch, **kw)
        params = cap.trainable_parameters()
        if record["small"] is None:
            record["small"] = [torch.zeros_like(p, dtype=torch.uint8)
                               for p in params]
            record["grad1"] = [p.grad.detach().clone() for p in params]
            record["state1"] = state(cap)
        for c, p in zip(record["small"], params):
            c += p.grad.abs() < SMALL_GRAD
        record["losses"].append(float(out["loss"]))
        record["bn"].append({k: v.detach().clone()
                             for k, v in cap.named_buffers()
                             if "running" in k})
        last = multihost.process_index() == multihost.process_count() - 1
        if preempt_at == len(record["losses"]) and last:
            event.set()
        record["cap"] = cap
        return out
    saved = ttrain.attention_train_step, ttrain.build_captioner
    ttrain.attention_train_step = step
    ttrain.build_captioner = functools.partial(
        captioner.build_captioner, encoder_dtype=torch.float32)
    try:
        summary = ttrain.train(
            kind, 0, cfg=cfg, datasets=data, word_to_id=words,
            num_epochs=epochs, resnet_layers=LAYERS, device="cpu",
            quiet=True, checkpoint_every=checkpoint_every, resume=resume,
            preempt_event=event, **extra)
    finally:
        ttrain.attention_train_step, ttrain.build_captioner = saved
    cap = record.pop("cap", None)
    return dict(record, state={} if cap is None else state(cap),
                summary=summary)


def _recording_writes(fn, *args, **kwargs):
    """(fn's result, the paths this process opened for writing or gave
    ``torch.save``)."""
    written = []
    real_open, real_save = builtins.open, torch.save

    def opener(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    def save(obj, f, *a, **k):
        written.append(str(f))
        return real_save(obj, f, *a, **k)
    builtins.open, torch.save = opener, save
    try:
        return fn(*args, **kwargs), written
    finally:
        builtins.open, torch.save = real_open, real_save


def _drop_weights(root):
    """On rank 0, which wrote them, remove the weight files of a run under
    ``root`` (the best-val components, the full-state checkpoints): the
    tests read what the ranks return, and the CSV rows."""
    from depth_image_captioning_pub_torch.parallel import multihost
    if multihost.process_index() != 0:
        return
    for path in Path(root).rglob("*"):
        if path.is_file() and path.suffix in (".msgpack", ".pt"):
            path.unlink()


def task_train(root, cases):
    """Each case ``[kind, accum]`` under its own directory of ``root``,
    its weight files then removed; a case ``[kind, accum, {"name", "root",
    ...}]`` under that root with ``train_case``'s other arguments, its
    files kept for the test to read."""
    out = {}
    for kind, accum, *opts in cases:
        if opts:
            opts = dict(opts[0])
            name, case_root = opts.pop("name"), opts.pop("root")
            out[name] = train_case(case_root, kind, accum, **opts)
            continue
        case_root = os.path.join(root, f"{kind}_{accum}")
        out[f"{kind}/{accum}"] = train_case(case_root, kind, accum)
        _drop_weights(case_root)
    return out


def task_resume(root, kind, preempt_at):
    """A straight run with checkpoints, and a run preempted after step
    ``preempt_at`` then resumed, each in its own directory; with the files
    each opened for writing."""
    straight, w1 = _recording_writes(
        train_case, os.path.join(root, "straight"), kind, 1,
        checkpoint_every=1)
    first, w2 = _recording_writes(
        train_case, os.path.join(root, "resumed"), kind, 1,
        checkpoint_every=1, preempt_at=preempt_at)
    resumed, w3 = _recording_writes(
        train_case, os.path.join(root, "resumed"), kind, 1,
        checkpoint_every=1, resume=True)
    _drop_weights(root)
    return {"straight": straight, "first": first, "resumed": resumed,
            "writes": w1 + w2 + w3}


# ---- evaluation ---------------------------------------------------------

def task_evaluate(root, cases):
    """Score each case ({"kind", "batch", "num_sets", "noise": an .npy of
    the draws [set, batch, t, rows, K] or None, "store": an eval cache
    directory or None}) with the port's ``evaluate`` on the checkpoint
    sets under the working directory ``root``; returns per case (scores,
    each set's hypotheses on rank 0, the frozen encoder's calls)."""
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.data import coco
    from depth_image_captioning_pub_torch.data.vocab import load_vocab
    from depth_image_captioning_pub_torch.engine import evaluate as teval
    from depth_image_captioning_pub_torch.models import captioner

    os.chdir(root)
    out = {}
    for case in cases:
        cfg = ConfigEval()
        cfg.batch_size, cfg.max_length = case["batch"], case["max_length"]
        w2i, i2w = load_vocab(cfg.word_to_id_file)
        i2w = i2w or {i: w for w, i in w2i.items()}
        ds = coco.Subset(coco.CocoCaptions(
            cfg.val_img_directory, cfg.val_anno_file, image_size=(HW, HW)),
            coco.load_index_file(cfg.index_dir))
        kind = case["kind"]
        if kind == "nic":
            save_dir, files = cfg.save_directory_nic, cfg.nic_parameter_files
        else:
            save_dir, files = cli.eval_tables(cfg, kind.split("-")[1],
                                              False, False)
        cap = captioner.build_captioner(kind, len(w2i), cfg,
                                        encoder_dtype=torch.float32,
                                        resnet_layers=LAYERS, device="cpu")
        hook = None
        if case["noise"] is not None:
            table = np.load(case["noise"])

            def hook(set_idx, batch_idx, table=table):
                def draw(t, shape):
                    assert tuple(shape) == table.shape[3:], shape
                    return torch.from_numpy(table[set_idx - 1, batch_idx, t])
                return draw
        hypos, calls = [], []
        real = teval.load_textfiles

        def recorder(refs, hyps):
            hypos.append(list(hyps))
            return real(refs, hyps)
        teval.load_textfiles = recorder
        frozen = cap.backbone if kind == "nic" else cap.encoder
        hook_handle = frozen.register_forward_hook(
            lambda *a: calls.append(1))
        try:
            scores = teval.evaluate(
                kind, "coco", cap,
                lambda i: cli.load_eval_components(save_dir, files[i], cap),
                ds, w2i, i2w, cfg, num_sets=case["num_sets"], quiet=True,
                att_noise=hook, eval_cache_dir=case.get("store"))
        finally:
            teval.load_textfiles = real
            hook_handle.remove()
        out[case["name"]] = (scores, hypos, len(calls))
    from depth_image_captioning_pub_torch.parallel import multihost
    rank = multihost.process_index()
    out["global_batch"] = multihost.global_batch(
        {"rows": np.arange(3) + 3 * rank,
         "t": torch.full((2, 2), float(rank))})
    out["shard"] = multihost.host_shard_indices(5)
    return out


TASKS = {"train": task_train, "resume": task_resume,
         "evaluate": task_evaluate}


def main(job_path):
    job = json.loads(Path(job_path).read_text())
    torch.set_num_threads(1)
    from depth_image_captioning_pub_torch.parallel import multihost
    if not job["plain"]:
        multihost.initialize(f"file://{job['store']}", job["world"],
                             job["rank"], backend="gloo", device="cpu")
    try:
        result = TASKS[job["task"]](**job["args"])
    finally:
        multihost.shutdown()
    torch.save(result, job["out"])


if __name__ == "__main__":
    main(sys.argv[1])
