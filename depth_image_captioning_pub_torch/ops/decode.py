"""Batched beam search and the filters and draw of stochastic sampling
(counterpart of the JAX ``ops/decode.py``).

Generic over models through ``step_fn(state, tokens, t) -> (state,
logprobs)``: every tensor of ``state`` (a dict) and ``tokens``/``logprobs``
has a leading [B*W] dim, and ``t`` is the step index. Beams are reordered
by a gather; finished beams persist by only offering ``<end>`` at zero
cost. Used by ``NICDecoder.beam_sample`` and hard attention's search in
``AttentionDecoder.beam_sample``; soft attention's search runs in the
whole-search kernel (``ops/kernels/beam_seq.py``), whose plain version
repeats this selection step.

Two points hold the search to the JAX package's:

* the flat top-W over W·V takes the larger value first and, among equal
  values, the lower flat index ``w·V + v`` (``lax.top_k``'s order; a stable
  descending sort gives it, ``torch.topk`` promises no order among ties);
* the length penalty measures a beam that never emitted ``<end>`` as
  length 1 (the argmax of an all-False row is 0), as the JAX package does.

Hard attention draws its region as ``argmax(logits + noise)`` over
``region_noise``'s draws (``ops/attention.gumbel_max_attention``).
Stochastic sampling draws each token as ``gumbel_argmax(filtered_logits(
logits), noise)``: ``argmax(filt + noise)`` over Gumbel noise is what
``jax.random.categorical`` computes. The two frameworks' generators give
different numbers, so the tests feed both sides the JAX package's noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from depth_image_captioning_pub_torch.parallel.mesh import any_rank, make_mesh

NEG_INF = -1e9   # score of dead beams and of finished beams' other tokens

State = Dict[str, torch.Tensor]


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``x - max - log(sum(exp(x - max)))`` over the last dim, in the
    JAX package's order of operations."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def filtered_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature, then top-k, then top-p (nucleus) filtering: f32 logits
    [..., V] with every token outside the kept set at -inf.

    The temperature is floored at 1e-6. Top-k keeps every value >= the
    k-th largest (ties at the cut are all kept); top-p keeps, on the
    tempered distribution sorted once before top-k, the tokens whose
    exclusive cumulative probability is < top_p (the argmax always), again
    by threshold. top_k=0 and top_p=1.0 turn their filters off.
    """
    logits = logits.to(torch.float32)
    if temperature != 1.0:
        # the op rounds the divisor to f32: f32(max(t, 1e-6)) is the JAX
        # package's max(f32(t), f32(1e-6))
        logits = logits / max(float(temperature), 1e-6)
    v = logits.shape[-1]
    if not ((top_k and top_k < v) or top_p < 1.0):
        return logits
    desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k and top_k < v:
        kth = desc[..., top_k - 1:top_k]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        probs = torch.softmax(desc, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        keep = cum_excl < top_p          # always keeps the argmax
        min_kept = torch.where(keep, desc, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < min_kept, float("-inf"))
    return logits


def gumbel_noise(shape: Sequence[int], generator: torch.Generator
                 ) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), f32,
    drawn from ``generator`` on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def region_noise(generator: torch.Generator
                 ) -> Callable[[int, Sequence[int]], torch.Tensor]:
    """Hard attention's noise source drawing from ``generator`` (on the
    features' device): ``noise(t, shape)`` -> standard Gumbel of ``shape``
    ([B, K] a step, [B, W, K] in the beam search). The decoders take any
    such ``att_noise`` hook; the tests replay the JAX package's draws
    through one."""
    if generator is None:
        raise ValueError("hard attention needs a generator or an att_noise "
                         "hook for its Gumbel noise")
    return lambda t, shape: gumbel_noise(shape, generator)


def dropout_masks(generator: torch.Generator, rate: float
                 ) -> Callable[[int, Sequence[int]], torch.Tensor]:
    """Training dropout's keep-masks drawing from ``generator`` (on the
    activations' device): ``keep(t, shape)`` -> bool of ``shape``, True
    with probability 1 - ``rate``. The decoders take any such hook; the
    tests replay the JAX package's ``bernoulli`` draws through one."""
    if generator is None:
        raise ValueError("training dropout needs a generator or a "
                         "dropout_keep hook for its masks")
    return lambda t, shape: torch.rand(
        tuple(shape), generator=generator, device=generator.device,
        dtype=torch.float32) < 1.0 - rate


def gumbel_argmax(filt: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The draw from softmax(filt): argmax(filt + noise) over the last dim,
    the lowest index on ties, as int32."""
    return torch.argmax(filt + noise, dim=-1).to(torch.int32)


def top_w(total: torch.Tensor, beam_size: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat top-W of total [B, W, V] in ``lax.top_k``'s order: (scores,
    parent beams, tokens), each [B, W]."""
    bsz, _, vocab = total.shape
    flat = total.reshape(bsz, -1)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :beam_size], idx[:, :beam_size]
    return vals, idx // vocab, (idx % vocab).to(torch.int32)


def restrict_finished(logprobs: torch.Tensor, finished: torch.Tensor,
                      end_id: int) -> torch.Tensor:
    """Finished beams may only continue with ``<end>``, at zero cost:
    logprobs [B, W, V], finished [B, W] bool."""
    fin_row = torch.full((logprobs.shape[-1],), NEG_INF,
                         dtype=logprobs.dtype, device=logprobs.device)
    fin_row[end_id] = 0.0
    return torch.where(finished[..., None], fin_row, logprobs)


def initial_scores(batch: int, beam_size: int, device) -> torch.Tensor:
    """Only beam 0 is live at step 0: [B, W] of 0 and NEG_INF."""
    scores = torch.full((batch, beam_size), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    return scores


def tile_for_beams(tree: State, beam_size: int) -> State:
    """[B, ...] -> [B*W, ...] by repeating each row beam_size times."""
    return {k: torch.repeat_interleave(v, beam_size, dim=0)
            for k, v in tree.items()}


def _gather_beams(tree: State, parent: torch.Tensor) -> State:
    """Reorder [B*W, ...] tensors by per-image parent beams [B, W]."""
    batch, beam = parent.shape
    rows = (torch.arange(batch, device=parent.device)[:, None] * beam
            + parent).reshape(-1)
    return {k: v[rows] for k, v in tree.items()}


def select_best(scores: torch.Tensor, history: torch.Tensor, end_id: int,
                length_penalty: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best beam per image: (tokens [B, L], its score [B]), scores
    divided by length**alpha (GNMT) when ``length_penalty`` alpha > 0."""
    max_length = history.shape[-1]
    if length_penalty > 0.0:
        first_end = torch.argmax((history == end_id).to(torch.int32), dim=-1)
        lengths = torch.clamp(first_end + 1, max=max_length)
        norm = scores / lengths.to(torch.float32) ** length_penalty
    else:
        norm = scores
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(history.shape[0], device=history.device)
    return history[rows, best], norm[rows, best]


def _all_done(finished: torch.Tensor) -> bool:
    """Every beam finished; over several ranks (``parallel/mesh``), every
    rank's: the search of a global batch exits at one step on all ranks,
    as one rank's search of the whole batch would, so that noise drawn a
    step stays in step across the ranks."""
    done = bool(finished.all())
    if not make_mesh().sharded:
        return done
    return not any_rank(not done, finished.device)


def beam_search(step_fn: Callable, init_state: State, batch: int,
                start_id: int, end_id: int, *, beam_size: int = 5,
                max_length: int = 30, length_penalty: float = 0.0,
                early_exit: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_length] int32 of the best beam, scores [B]).

    ``init_state`` tensors are already tiled to [B*W, ...]
    (``tile_for_beams``). ``early_exit`` stops once every beam of every
    image has emitted <end> (over several ranks, of every rank's images).
    It is exact: such a step offers each beam its
    own <end> at an unchanged score, and the top-W order gives back the
    sorted beams with identity parents. Under ``torch.export`` every step
    runs (a graph has no exit that depends on the data).
    """
    early_exit = early_exit and not torch.compiler.is_exporting()
    state = init_state
    device = next(iter(state.values())).device
    scores = initial_scores(batch, beam_size, device)
    prev = torch.full((batch * beam_size,), start_id, dtype=torch.int32,
                      device=device)
    history = torch.full((batch, beam_size, max_length), end_id,
                         dtype=torch.int32, device=device)
    finished = torch.zeros((batch, beam_size), dtype=torch.bool,
                           device=device)
    for t in range(max_length):
        if early_exit and _all_done(finished):
            break
        state, logprobs = step_fn(state, prev, t)
        lp = restrict_finished(
            logprobs.reshape(batch, beam_size, -1).to(torch.float32),
            finished, end_id)
        scores, parent, token = top_w(scores[..., None] + lp, beam_size)
        state = _gather_beams(state, parent)
        history = torch.gather(
            history, 1, parent[..., None].expand(-1, -1, max_length))
        history[:, :, t] = token
        finished = torch.gather(finished, 1, parent) | (token == end_id)
        prev = token.reshape(-1)
    return select_best(scores, history, end_id, length_penalty)
