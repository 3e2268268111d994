"""Faults planted under the timed path, each of the kinds a cell can have:
a token altered where it is produced, a decode step that leaves its
state unchanged, half of the batch left out. A run with one of them has
to come out not correct; the tests plant them at a tiny size, and ``control.py
--fault NAME`` at the cell's own size on the card, for their readings.

Each is a function of a ``pytest.MonkeyPatch``-like ``patch`` (its
``setattr``), undone when the patch is.
"""

from __future__ import annotations


def alter_token(patch) -> None:
    """The greedy decode's first token of every row moved by one."""
    from depth_image_captioning_pub_torch.models import decoder
    real = decoder.fused_greedy_decode

    def altered(*args, **kwargs):
        toks = real(*args, **kwargs)
        toks[:, 0] = (toks[:, 0] + 1) % args[4].embed.shape[0]
        return toks
    patch.setattr(decoder, "fused_greedy_decode", altered)


def state_unchanged_decode(patch) -> None:
    """The decode step returns the LSTM's state unchanged (the plain
    version's step, which CPU tensors run)."""
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, decode_step)

    def frozen_step(features, features_proj, emb, h, c, p):
        _, _, alpha = decode_step.attention_lstm_step(
            features, features_proj, emb, h, c, p)
        return h, c, alpha
    patch.setattr(decode_seq, "attention_lstm_step", frozen_step)


def half_batch_encoder(patch) -> None:
    """The RGB encoder computes the first half of the batch and repeats
    it over the rest."""
    from depth_image_captioning_pub_torch.models import resnet
    real = resnet.AttentionGridEncoder.forward

    def half(self, images):
        n = images.shape[0]
        out = real(self, images[:max(1, n // 2)])
        return out.repeat(-(-n // out.shape[0]), 1, 1)[:n]
    patch.setattr(resnet.AttentionGridEncoder, "forward", half)


CAPTIONING = (alter_token, state_unchanged_decode, half_batch_encoder)
BY_NAME = {f.__name__: f for f in CAPTIONING}
