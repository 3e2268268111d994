"""Caption detokenizer and the special tokens (the port's own copy of what
it uses from the JAX package's ``data/tokenizer.py``; the same behaviour)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    start: str = "<start>"
    end: str = "<end>"
    unk: str = "<unk>"
    null: str = "<null>"


SPECIAL = SpecialTokens()


def clean_tokens(caption: str) -> List[str]:
    """Lowercase and split; drop bare ``.``/``,`` tokens, then strip
    trailing periods and then trailing commas (the reference tokenizer)."""
    out = []
    for token in caption.lower().split():
        if token == "." or token == ",":
            continue
        out.append(token.rstrip(".").rstrip(","))
    return out


def untokenize_caption(caption: str, word_to_id: Dict[str, int]) -> str:
    """Normalize a raw reference caption for scoring: cleaned as above,
    out-of-vocabulary words replaced with the literal ``<unk>``."""
    words = [w if w in word_to_id else SPECIAL.unk
             for w in clean_tokens(caption)]
    return " ".join(words)


def ids_to_caption(ids: Sequence[int], id_to_word: Dict[int, str]) -> str:
    """Token ids -> caption string: stop at <end>, skip <start>."""
    words = []
    for i in ids:
        w = id_to_word[int(i)]
        if w == SPECIAL.end:
            break
        if w != SPECIAL.start:
            words.append(w)
    return " ".join(words)
