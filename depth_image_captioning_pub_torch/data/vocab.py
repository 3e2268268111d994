"""Vocabulary loading (the port's own copy of ``load_vocab`` from the JAX
package's ``data/vocab.py``): the pickled ``word_to_id`` table that the
vocabulary builder writes."""

from __future__ import annotations

import pickle
from typing import Dict, Tuple


def load_vocab(word_to_id_path: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    with open(word_to_id_path, "rb") as f:
        word_to_id = pickle.load(f)
    return word_to_id, {i: w for w, i in word_to_id.items()}
