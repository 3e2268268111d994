"""CIDEr with pycocoevalcap cider_scorer semantics.

Reference path: evaluate_metrix.py:31-40 calls Cider() with n=4, sigma=6.0.
Math reproduced exactly: document frequency over the evaluation references,
tf-idf n-gram vectors with weight tf * (log(N) - log(df)), clipped cosine
per n with a Gaussian length-difference penalty, averaged over references
and n, scaled by 10 (the "CIDEr is x10" note at evaluate_metrix.py:33).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

_N = 4
_SIGMA = 6.0


def _ngram_counts(text: str, n: int = _N) -> Counter:
    toks = text.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(toks) - k + 1):
            counts[tuple(toks[i:i + k])] += 1
    return counts


def _counts_to_vec(cnts: Counter, log_n: float, doc_freq: Dict
                   ) -> Tuple[List[Dict], List[float], int]:
    vec = [defaultdict(float) for _ in range(_N)]
    norm = [0.0] * _N
    length = 0
    for ngram, tf in cnts.items():
        df = math.log(max(1.0, doc_freq[ngram]))
        k = len(ngram) - 1
        vec[k][ngram] = float(tf) * (log_n - df)
        norm[k] += vec[k][ngram] ** 2
        if k == 0:
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


def _sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r) -> List[float]:
    delta = float(len_h - len_r)
    val = [0.0] * _N
    for k in range(_N):
        for ngram, w in vec_h[k].items():
            # CIDEr-D clipping: min(hyp, ref) * ref
            val[k] += min(w, vec_r[k][ngram]) * vec_r[k][ngram]
        if norm_h[k] != 0 and norm_r[k] != 0:
            val[k] /= norm_h[k] * norm_r[k]
        val[k] *= math.exp(-(delta ** 2) / (2 * _SIGMA ** 2))
    return val


def score_cider(gts: Dict[int, List[str]],
                res: Dict[int, List[str]]) -> Tuple[float, List[float]]:
    keys = sorted(gts.keys())
    # document frequency: one count per image whose reference set contains
    # the ngram (pycocoevalcap compute_doc_freq)
    doc_freq: Dict = defaultdict(float)
    ref_counts = {}
    for k in keys:
        per_ref = [_ngram_counts(r) for r in gts[k]]
        ref_counts[k] = per_ref
        seen = set()
        for c in per_ref:
            seen.update(c.keys())
        for ng in seen:
            doc_freq[ng] += 1
    log_n = math.log(max(1, len(keys)))
    scores = []
    for k in keys:
        vec_h, norm_h, len_h = _counts_to_vec(_ngram_counts(res[k][0]),
                                              log_n, doc_freq)
        acc = [0.0] * _N
        for rc in ref_counts[k]:
            vec_r, norm_r, len_r = _counts_to_vec(rc, log_n, doc_freq)
            s = _sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r)
            acc = [a + b for a, b in zip(acc, s)]
        score = (sum(acc) / _N) / len(ref_counts[k]) * 10.0
        scores.append(score)
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores
