"""Corpus BLEU with pycocoevalcap bleu_scorer semantics.

Equivalent math to the Bleu(4) wrapper the reference calls
(reference: evaluate_metrix.py:27-37): clipped n-gram precision accumulated
over the corpus, effective reference length chosen per-sentence by the
'closest' rule, corpus-level brevity penalty, and the same tiny/small
division fudge constants so scores agree to ~1e-9.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_SMALL = 1e-9
_TINY = 1e-15  # so that if guess is 0 still return 0


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _closest_ref_len(hyp_len: int, ref_lens: List[int]) -> int:
    """'closest' option: min |ref-hyp|, ties -> shorter ref."""
    return min(ref_lens, key=lambda r: (abs(r - hyp_len), r))


def corpus_bleu(references: List[List[str]], hypotheses: List[str],
                max_n: int = 4) -> Tuple[List[float], List[List[float]]]:
    """Returns ([Bleu_1..Bleu_n] corpus scores, per-image running scores).

    references[i]: list of reference strings for image i;
    hypotheses[i]: one hypothesis string. Tokenization is whitespace split,
    matching pycocoevalcap's precook().
    """
    assert len(references) == len(hypotheses)
    total_correct = [0] * max_n
    total_guess = [0] * max_n
    total_hyp_len = 0
    total_ref_len = 0
    per_image: List[List[float]] = []

    for refs, hyp in zip(references, hypotheses):
        hyp_toks = hyp.split()
        ref_toks = [r.split() for r in refs]
        total_hyp_len += len(hyp_toks)
        total_ref_len += _closest_ref_len(len(hyp_toks),
                                          [len(r) for r in ref_toks])
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp_toks, n)
            max_ref: Counter = Counter()
            for rt in ref_toks:
                for ng, c in _ngrams(rt, n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            correct = sum(min(c, max_ref[ng]) for ng, c in hyp_counts.items())
            total_correct[n - 1] += correct
            total_guess[n - 1] += max(0, len(hyp_toks) - n + 1)
        per_image.append(_bleu_from_totals(
            total_correct, total_guess, total_hyp_len, total_ref_len, max_n))

    return _bleu_from_totals(total_correct, total_guess, total_hyp_len,
                             total_ref_len, max_n), per_image


def _bleu_from_totals(correct, guess, hyp_len, ref_len, max_n) -> List[float]:
    bleus = []
    log_acc = 0.0
    ratio = hyp_len / (ref_len + _SMALL)
    # ratio == 0 (empty hypothesis corpus) -> exp(-inf) -> 0, matching
    # pycocoevalcap's numpy semantics without the ZeroDivisionError
    if ratio <= 0.0:
        bp = 0.0
    elif ratio < 1.0:
        bp = math.exp(1.0 - 1.0 / ratio)
    else:
        bp = 1.0
    for n in range(max_n):
        prec = (correct[n] + _TINY) / (guess[n] + _SMALL)
        log_acc += math.log(prec)
        bleus.append(math.exp(log_acc / (n + 1)) * bp)
    return bleus


def score_bleu(gts: Dict[int, List[str]], res: Dict[int, List[str]],
               max_n: int = 4) -> Dict[str, float]:
    keys = sorted(gts.keys())
    refs = [gts[k] for k in keys]
    hyps = [res[k][0] for k in keys]
    corpus, _ = corpus_bleu(refs, hyps, max_n)
    return {f"Bleu_{i + 1}": corpus[i] for i in range(max_n)}
