"""ROUGE-L with pycocoevalcap semantics.

The reference computes ROUGE_L via pycocoevalcap's Rouge()
(reference: evaluate_metrix.py:30, :38): per image, the LCS-based
F-measure (beta=1.2) taking the max precision and max recall over the
reference set, averaged over the corpus.
"""

from __future__ import annotations

from typing import Dict, List

_BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Classic O(len(a)*len(b)) LCS length with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hypothesis: str, references: List[str]) -> float:
    hyp = hypothesis.split()
    prec, rec = [], []
    for ref in references:
        rt = ref.split()
        lcs = _lcs_len(hyp, rt)
        prec.append(lcs / len(hyp) if hyp else 0.0)
        rec.append(lcs / len(rt) if rt else 0.0)
    p, r = max(prec), max(rec)
    if p != 0 and r != 0:
        return ((1 + _BETA ** 2) * p * r) / (r + _BETA ** 2 * p)
    return 0.0


def score_rouge(gts: Dict[int, List[str]],
                res: Dict[int, List[str]]) -> float:
    keys = sorted(gts.keys())
    vals = [rouge_l_sentence(res[k][0], gts[k]) for k in keys]
    return sum(vals) / len(vals) if vals else 0.0
