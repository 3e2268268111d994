"""Scoring facade matching the reference's evaluate_metrix API.

``load_textfiles(references, hypothesis)`` and ``score(ref, hypo)`` keep the
exact call shape of the reference (reference: evaluate_metrix.py:6-42): refs
is a list (per image) of lists of caption strings, hypos a list of generated
strings; score returns {"Bleu_1".."Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from depth_image_captioning_pub_torch.metrics.bleu import score_bleu
from depth_image_captioning_pub_torch.metrics.cider import score_cider
from depth_image_captioning_pub_torch.metrics.meteor import score_meteor
from depth_image_captioning_pub_torch.metrics.rouge import score_rouge


def load_textfiles(references: List[List[str]], hypothesis: List[str]
                   ) -> Tuple[Dict[int, List[str]], Dict[int, List[str]]]:
    """Build {index: refs} / {index: [hypo]} dicts; validates like the
    reference (evaluate_metrix.py:10-18): every hypo needs its refs."""
    hypo = {idx: [line.strip()] for idx, line in enumerate(hypothesis)}
    refs = {idx: [r.strip() for r in rr] for idx, rr in enumerate(references)}
    if len(hypo) != len(refs):
        raise ValueError(
            f"There is a sentence number mismatch between the inputs: "
            f"{len(refs)} refs vs {len(hypo)} hypos")
    return refs, hypo


def score(ref: Dict[int, List[str]], hypo: Dict[int, List[str]]
          ) -> Dict[str, float]:
    """BLEU-1..4 / METEOR / ROUGE_L / CIDEr, pycocoevalcap-compatible keys
    and scale (reference: evaluate_metrix.py:21-42)."""
    out: Dict[str, float] = {}
    out.update(score_bleu(ref, hypo))
    out["METEOR"] = score_meteor(ref, hypo)
    out["ROUGE_L"] = score_rouge(ref, hypo)
    out["CIDEr"], _ = score_cider(ref, hypo)
    return out
