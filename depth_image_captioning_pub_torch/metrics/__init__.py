"""Self-contained caption metrics (BLEU / METEOR / ROUGE-L / CIDEr).

The reference scores with pycocoevalcap (reference: Captioning_models/
evaluate_metrix.py:27-32), which is not available in this environment (and
its METEOR spawns a Java subprocess). This package reimplements the same
corpus-level math in pure Python/NumPy:

* BLEU-1..4 — pycocoevalcap bleu_scorer semantics: corpus totals, clipped
  n-gram counts, 'closest' effective reference length, brevity penalty.
* ROUGE-L — LCS F-measure, beta=1.2, max over references, mean over corpus.
* CIDEr — pycocoevalcap cider_scorer: tf-idf n-gram vectors (n=1..4), df
  from the evaluation references, Gaussian length penalty sigma=6, x10.
* METEOR — pure-Python METEOR 1.5: published en parameters (alpha=0.85,
  beta=0.2, gamma=0.6, delta=0.75), optimal chunk-minimizing alignment,
  function-word weighting, corpus score from aggregated stats (jar
  semantics). Exact + Porter-stem matcher modules always; the WordNet
  synonym and paraphrase modules activate when a user supplies the jar's
  data files via $METEOR_SYNONYMS / $METEOR_PARAPHRASES (and the exact
  function-word list via $METEOR_FUNCTION_WORDS) — offline default without
  them is a documented slight underestimate, same scale otherwise.

All scorers are host-side (outside jit), as in the reference.
"""

from depth_image_captioning_pub_torch.metrics.scorer import load_textfiles, score
