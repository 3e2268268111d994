"""METEOR 1.5 (pure-Python, offline).

The reference scores METEOR through pycocoevalcap's wrapper around the
METEOR 1.5 Java jar (reference: evaluate_metrix.py:29, spawning
``java -jar meteor-1.5.jar - - -stdio -l en -norm``). Offline and JVM-free,
this module implements the METEOR 1.5 algorithm (Denkowski & Lavie 2014)
with its published English parameters:

    alpha=0.85, beta=0.2, gamma=0.6, delta=0.75
    module weights: exact=1.0, stem=0.6 (syn=0.8, par=0.6 unavailable)

and all four matcher modules — exact and Porter-stem always, WordNet-synonym
and paraphrase when their data files are supplied (the data itself is not
redistributable in this environment, so the offline default runs
exact+stem only). External data hooks, each a path in an environment
variable (or set programmatically via :func:`set_meteor_data`):

* ``METEOR_FUNCTION_WORDS`` — one word per line (#-comments allowed); the
  jar's ``function.words.english`` resource is exactly this format.
* ``METEOR_SYNONYMS`` — one synset per line, whitespace-separated members
  (exportable from WordNet in two lines of nltk); two words match on the
  synonym stage iff they share a synset, the jar's rule.
* ``METEOR_PARAPHRASES`` — lines ``phrase1 ||| phrase2`` (an optional third
  ``||| prob`` field is ignored), ``.gz`` transparent — the layout of the
  jar's ``paraphrase-en.gz``. Multi-word entries are fully supported: the
  aligner matches phrase BLOCKS like the jar (a hypothesis span against a
  reference span of possibly different length), so e.g.
  ``traffic light ||| stoplight`` aligns a 2-word span to a 1-word span.

``tools/export_meteor_data.py`` builds all three files: WordNet synsets via
nltk (``python -m nltk.downloader wordnet`` once, on a connected machine),
a normalizer for the jar's paraphrase table, and a function-word
normalizer. File-to-score coverage: tests/test_meteor_fixture.py pins
worked examples (word-level AND multi-word phrase-block) through the env
hooks against the hand-evaluated METEOR 1.5 formula chain.

Remaining deviations from the jar when no data files are given:

* Fewer matcher stages find fewer matches, so scores are a slight
  *underestimate* of Java METEOR.
* METEOR's English function-word list is derived from corpus frequencies
  (relative frequency > 1e-3); ``_FUNCTION_WORDS`` below is a curated
  high-frequency English function-word list standing in for it (the rule
  is published but the corpus is not, so the exact list cannot be
  reconstructed offline — supply the jar's own list via
  ``METEOR_FUNCTION_WORDS`` for exactness).

Alignment is the jar's objective, solved exactly: among alignments of
non-overlapping phrase matches (each word of each sentence covered at most
once), pick the one with **maximum total word coverage** (hypothesis +
reference covered words), then the **fewest chunks**, breaking remaining
ties by the **smallest total |i-j| start distance** (monotonicity), then by
the largest total module weight. Exact/stem/synonym matches are
single-word spans; the paraphrase module contributes spans of any length
present in the table. The search is a depth-first branch-and-bound over
hypothesis positions with greedy-first ordering, a DP coverage upper
bound, and a node budget; within the budget (always, at caption lengths
<=30 with realistic vocabularies) the result is optimal, and on budget
exhaustion the best alignment found so far is returned (never worse than
the greedy one, which is explored first).

Corpus scoring follows the jar: per segment the best-scoring reference's
match statistics are accumulated, and the final score is computed once from
the aggregated totals (NOT the mean of segment scores). The fragmentation
denominator is the average of covered hypothesis and reference words
(identical to the match count when all matches are single-word).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from depth_image_captioning_pub_torch.metrics.porter import stem

# METEOR 1.5 English task parameters (Denkowski & Lavie 2014, table of
# language defaults; the pycocoevalcap jar runs `-l en` with these).
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
# Module weights for the full en pipeline: exact, stem, synonym, paraphrase
# (Denkowski & Lavie 2014). Stages 2/3 only produce candidates when their
# data files are loaded (see module docstring), so the offline default
# behaves exactly like the previous exact+stem implementation.
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)

# Stand-in for METEOR's corpus-frequency English function-word list
# (see module docstring). Words here get weight (1-delta), content words
# get delta, on each side of the alignment.
_FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither i you he she it we they me him her us them my your his its our
their mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what when where why
how there here
am is are was were be been being do does did doing have has had having
will would shall should can could may might must ought need dare
and or but nor so yet if then else because although though while whereas
unless until since as than whether once
of in on at by for with about against between into through during before
after above below to from up down out off over under again further near
across behind beside besides beyond except inside outside toward towards
upon within without along amid among around atop underneath via per
not only just also too very s t don now d ll m o re ve y ain aren couldn
didn doesn hadn hasn haven isn ma mightn mustn needn shan shouldn wasn
weren won wouldn
. , ; : ! ? ' " ` -
""".split())

_NODE_BUDGET = 200_000


@dataclasses.dataclass(frozen=True)
class MeteorData:
    """External METEOR-1.5 data (module docstring documents the formats).

    ``synsets`` maps word -> frozenset of synset ids; ``paraphrases`` holds
    unordered phrase pairs as frozensets of normalized phrase strings
    (single- or multi-word, space-joined). The jar's table lists both
    directions; storing unordered pairs makes lookup direction-free.
    """
    function_words: frozenset = frozenset()
    synsets: Optional[Dict[str, frozenset]] = None
    paraphrases: Optional[frozenset] = None


def _read_lines(path: str) -> List[str]:
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")]


def load_function_words(path: str) -> frozenset:
    return frozenset(w for ln in _read_lines(path) for w in ln.split())


def load_synsets(path: str) -> Dict[str, frozenset]:
    by_word: Dict[str, set] = {}
    for sid, ln in enumerate(_read_lines(path)):
        for w in ln.split():
            by_word.setdefault(w.lower(), set()).add(sid)
    return {w: frozenset(s) for w, s in by_word.items()}


def load_paraphrases(path: str) -> frozenset:
    """Load a paraphrase table: unordered pairs of normalized phrases.

    Multi-word phrases are kept — the aligner matches phrase blocks like
    the jar (reference: evaluate_metrix.py:29 spawns METEOR 1.5, whose
    paraphrase matcher proposes span<->span matches)."""
    pairs = set()
    for ln in _read_lines(path):
        fields = [f.strip() for f in ln.split("|||")]
        if len(fields) < 2:
            continue
        a = " ".join(fields[0].lower().split())
        b = " ".join(fields[1].lower().split())
        if a and b and a != b:
            pairs.add(frozenset((a, b)))
    return frozenset(pairs)


_data: Optional[MeteorData] = None
# Derived phrase index for the active paraphrase table:
# (dict phrase -> frozenset(partner phrases), max phrase word-length).
_par_index: Optional[Tuple[Dict[str, frozenset], int]] = None


def set_meteor_data(data: Optional[MeteorData]) -> None:
    """Install external METEOR data (None -> re-read env at next use)."""
    global _data, _par_index
    _data = data
    _par_index = None


def _active_data() -> MeteorData:
    """Lazily build the active data from the METEOR_* env hooks."""
    global _data
    if _data is None:
        import os
        fw_path = os.environ.get("METEOR_FUNCTION_WORDS")
        syn_path = os.environ.get("METEOR_SYNONYMS")
        par_path = os.environ.get("METEOR_PARAPHRASES")
        _data = MeteorData(
            function_words=(load_function_words(fw_path) if fw_path
                            else _FUNCTION_WORDS),
            synsets=load_synsets(syn_path) if syn_path else None,
            paraphrases=load_paraphrases(par_path) if par_path else None)
    return _data


def _active_par_index() -> Tuple[Dict[str, frozenset], int]:
    """Phrase -> partners lookup for the active paraphrase table."""
    global _par_index
    if _par_index is None:
        data = _active_data()
        by_phrase: Dict[str, set] = {}
        max_len = 1
        for pair in (data.paraphrases or ()):
            members = tuple(pair)
            if len(members) != 2:
                continue
            a, b = members
            by_phrase.setdefault(a, set()).add(b)
            by_phrase.setdefault(b, set()).add(a)
            max_len = max(max_len, len(a.split()), len(b.split()))
        _par_index = ({p: frozenset(s) for p, s in by_phrase.items()},
                      max_len)
    return _par_index


def _is_function(word: str) -> bool:
    return word in _active_data().function_words


def _candidates(hyp: Sequence[str], ref: Sequence[str]
                ) -> List[List[Tuple[int, int]]]:
    """Per hyp position: [(ref position, stage)] — WORD-level candidates:
    stage 0 exact, 1 stem, 2 synonym (shared synset), 3 paraphrase
    (single-word table pair).

    A pair matchable by several modules gets the earliest one (the jar
    assigns each match to the first module that finds it). Kept as the
    word-level view for brute-force cross-checks; production alignment
    goes through :func:`_phrase_candidates`, which adds multi-word
    paraphrase spans.
    """
    data = _active_data()
    par, _ = _active_par_index()
    ref_stems = [stem(w) for w in ref]
    empty: frozenset = frozenset()
    out: List[List[Tuple[int, int]]] = []
    for i, hw in enumerate(hyp):
        hs = stem(hw)
        h_syn = data.synsets.get(hw, empty) if data.synsets else empty
        h_par = par.get(hw, empty)
        row = []
        for j, rw in enumerate(ref):
            if hw == rw:
                row.append((j, 0))
            elif hs == ref_stems[j]:
                row.append((j, 1))
            elif h_syn and h_syn & data.synsets.get(rw, empty):
                row.append((j, 2))
            elif rw in h_par:
                row.append((j, 3))
        # Greedy-first ordering: closest ref position first so the first
        # DFS leaf reproduces (at least) the monotone greedy alignment.
        row.sort(key=lambda jt: (abs(jt[0] - i), jt[0]))
        out.append(row)
    return out


# A phrase match: (h_len, r_start, r_len, stage), grouped by h_start.
def _phrase_candidates(hyp: Sequence[str], ref: Sequence[str]
                       ) -> List[List[Tuple[int, int, int, int]]]:
    """Per hyp position i: [(h_len, r_start, r_len, stage)].

    Word-level stages contribute (1, j, 1, stage) exactly as
    :func:`_candidates`; the paraphrase module additionally contributes
    multi-word span matches (h span text and ref span text form a table
    pair). Rows are sorted coverage-first then closest-first so the first
    DFS leaf is a strong greedy alignment.
    """
    word_rows = _candidates(hyp, ref)
    out: List[List[Tuple[int, int, int, int]]] = [
        [(1, j, 1, s) for j, s in row] for row in word_rows]
    par, max_len = _active_par_index()
    if par and max_len > 1:
        # All ref span texts up to max_len, for O(1) partner lookup.
        ref_spans: Dict[str, List[Tuple[int, int]]] = {}
        for rj in range(len(ref)):
            for rl in range(1, min(max_len, len(ref) - rj) + 1):
                ref_spans.setdefault(" ".join(ref[rj:rj + rl]),
                                     []).append((rj, rl))
        for i in range(len(hyp)):
            for hl in range(1, min(max_len, len(hyp) - i) + 1):
                partners = par.get(" ".join(hyp[i:i + hl]))
                if not partners:
                    continue
                for p in partners:
                    for rj, rl in ref_spans.get(p, ()):
                        if hl == 1 and rl == 1:
                            continue  # single<->single handled word-level
                        out[i].append((hl, rj, rl, 3))
    for i, row in enumerate(out):
        row.sort(key=lambda m: (-(m[0] + m[2]), abs(m[1] - i), m[1]))
    return out


def align_phrases(hyp: Sequence[str], ref: Sequence[str]
                  ) -> List[Tuple[int, int, int, int, int]]:
    """Optimal METEOR phrase alignment:
    list of (h_start, h_len, r_start, r_len, stage), ordered by h_start.

    Objective (lexicographic): maximum total covered words (hyp + ref),
    fewest chunks, least total |h_start - r_start|, largest total
    module-weighted coverage (exact preferred over stem).
    """
    cands = _phrase_candidates(hyp, ref)
    n_h, n_r = len(hyp), len(ref)
    if not any(cands):
        return []

    # DP coverage upper bound from hyp position i on (ignores ref-side
    # conflicts, so it never underestimates).
    ub = [0] * (n_h + 1)
    for i in range(n_h - 1, -1, -1):
        best_i = ub[i + 1]
        for hl, _rj, rl, _s in cands[i]:
            best_i = max(best_i, hl + rl + ub[i + hl])
        ub[i] = best_i

    def greedy_seed() -> List[Tuple[int, int, int, int, int]]:
        """Coverage-greedy alignment: guarantees a non-None result even if
        the node budget exhausts before the DFS reaches its first leaf
        (pathological repeated-word inputs)."""
        used = [False] * n_r
        pairs = []
        i = 0
        while i < n_h:
            taken = False
            for hl, rj, rl, s in cands[i]:
                if not any(used[rj:rj + rl]):
                    for j in range(rj, rj + rl):
                        used[j] = True
                    pairs.append((i, hl, rj, rl, s))
                    i += hl
                    taken = True
                    break
            if not taken:
                i += 1
        return pairs

    seed = greedy_seed()
    seed_cov = sum(hl + rl for _, hl, _, rl, _ in seed)
    best: List[List[Tuple[int, int, int, int, int]]] = [seed]
    # The seed's coverage is a valid bar, but its (chunks, dist) only
    # become the pruning bar once a DFS leaf confirms them at maximum
    # coverage (otherwise they could wrongly prune better alignments).
    inf = float("inf")
    best_key = [(-seed_cov, inf, inf, inf)]
    used_r = [False] * n_r
    nodes = [0]

    def dfs(i: int, cov: int, pairs: List[Tuple[int, int, int, int, int]],
            chunks: int, dist: int, wsum: float) -> None:
        if nodes[0] > _NODE_BUDGET:
            return
        nodes[0] += 1
        bk = best_key[0]
        potential = cov + ub[i]
        if -potential > bk[0]:
            return  # cannot reach the best coverage anymore
        if -potential == bk[0]:
            # Can at best tie on coverage; chunks and distance only grow
            # as matches append, so dominance pruning is sound here.
            if chunks > bk[1] or (chunks == bk[1] and dist > bk[2]):
                return
        if i == n_h:
            key = (-cov, chunks, dist, -wsum)
            if key < bk:
                best_key[0] = key
                best[0] = list(pairs)
            return
        for hl, rj, rl, s in cands[i]:
            if any(used_r[rj:rj + rl]):
                continue
            if pairs:
                h0, hl0, r0, rl0, _ = pairs[-1]
                nchunks = chunks + (0 if (i == h0 + hl0 and rj == r0 + rl0)
                                    else 1)
            else:
                nchunks = 1
            for j in range(rj, rj + rl):
                used_r[j] = True
            pairs.append((i, hl, rj, rl, s))
            dfs(i + hl, cov + hl + rl, pairs, nchunks, dist + abs(i - rj),
                wsum + STAGE_WEIGHTS[s] * (hl + rl))
            pairs.pop()
            for j in range(rj, rj + rl):
                used_r[j] = False
        # Skipping hyp word i is only useful when a candidate conflicts.
        dfs(i + 1, cov, pairs, chunks, dist, wsum)

    dfs(0, 0, [], 0, 0, 0.0)
    return best[0]


def align(hyp: Sequence[str], ref: Sequence[str]
          ) -> List[Tuple[int, int, int]]:
    """Word-level view of the optimal alignment: (hyp_idx, ref_idx, stage)
    triples, one per single-word match (multi-word phrase-block matches —
    possible only with multi-word paraphrase data installed — are reported
    by their start positions). Kept for the word-level optimality tests;
    scoring uses :func:`align_phrases` directly.
    """
    return [(h, r, s) for h, _hl, r, _rl, s in align_phrases(hyp, ref)]


@dataclasses.dataclass
class MeteorStats:
    """Per-segment match statistics, summable for corpus scoring."""
    h_len_c: int = 0
    h_len_f: int = 0
    r_len_c: int = 0
    r_len_f: int = 0
    h_match_c: float = 0.0   # module-weighted matched content words (hyp)
    h_match_f: float = 0.0
    r_match_c: float = 0.0
    r_match_f: float = 0.0
    matches_h: int = 0       # covered hypothesis words
    matches_r: int = 0       # covered reference words
    chunks: int = 0

    @property
    def matches(self) -> float:
        """Average covered words (the fragmentation denominator); equals
        the match count when every match is single-word."""
        return (self.matches_h + self.matches_r) / 2.0

    def add(self, o: "MeteorStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))


def _chunk_count(pairs: List[Tuple[int, int, int, int, int]]) -> int:
    """Chunks over phrase matches ordered by h_start: a match continues
    the current chunk iff it is adjacent to the previous one in BOTH
    sentences (jar rule, span-aware)."""
    if not pairs:
        return 0
    chunks = 1
    for (h0, hl0, r0, rl0, _), (h1, _, r1, _, _) in zip(pairs, pairs[1:]):
        if not (h1 == h0 + hl0 and r1 == r0 + rl0):
            chunks += 1
    return chunks


def segment_stats(hyp: Sequence[str], ref: Sequence[str]) -> MeteorStats:
    st = MeteorStats()
    for w in hyp:
        if _is_function(w):
            st.h_len_f += 1
        else:
            st.h_len_c += 1
    for w in ref:
        if _is_function(w):
            st.r_len_f += 1
        else:
            st.r_len_c += 1
    pairs = align_phrases(hyp, ref)
    st.matches_h = sum(hl for _, hl, _, _, _ in pairs)
    st.matches_r = sum(rl for _, _, _, rl, _ in pairs)
    st.chunks = _chunk_count(pairs)
    for h0, hl, r0, rl, stage in pairs:
        w = STAGE_WEIGHTS[stage]
        for i in range(h0, h0 + hl):
            if _is_function(hyp[i]):
                st.h_match_f += w
            else:
                st.h_match_c += w
        for j in range(r0, r0 + rl):
            if _is_function(ref[j]):
                st.r_match_f += w
            else:
                st.r_match_c += w
    return st


def score_from_stats(st: MeteorStats) -> float:
    p_den = DELTA * st.h_len_c + (1 - DELTA) * st.h_len_f
    r_den = DELTA * st.r_len_c + (1 - DELTA) * st.r_len_f
    if st.matches == 0 or p_den == 0 or r_den == 0:
        return 0.0
    p = (DELTA * st.h_match_c + (1 - DELTA) * st.h_match_f) / p_den
    r = (DELTA * st.r_match_c + (1 - DELTA) * st.r_match_f) / r_den
    if p == 0.0 or r == 0.0:
        return 0.0
    f_mean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    frag = st.chunks / st.matches
    return f_mean * (1.0 - GAMMA * frag ** BETA)


def meteor_pair(hypothesis: str, reference: str) -> float:
    """Segment-level METEOR of one hypothesis vs one reference."""
    hyp, ref = hypothesis.split(), reference.split()
    if not hyp or not ref:
        return 0.0
    return score_from_stats(segment_stats(hyp, ref))


def meteor_sentence(hypothesis: str, references: List[str]) -> float:
    """Best segment score over the reference set (METEOR's multi-ref rule)."""
    return max(meteor_pair(hypothesis, r) for r in references)


def score_meteor(gts: Dict[int, List[str]],
                 res: Dict[int, List[str]]) -> float:
    """Corpus METEOR, jar semantics: per segment keep the best-scoring
    reference's stats, sum stats over segments, score the totals once."""
    total = MeteorStats()
    any_seg = False
    for k in sorted(gts.keys()):
        hyp = res[k][0].split()
        best_st: Optional[MeteorStats] = None
        best_score = -1.0
        for r in gts[k]:
            ref = r.split()
            if not hyp or not ref:
                st = MeteorStats(
                    h_len_c=sum(not _is_function(w) for w in hyp),
                    h_len_f=sum(_is_function(w) for w in hyp),
                    r_len_c=sum(not _is_function(w) for w in ref),
                    r_len_f=sum(_is_function(w) for w in ref))
            else:
                st = segment_stats(hyp, ref)
            s = score_from_stats(st)
            if s > best_score:
                best_score, best_st = s, st
        if best_st is not None:
            total.add(best_st)
            any_seg = True
    if not any_seg:
        return 0.0
    return score_from_stats(total)
