"""Pure-python METEOR (exact + Porter-stem stages, original formulation).
Port of vacnic_tpu/eval/meteor_py.py, output for output.

The reference scores METEOR through pycocoevalcap's bundled Java jar over a
stdin/stdout pipe (train...match.py:543-548) — absent without java.
This implements the original METEOR algorithm (Banerjee & Lavie 2005, the
formulation nltk also uses): stage-wise unigram alignment (exact, then
stemmed), F_mean = P·R/(α·P+(1−α)·R) with α=0.9, fragmentation penalty
γ·(chunks/matches)^β with γ=0.5, β=3.

NOT numerically identical to meteor-1.5 (no synonym/paraphrase stages, no
tuned weights); results are labeled `meteor_py` so they are never confused
with jar scores. Debug only: compute_caption_metrics adds it under
VACNIC_METEOR_DEBUG=1.
"""

from __future__ import annotations

from typing import Callable, Sequence

from vacnic_tpu_torch.eval import porter


_porter = porter.stem  # nltk's default PorterStemmer rules, without nltk


def _align(hyp: Sequence[str], ref: Sequence[str]) -> list[tuple[int, int]]:
    """Stage-wise greedy alignment: exact matches first, then stem matches,
    each stage matching left-to-right on the first free candidate."""
    matches: list[tuple[int, int]] = []
    used_h: set[int] = set()
    used_r: set[int] = set()

    def stage(key: Callable[[str], str]):
        for i, hw in enumerate(hyp):
            if i in used_h:
                continue
            hk = key(hw)
            for j, rw in enumerate(ref):
                if j in used_r:
                    continue
                if hk == key(rw):
                    matches.append((i, j))
                    used_h.add(i)
                    used_r.add(j)
                    break

    stage(lambda w: w)
    stage(_porter)
    return sorted(matches)


def _chunks(matches: list[tuple[int, int]]) -> int:
    """Minimum runs of contiguous, order-preserving matches."""
    if not matches:
        return 0
    by_h = sorted(matches)
    chunks = 1
    for (h0, r0), (h1, r1) in zip(by_h, by_h[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def meteor_sentence(hypothesis: str, reference: str, *, alpha: float = 0.9,
                    beta: float = 3.0, gamma: float = 0.5) -> float:
    hyp = hypothesis.lower().split()
    ref = reference.lower().split()
    if not hyp or not ref:
        return 0.0
    matches = _align(hyp, ref)
    m = len(matches)
    if m == 0:
        return 0.0
    p = m / len(hyp)
    r = m / len(ref)
    f_mean = (p * r) / (alpha * p + (1 - alpha) * r)
    frag = _chunks(matches) / m
    penalty = gamma * frag**beta
    return f_mean * (1.0 - penalty)


def meteor_corpus(pairs: Sequence[tuple[str, str]]) -> float:
    """Mean sentence-level METEOR over (hypothesis, reference) pairs."""
    if not pairs:
        return 0.0
    return sum(meteor_sentence(h, r) for h, r in pairs) / len(pairs)
