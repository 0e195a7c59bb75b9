"""METEOR 1.5 scorer — jar-compatible formula, pure Python.
Port of vacnic_tpu/eval/meteor15.py, output for output.

The reference computes METEOR through pycocoevalcap's bundled
``meteor-1.5.jar`` over a stdin/stdout pipe (train...match.py:543-548,
572-580). This module provides the same metric two ways:

  * `JarMeteor` — drives a real meteor jar when one is present (the exact
    ``SCORE ||| ref ||| hyp`` / ``EVAL ||| stats`` line protocol the
    reference's monkey-patched ``_stat`` speaks);
  * `meteor15_*` — a Python implementation of the Meteor 1.5 scoring
    formula (Denkowski & Lavie 2014) with the English rank-task parameters:
    α=0.85, β=0.2, γ=0.6, δ=0.75; matcher weights exact=1.0, stem=0.6.

Fidelity statement (be precise about what is and is not reproduced):
  * the scoring formula (weighted P/R with content/function-word δ
    weighting, Fmean, fragmentation penalty, perfect-match chunk waiver,
    corpus-level micro-aggregation, best-reference selection) follows the
    meteor-1.5 definition;
  * matchers: exact and Porter-stem stages. The jar's synonym (WordNet) and
    paraphrase-table stages need resource files the package does not ship, so
    scores can differ from the jar on pairs that only those stages align;
  * the aligner is a beam search maximizing weighted matches then
    minimizing chunks (beam 40), mirroring the jar's resolution objective.
Outputs are reported under "meteor" with a "meteor_scorer" provenance tag so
jar scores are never confused with Python scores.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import Sequence

from vacnic_tpu_torch.eval import porter

# English function words: meteor's function.words resource is the set of
# high-frequency closed-class words; this embeds the standard closed classes
# (articles, prepositions, conjunctions, pronouns, auxiliaries, particles).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either neither
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
yourselves themselves who whom whose which what when where why how
and or but nor so yet for although because since unless while whereas if then
than as of in on at by with from to into onto upon about against between
among through during before after above below under over up down out off
near without within along across behind beyond plus except
be am is are was were been being have has had having do does did doing
will would shall should may might must can could ought
not n't there here also just only very too quite rather
""".split())

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM = 1.0, 0.6
BEAM = 40

_stem = porter.stem  # nltk's default PorterStemmer rules, without nltk


def _normalize(text: str) -> list[str]:
    """Meteor -norm: lowercase + punctuation tokenization (the jar splits
    punctuation from words and normalizes unicode quotes/dashes)."""
    out = []
    text = (text.replace("’", "'").replace("‘", "'")
            .replace("“", '"').replace("”", '"')
            .replace("–", "-").replace("—", "-"))
    word = []
    for ch in text.lower():
        if ch.isalnum() or ch == "'":
            word.append(ch)
        else:
            if word:
                out.append("".join(word))
                word = []
            if not ch.isspace():
                out.append(ch)
    if word:
        out.append("".join(word))
    return out


def _align(hyp: list[str], ref: list[str]) -> list[tuple[int, int, float]]:
    """1:1 alignment maximizing (weighted matches, then −chunks): beam search
    over hypothesis positions (the jar's Aligner resolution objective)."""
    hyp_stem = [_stem(w) for w in hyp]
    ref_stem = [_stem(w) for w in ref]
    cands: list[list[tuple[int, float]]] = []
    for i, hw in enumerate(hyp):
        c: dict[int, float] = {}
        for j, rw in enumerate(ref):
            if hw == rw:
                c[j] = W_EXACT
            elif hyp_stem[i] == ref_stem[j]:
                c.setdefault(j, W_STEM)
        cands.append(sorted(c.items()))

    # state: (neg_weight, chunks, last_j, used_frozenset, matches_tuple)
    init = (0.0, 0, -2, frozenset(), ())
    beam = [init]
    for i in range(len(hyp)):
        nxt = []
        for (negw, chunks, last_j, used, matches) in beam:
            nxt.append((negw, chunks, -2, used, matches))  # skip word i
            for j, w in cands[i]:
                if j in used:
                    continue
                contiguous = (last_j == j - 1) and matches and matches[-1][0] == i - 1
                nxt.append((negw - w, chunks + (0 if contiguous else 1), j,
                            used | {j}, matches + ((i, j, w),)))
        nxt.sort(key=lambda s: (s[0], s[1]))
        beam = nxt[:BEAM]
    best = min(beam, key=lambda s: (s[0], s[1]))
    return list(best[4])


class SegmentStats:
    """The sufficient statistics the jar emits per segment (stats line)."""

    __slots__ = ("p_num", "r_num", "p_den", "r_den", "chunks", "m_raw",
                 "hyp_len", "ref_len")

    def __init__(self, hyp: str, ref: str):
        h, r = _normalize(hyp), _normalize(ref)
        self.hyp_len, self.ref_len = len(h), len(r)
        wgt = lambda w: DELTA if w not in FUNCTION_WORDS else 1.0 - DELTA
        self.p_den = sum(wgt(w) for w in h)
        self.r_den = sum(wgt(w) for w in r)
        matches = _align(h, r)
        self.m_raw = len(matches)
        self.p_num = sum(w * wgt(h[i]) for i, j, w in matches)
        self.r_num = sum(w * wgt(r[j]) for i, j, w in matches)
        # chunk count over the selected alignment
        chunks = 0
        prev = None
        for i, j, _w in matches:
            if prev is None or (i != prev[0] + 1 or j != prev[1] + 1):
                chunks += 1
            prev = (i, j)
        # perfect match in a single chunk → no fragmentation (jar behavior:
        # identical sentences score fmean, not fmean·(1−γ·m^−β))
        if (chunks == 1 and self.m_raw == self.hyp_len == self.ref_len):
            chunks = 0
        self.chunks = chunks


def _score_from(p_num, r_num, p_den, r_den, chunks, m_raw) -> float:
    if p_den == 0 or r_den == 0 or m_raw == 0:
        return 0.0
    p = p_num / p_den
    r = r_num / r_den
    if p == 0 or r == 0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    frag = (chunks / m_raw) if chunks > 0 else 0.0
    return (1.0 - GAMMA * frag**BETA if frag > 0 else 1.0) * fmean


def meteor15_sentence(hypothesis: str, references: Sequence[str]) -> float:
    """Best score over the references (the jar scores each and keeps max)."""
    best = 0.0
    for ref in references:
        s = SegmentStats(hypothesis, ref)
        best = max(best, _score_from(s.p_num, s.r_num, s.p_den, s.r_den,
                                     s.chunks, s.m_raw))
    return best


def meteor15_corpus(hypotheses: Sequence[str],
                    references: Sequence[Sequence[str]]) -> float:
    """Corpus score: micro-aggregate the best-reference segment statistics
    (the jar's EVAL aggregation), matching pycocoevalcap's compute_score."""
    agg = [0.0] * 6
    for hyp, refs in zip(hypotheses, references):
        best, best_s = -1.0, None
        for ref in refs:
            s = SegmentStats(hyp, ref)
            sc = _score_from(s.p_num, s.r_num, s.p_den, s.r_den, s.chunks, s.m_raw)
            if sc > best:
                best, best_s = sc, s
        if best_s is not None:
            agg[0] += best_s.p_num
            agg[1] += best_s.r_num
            agg[2] += best_s.p_den
            agg[3] += best_s.r_den
            agg[4] += best_s.chunks
            agg[5] += best_s.m_raw
    return _score_from(*agg)


# ---------------------------------------------------------------------------
# Real-jar driver (SCORE/EVAL stdio protocol, train...match.py:543-580)
# ---------------------------------------------------------------------------

def find_meteor_jar() -> str | None:
    path = os.environ.get("METEOR_JAR")
    if path and os.path.exists(path):
        return path
    try:
        from pycocoevalcap.meteor import meteor as _m

        cand = os.path.join(os.path.dirname(_m.__file__), "meteor-1.5.jar")
        if os.path.exists(cand):
            return cand
    except ImportError:
        pass
    return None


class JarMeteor:
    """Subprocess driver speaking the meteor jar's -stdio protocol: one
    ``SCORE ||| ref1 ||| ... ||| hyp`` per segment → stats line; then
    ``EVAL ||| stats ...`` per segment → segment score; final EVAL → corpus.
    `cmd` overrides the launch argv (tests drive a stub instead of java)."""

    def __init__(self, jar: str | None = None, cmd: list[str] | None = None):
        self.jar = jar or find_meteor_jar()
        if cmd is None:
            if self.jar is None or shutil.which("java") is None:
                raise RuntimeError("no meteor jar / java available")
            cmd = ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio",
                   "-l", "en", "-norm"]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True,
                                     bufsize=1)
        self.lock = threading.Lock()

    def _stat(self, hypothesis: str, references: Sequence[str]) -> str:
        hypothesis = hypothesis.replace("|||", "").replace("  ", " ")
        line = " ||| ".join(("SCORE", " ||| ".join(references), hypothesis))
        line = line.replace("\n", "").replace("\r", "")
        self.proc.stdin.write(f"{line}\n")
        self.proc.stdin.flush()
        return self.proc.stdout.readline().strip()

    def compute_score(self, hypotheses: Sequence[str],
                      references: Sequence[Sequence[str]]):
        with self.lock:
            stats = [self._stat(h, r) for h, r in zip(hypotheses, references)]
            eval_line = "EVAL ||| " + " ||| ".join(stats)
            self.proc.stdin.write(f"{eval_line}\n")
            self.proc.stdin.flush()
            scores = [float(self.proc.stdout.readline().strip())
                      for _ in hypotheses]
            final = float(self.proc.stdout.readline().strip())
        return final, scores

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.kill()
        except Exception:
            pass
