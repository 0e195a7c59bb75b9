"""The Porter stemmer that METEOR's stem stage uses (eval/meteor15.py,
eval/meteor_py.py), written here so the port scores without nltk: the
algorithm of M. F. Porter (1980) with the rules of nltk's default
NLTK_EXTENSIONS mode (`nltk.stem.porter.PorterStemmer()`), which the JAX
package's METEOR calls. The CPU tests hold `stem` equal to nltk's over a
word list.
"""

from __future__ import annotations

VOWELS = frozenset("aeiou")

# whole words mapped before any rule (nltk's irregular forms)
POOL = {"sky": "sky", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
        "news": "news", "innings": "inning", "inning": "inning", "outings": "outing",
        "outing": "outing", "cannings": "canning", "canning": "canning", "howe": "howe",
        "proceed": "proceed", "exceed": "exceed", "succeed": "succeed"}


def _cons(w: str, i: int) -> bool:
    """Is w[i] a consonant: not a vowel, and a "y" only after a vowel
    (a run of "y"s alternates)."""
    if w[i] in VOWELS:
        return False
    if w[i] == "y":
        negate = False
        while i > 0 and w[i] == "y":
            negate = not negate
            i -= 1
        return (w[i] not in VOWELS) != negate
    return True


def _measure(s: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel-consonant transitions."""
    seq = "".join("c" if _cons(s, i) else "v" for i in range(len(s)))
    return seq.count("vc")


def _has_vowel(s: str) -> bool:
    return any(not _cons(s, i) for i in range(len(s)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """consonant-vowel-consonant ending, the last not w, x or y; or (the
    extension) a two-letter vowel-consonant word."""
    return ((len(w) >= 3 and _cons(w, len(w) - 3) and not _cons(w, len(w) - 2)
             and _cons(w, len(w) - 1) and w[-1] not in "wxy")
            or (len(w) == 2 and not _cons(w, 0) and _cons(w, 1)))


def _m_pos(s: str) -> bool:
    return _measure(s) > 0


def _m_gt1(s: str) -> bool:
    return _measure(s) > 1


def _rules(w: str, rules) -> str:
    """The first rule whose suffix ends `w` decides: its replacement when its
    condition holds on the stem, else `w` unchanged."""
    for suffix, repl, cond in rules:
        if w.endswith(suffix):
            stem = w[:len(w) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else w
    return w


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-3] + "ie"
    return _rules(w, (("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
                      ("s", "", None)))


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        return w[:-1] if _m_pos(w[:-3]) else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            s = w[:-len(suffix)]
            break
    else:
        return w
    for suffix, repl in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
        if s.endswith(suffix):
            return s[:-2] + repl
    if _double_cons(s):
        return s[:-1] if s[-1] not in "lsz" else s
    return s + "e" if _measure(s) == 1 and _cvc(s) else s


def _step1c(w: str) -> str:
    return _rules(w, (("y", "i", lambda s: len(s) > 1 and _cons(s, len(s) - 1)),))


STEP2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
         ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
         ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
         ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
         ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"))


def _step2(w: str) -> str:
    if w.endswith("alli") and _m_pos(w[:-4]):
        return _step2(w[:-4] + "al")
    return _rules(w, tuple((s, r, _m_pos) for s, r in STEP2)
                  + (("logi", "log", lambda s: _m_pos(w[:-3])),))


def _step3(w: str) -> str:
    return _rules(w, tuple((s, r, _m_pos) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
        ("ful", ""), ("ness", ""))))


STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent",
         "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize")


def _step4(w: str) -> str:
    return _rules(w, tuple(
        (s, "", (lambda t: _m_gt1(t) and t[-1:] in ("s", "t")) if s == "ion" else _m_gt1)
        for s in STEP4))


def _step5a(w: str) -> str:
    if w.endswith("e"):
        s = w[:-1]
        if _measure(s) > 1 or (_measure(s) == 1 and not _cvc(s)):
            return s
    return w


def _step5b(w: str) -> str:
    return w[:-1] if w.endswith("ll") and _m_gt1(w[:-1]) else w


def stem(word: str) -> str:
    """The Porter stem of `word`, lower-cased first; words of two letters
    or fewer come back lower-cased."""
    s = word.lower()
    if s in POOL:
        return POOL[s]
    if len(word) <= 2:
        return s
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5a, _step5b):
        s = step(s)
    return s
