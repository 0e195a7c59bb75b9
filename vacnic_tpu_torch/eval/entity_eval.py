"""Entity precision/recall evaluation (behavioral port of evaluate_entity.py).
Port of vacnic_tpu/eval/entity_eval.py, output for output.

Two paths, as in the reference:
  * `evaluate_entity(output_dict, ner)` — re-NER both GT and generated
    captions, count exact (text, label) matches per category + proper-noun
    word-level P/R (evaluate_entity.py:232-321).
  * `evaluate_entity_by_gtent(output_dict, gtent_dict, ner)` — GT entities
    come from the precomputed dicts (lower-cased, unidecoded), generated
    captions re-NER'd (evaluate_entity.py:168-230).

NER is pluggable: spaCy `en_core_web_lg` when installed (the reference's
engine), otherwise `HeuristicNER` — a clearly-labeled capitalized-span
fallback so the pipeline runs end-to-end without spaCy. Results carry
`"ner_engine"` so numbers are never silently compared across engines.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Callable, Protocol


class Entity(dict):
    """{"text": lower-cased surface, "label": PERSON|ORG|GPE|DATE|..."}"""


class NerEngine(Protocol):
    name: str

    def __call__(self, text: str) -> tuple[list[dict], list[str]]:
        """→ (entities, proper_noun_words)"""


class SpacyNER:
    name = "spacy:en_core_web_lg"

    def __init__(self):  # imports spaCy only when constructed
        import spacy

        self.nlp = spacy.load("en_core_web_lg")

    def __call__(self, text: str):
        doc = self.nlp(text)
        ents = [{"text": e.text.lower(), "label": e.label_} for e in doc.ents]
        propn = [t.text.lower() for t in doc if t.pos_ == "PROPN"]
        return ents, propn


_MONTHS = (
    "january february march april may june july august september october november december"
).split()
_DATE_RE = re.compile(
    r"\b(?:" + "|".join(m.capitalize() for m in _MONTHS) + r")\b(?:\s+\d{1,2})?(?:,?\s+\d{4})?|\b(?:19|20)\d{2}\b"
)
_CAP_SPAN = re.compile(r"(?:[A-Z][\w'’.-]*)(?:\s+(?:of|the|and|de|van|von|[A-Z][\w'’.-]*))*")


class HeuristicNER:
    """Capitalized-span NER fallback. Labels: title-cased multi-word spans
    with person-like shape → PERSON; known org suffixes → ORG; standalone
    capitalized tokens → GPE (best effort); date patterns → DATE. NOT a
    drop-in replacement for spaCy — scores from this engine are only
    comparable to other HeuristicNER scores."""

    name = "heuristic"
    _ORG_HINTS = ("Inc", "Corp", "Company", "Committee", "University", "Department",
                  "Association", "Agency", "Council", "Party", "Bank", "Group", "Times")

    def __init__(self, lowercase: bool = True):
        # eval compares lower-cased surfaces (reference get_entities,
        # evaluate_entity.py:24-31); PREPROCESSING must keep the original case
        # so token-span replacement can find the surface form in the text
        # (dataset-side get_entities, goodnews...py:718-728) — pass False there.
        self.lowercase = lowercase

    def _case(self, s: str) -> str:
        return s.lower() if self.lowercase else s

    def __call__(self, text: str):
        ents: list[dict] = []
        for m in _DATE_RE.finditer(text):
            ents.append({"text": self._case(m.group(0)), "label": "DATE"})
        body = _DATE_RE.sub(" ", text)
        propn: list[str] = []
        for m in _CAP_SPAN.finditer(body):
            span = m.group(0).strip(" .")
            words = span.split()
            # skip sentence-initial single common words
            if not words:
                continue
            if m.start() == 0 and len(words) == 1:
                continue
            propn.extend(w.lower() for w in words if w[:1].isupper())
            if any(h in words for h in self._ORG_HINTS):
                label = "ORG"
            elif len(words) >= 2 and all(w[:1].isupper() for w in words):
                label = "PERSON"
            else:
                label = "GPE"
            ents.append({"text": self._case(span), "label": label})
        return ents, propn


def default_ner() -> NerEngine:
    try:  # spaCy when it is installed, else the heuristic
        return SpacyNER()
    except Exception:
        return HeuristicNER()


def _contains(entities: list[dict], target: dict) -> bool:
    return any(e["text"] == target["text"] and e["label"] == target["label"] for e in entities)


_CATEGORIES = {"PERSON": "person", "ORG": "orgs", "GPE": "gpes", "DATE": "date"}


def _tally(cap_ents: list[dict], gen_ents: list[dict], c: defaultdict) -> None:
    """compute_entities (evaluate_entity.py:50-105): overall + per-label."""
    c["n_caption_ents"] += len(cap_ents)
    c["n_gen_ents"] += len(gen_ents)
    c["n_gen_ent_matches"] += sum(_contains(cap_ents, e) for e in gen_ents)
    c["n_caption_ent_matches"] += sum(_contains(gen_ents, e) for e in cap_ents)
    for label, key in _CATEGORIES.items():
        cap = [e for e in cap_ents if e["label"] == label]
        gen = [e for e in gen_ents if e["label"] == label]
        c[f"n_caption_{key}"] += len(cap)
        c[f"n_gen_{key}"] += len(gen)
        c[f"n_gen_{key}_matches"] += sum(_contains(cap, e) for e in gen)
        c[f"n_caption_{key}_matches"] += sum(_contains(gen, e) for e in cap)


def _ratio(count: int, total: int):
    return {"count": count, "total": total,
            "percentage": (count / total) if total else None}


def _results(c: defaultdict, ner_name: str, include_names: bool = False,
             full: tuple[int, int, int, int] | None = None) -> dict:
    out: dict[str, Any] = {"ner_engine": ner_name}
    if include_names and full is not None:
        fr, frt, fp, fpt = full
        out["All names (by word) - recall"] = _ratio(fr, frt)
        out["All names (by word) - precision"] = _ratio(fp, fpt)
    out["Entity all - recall"] = _ratio(c["n_caption_ent_matches"], c["n_caption_ents"])
    out["Entity all - precision"] = _ratio(c["n_gen_ent_matches"], c["n_gen_ents"])
    for label, key in _CATEGORIES.items():
        pretty = {"person": "person (by full name)", "orgs": "ORG", "gpes": "GPE", "date": "DATE"}[key]
        out[f"Entity {pretty} - recall"] = _ratio(
            c[f"n_caption_{key}_matches"], c[f"n_caption_{key}"]
        )
        out[f"Entity {pretty} - precision"] = _ratio(
            c[f"n_gen_{key}_matches"], c[f"n_gen_{key}"]
        )
    return out


def _caption_items(output_dict: dict) -> list[dict]:
    return [v for k, v in output_dict.items() if k not in ("bleu", "other metrics")]


def evaluate_entity(output_dict: dict, ner: NerEngine | None = None) -> dict:
    """Both sides re-NER'd (evaluate_entity.py:232-321)."""
    ner = ner or default_ner()
    c: defaultdict = defaultdict(int)
    fr = frt = fp = fpt = 0
    for sample in _caption_items(output_dict):
        cap_ents, cap_propn = ner(sample["gt"])
        gen_ents, gen_propn = ner(sample["gen"])
        fr += sum(n in gen_propn for n in cap_propn)
        frt += len(cap_propn)
        fp += sum(n in cap_propn for n in gen_propn)
        fpt += len(gen_propn)
        _tally(cap_ents, gen_ents, c)
    return _results(c, ner.name, include_names=True, full=(fr, frt, fp, fpt))


def evaluate_entity_by_gtent(output_dict: dict, gtent_dict: dict,
                             ner: NerEngine | None = None) -> dict:
    """GT side from precomputed entity dicts: ner_cap (strings), names_cap,
    org_cap, gpe_cap (evaluate_entity.py:168-230)."""
    ner = ner or default_ner()
    c: defaultdict = defaultdict(int)
    gt_keys = list(gtent_dict.keys())
    items = _caption_items(output_dict)
    # alignment is positional (the reference zips output entries to data-dict
    # entries by enumeration order, evaluate_entity.py:168-230); a dropped or
    # reordered sample silently mis-scores everything after it — fail loudly.
    if len(items) != len(gt_keys):
        raise ValueError(
            f"output entries ({len(items)}) != gt-entity dict entries "
            f"({len(gt_keys)}); positional alignment would mis-score")
    for i, sample in enumerate(items):
        rec = gtent_dict[gt_keys[i]]
        gen_ents, _ = ner(sample["gen"])
        groups = {
            None: rec.get("ner_cap", []),
            "PERSON": rec.get("names_cap", []),
            "ORG": rec.get("org_cap", []),
            "GPE": rec.get("gpe_cap", []),
        }
        key_of = {None: "ent", "PERSON": "person", "ORG": "orgs", "GPE": "gpes"}
        for label, gt_strings in groups.items():
            gen = gen_ents if label is None else [e for e in gen_ents if e["label"] == label]
            ckey = key_of[label]
            base = "ents" if ckey == "ent" else ckey
            c[f"n_caption_{base}"] += len(gt_strings)
            c[f"n_gen_{base}"] += len(gen)
            c[f"n_gen_{'ent' if ckey=='ent' else ckey}_matches"] += sum(
                e["text"] in gt_strings for e in gen
            )
            c[f"n_caption_{'ent' if ckey=='ent' else ckey}_matches"] += sum(
                any(e["text"] == s for e in gen) for s in gt_strings
            )
    return _results(c, ner.name)
