"""Offline NER typing + token replacement preprocessing (port of
vacnic_tpu/data/preprocess/ner_typing.py; plain Python, the same code).

Behavioral rebuild of the reference's offline stage (SURVEY L1;
goodnews...py:730-960, nytimes...py:1226-1346):

  * `make_ner_dict_by_type` — assign unique typed labels `<PERSON>_i /
    <ORGNORP>_j / <GPELOC>_k` per distinct entity, in first-appearance order.
  * `replace_entity_ids` — tokenize the article, find each entity's token
    span (with/without leading space), replace every occurrence with the
    bare type token repeated to the same length, producing the
    `articles_*_newsmep_ent_by_count/{hash}.json` `{"input_ids": [...]}`
    artifact that `get_person_ids_position` consumes at train time.
  * `caption_name_positions` — same replacement on captions, then the
    `<PERSON>`-span positions saved as `name_pos_cap`.

The NER engine is pluggable (spaCy `en_core_web_lg` + merge_entities when
installed — the reference's engine; eval.entity_eval.HeuristicNER fallback,
the one on machines without spaCy).
"""

from __future__ import annotations

from typing import Callable, Sequence

from vacnic_tpu_torch.data.preprocess.entity_ids import find_first_sublist, person_token_positions

TYPE_TOKENS = {"PERSON": "<PERSON>", "ORGNORP": "<ORGNORP>", "GPELOC": "<GPELOC>"}


def _bucket(label: str) -> str | None:
    if label == "PERSON":
        return "PERSON"
    if label in ("ORG", "NORP"):
        return "ORGNORP"
    if label in ("GPE", "LOC"):
        return "GPELOC"
    return None


def make_ner_dict_by_type(
    ent_list: Sequence[str], ent_type_list: Sequence[str]
) -> tuple[dict[str, str], list[str]]:
    """→ ({entity: "<TYPE>_count"}, per-occurrence label list)
    (goodnews...py:730-770). Entities of unbucketed types keep no label and
    are skipped downstream (the reference appends nothing for them, which
    desyncs its counter — here they carry an explicit None-safe label)."""
    counts = {"PERSON": 1, "ORGNORP": 1, "GPELOC": 1}
    unique: dict[str, str] = {}
    labels: list[str] = []
    for ent, typ in zip(ent_list, ent_type_list):
        if ent in unique:
            labels.append(unique[ent])
            continue
        bucket = _bucket(typ)
        if bucket is None:
            labels.append("")
            continue
        label = f"{TYPE_TOKENS[bucket]}_{counts[bucket]}"
        counts[bucket] += 1
        unique[ent] = label
        labels.append(label)
    return unique, labels


def _replace_all(seq: list[int], sub: list[int], repl: list[int]) -> list[int]:
    """replace_sublist (goodnews...py:904-910): every occurrence."""
    index = 0
    while True:
        found = find_first_sublist(seq, sub, index)
        if found is None:
            return seq
        start, end = found
        seq[start:end] = repl
        index = start + len(repl)


def replace_entity_ids(
    text: str,
    ent_list: Sequence[str],
    labels: Sequence[str],
    tokenizer,
) -> list[int]:
    """Tokenize `text` and replace each entity's token span with its bare type
    token repeated to span length (`make_new_article_ids_all_ent`,
    goodnews...py:865-899; caption variant :928-947)."""
    ids = tokenizer.encode(text)
    for ent, label in zip(ent_list, labels):
        if not label:
            continue
        type_tok = label.split("_")[0]
        with_space = tokenizer.encode(f" {ent}", add_special_tokens=False)
        if find_first_sublist(ids, with_space) is not None:
            span = with_space
        else:
            span = tokenizer.encode(ent, add_special_tokens=False)
        chain = tokenizer.encode(" ".join([type_tok] * len(span)), add_special_tokens=False)
        ids = _replace_all(ids, span, chain)
    return ids


def process_article(text: str, ner, tokenizer) -> dict:
    """One article → the `{hash}.json` artifact `{"input_ids": [...]}`.

    `ner` must return CASE-PRESERVING entity surfaces (spaCy ent.text /
    `HeuristicNER(lowercase=False)`) — replacement matches token spans in the
    original text (dataset-side get_entities keeps case, goodnews...py:718-728).
    """
    ents, _ = ner(text)
    ent_list = [e["text"] for e in ents]
    type_list = [e["label"] for e in ents]
    _, labels = make_ner_dict_by_type(ent_list, type_list)
    return {"input_ids": replace_entity_ids(text, ent_list, labels, tokenizer)}


def caption_name_positions(
    caption: str, ner, tokenizer, person_token_id: int = 50267, max_len: int = 20
) -> list[list[int]]:
    """`add_name_pos_list_to_dict` per caption (goodnews...py:951-960):
    replaced-caption ids → <PERSON> spans with tgt-input offsets."""
    ents, _ = ner(caption)
    ent_list = [e["text"] for e in ents]
    _, labels = make_ner_dict_by_type(ent_list, [e["label"] for e in ents])
    ids = replace_entity_ids(caption, ent_list, labels, tokenizer)
    return person_token_positions(ids, person_token_id, max_len, is_tgt_input=True)


def add_name_pos_to_dict(data_dict: dict, ner, tokenizer, person_token_id: int = 50267) -> dict:
    out = {}
    for key, rec in data_dict.items():
        rec = dict(rec)
        rec["name_pos_cap"] = caption_name_positions(
            rec["caption"], ner, tokenizer, person_token_id
        )
        out[key] = rec
    return out
