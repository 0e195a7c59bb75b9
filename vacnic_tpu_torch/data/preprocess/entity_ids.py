"""Entity-id construction: the fixed-length NER token streams (port of
vacnic_tpu/data/preprocess/entity_ids.py).

Behavioral port of the reference dataset helpers (SURVEY §2.4):
  * `make_entity_ids` — `make_new_entity_ids` (goodnews...py:307-358):
    tokenize each entity with/without leading space to match in-text
    occurrences, join with the <ENT> separator, truncate/pad to a fixed
    length, fall back to <NONAME>; also emit per-entity id lists each wrapped
    <bos> ... <eos>, with a trailing <bos><NONAME><eos> row.
  * `person_token_positions` — `get_person_ids_position`
    (goodnews...py:374-399): spans of consecutive <PERSON> tokens in the
    NER-replaced article ids.
  * `dedupe_entities` — `compare_ner` semantics: drop entities that are
    substrings of another entity in the list (keeps the longest mention).
"""

from __future__ import annotations

from typing import Sequence


def find_first_sublist(seq: Sequence[int], sub: Sequence[int], start: int = 0):
    """First occurrence of `sub` in `seq` at or after `start`
    (train...match.py:157-162)."""
    n = len(sub)
    if n == 0:
        return None
    for i in range(start, len(seq) - n + 1):
        if list(seq[i : i + n]) == list(sub):
            return i, i + n
    return None


def dedupe_entities(entities: list[str]) -> list[str]:
    """The dataset's compare_ner dedup pass (goodnews...py:579-601): drop an
    entity iff it is a substring of ANY other list element. NOTE this means
    exact duplicates eliminate EACH OTHER — ['A', 'A'] → [] (each copy is a
    substring of the other); the reference behaves this way and the stream
    then falls back to <NONAME>."""
    out: list[str] = []
    for i, e in enumerate(entities):
        if not e:
            continue
        others = entities[:i] + entities[i + 1:]
        if any(e in o for o in others):
            continue
        out.append(e)
    return out


def make_entity_ids(
    text: str,
    ent_list: list[str],
    tokenizer,
    ent_separator: str = "<ENT>",
    max_length: int = 80,
    noname_token: str = "<NONAME>",
) -> tuple[list[int], list[list[int]]]:
    """Build (flat fixed-length ids, per-entity id lists).

    Flat stream: [bos] e1 <ENT> e2 <ENT> ... [eos] padded to `max_length`.
    Per-entity: each [bos] ei [eos] plus a final [bos] <NONAME> [eos] row;
    rows are NOT padded here (collate pads them, goodnews...py:118).
    """
    text_ids = tokenizer.encode(text, add_special_tokens=False)
    sep = tokenizer.encode(ent_separator, add_special_tokens=False)
    noname = tokenizer.encode(noname_token, add_special_tokens=False)
    bos, eos, pad = tokenizer.bos_token_id, tokenizer.eos_token_id, tokenizer.pad_token_id

    flat: list[int] = []
    separate: list[list[int]] = []
    for ent in ent_list:
        with_space = tokenizer.encode(f" {ent}", add_special_tokens=False)
        if find_first_sublist(text_ids, with_space) is not None:
            ids = with_space
        else:
            # entity at sentence start tokenizes without the leading space
            ids = tokenizer.encode(ent, add_special_tokens=False)
        flat.extend(ids)
        flat.extend(sep)
        separate.append([bos] + ids + [eos])
        if len(flat) > max_length - 2:
            flat = flat[: max_length - 2]
            break
    if not flat:
        flat = list(noname)
    flat = [bos] + flat + [eos]
    flat = flat + [pad] * (max_length - len(flat)) if len(flat) < max_length else flat
    separate.append([bos] + noname + [eos])
    return flat, separate


def person_token_positions(
    article_ids: Sequence[int],
    person_token_id: int = 50267,
    article_max_length: int = 512,
    is_tgt_input: bool = False,
) -> list[list[int]]:
    """[start, end] spans of consecutive `person_token_id` runs
    (goodnews...py:374-399; +1 offsets under is_tgt_input)."""
    spans: list[list[int]] = []
    i = 0
    n = len(article_ids)
    while i < n:
        if article_ids[i] == person_token_id and i < article_max_length:
            j = i
            while j < n and article_ids[j] == person_token_id:
                j += 1
            if is_tgt_input:
                spans.append([i + 1, j])
            else:
                spans.append([i, j - 1])
            i = j
        else:
            i += 1
    return spans
