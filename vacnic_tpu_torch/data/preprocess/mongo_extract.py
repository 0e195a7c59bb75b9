"""NYTimes800k extraction from the Transform-and-Tell MongoDB (port of
vacnic_tpu/data/preprocess/mongo_extract.py; numpy and plain Python, the
same code).

Behavioral rebuild of `NYTimesDataset` (nytimes...py:21-293) and the dict
builders (:331-428, 1334-1346): per image, a context window of paragraphs
around the image position up to 510 tokens (first paragraph + alternating
before/after expansion), top-k faces by detection probability, typed NER
sets from the precomputed `named_entities` annotations, and the per-sample
artifact directories (`articles_seg/*.txt`, `faces/*.npy`, `objects/*.npy`)
plus split dict JSONs.

The db handle is duck-typed (pymongo `MongoClient(...).nytimes` or any object
with `.articles.find/find_one` and `.objects.find_one`) so the extraction
logic is testable without a Mongo server; pymongo itself is only imported in
`connect()`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

import numpy as np


def connect(host: str = "localhost", port: int = 27017):  # pragma: no cover
    import pymongo

    return pymongo.MongoClient(host=host, port=port).nytimes


def get_ner_by_type(section: dict) -> tuple[set, set, set]:
    """PERSON / ORG+NORP / GPE+LOC text sets (nytimes...py:249-263)."""
    names, org_norp, gpe_loc = set(), set(), set()
    for ner in section.get("named_entities", []):
        if ner["label"] == "PERSON":
            names.add(ner["text"])
        elif ner["label"] in ("ORG", "NORP"):
            org_norp.add(ner["text"])
        elif ner["label"] in ("GPE", "LOC"):
            gpe_loc.add(ner["text"])
    return names, org_norp, gpe_loc


def get_named_entities(section: dict) -> set:
    """PERSON|ORG|GPE surface set (nytimes...py:238-247)."""
    return {
        ner["text"]
        for ner in section.get("named_entities", [])
        if ner["label"] in ("PERSON", "ORG", "GPE")
    }


def top_k_faces(facenet: dict, k: int) -> tuple[np.ndarray, list]:
    """Top-k faces by detect prob (argpartition semantics, nytimes...py:276-280)."""
    probs = facenet["detect_probs"]
    idx = np.argpartition(probs, -k)[-k:]
    return (
        np.array([facenet["embeddings"][i] for i in idx]),
        [probs[i] for i in idx],
    )


def build_context(
    sections: list[dict], pos: int, headline: dict | None, tokenizer, max_words: int = 510
) -> tuple[str, set, set, set, set]:
    """Context window around image `pos` (nytimes...py:80-150): title, the
    article's first paragraph, then alternating before/after paragraphs until
    ≥ max_words tokens. Returns (context, ner_set, names, org_norp, gpe_loc)."""
    paragraphs: list[str] = []
    named: set = set()
    names: set = set()
    orgs: set = set()
    gpes: set = set()
    n_words = 0

    title = ""
    if headline and "main" in headline:
        title = headline["main"].strip()
    if title:
        paragraphs.append(title)
        # NOTE: reference calls set.union without assignment here (:91-96) —
        # headline entities are effectively dropped; we keep that behavior.
        n_words += len(tokenizer.encode(title, add_special_tokens=False))

    first_par = None
    for k, section in enumerate(sections):
        if section["type"] == "paragraph":
            first_par = k
            paragraphs.append(section["text"])
            named |= get_named_entities(section)
            a, b, c = get_ner_by_type(section)
            names |= a; orgs |= b; gpes |= c
            break
    if first_par is None:
        first_par = len(sections)

    before: list[str] = []
    after: list[str] = []
    i, j = pos - 1, pos + 1
    while True:
        if i > first_par and sections[i]["type"] == "paragraph":
            text = sections[i]["text"]
            before.insert(0, text)
            named |= get_named_entities(sections[i])
            a, b, c = get_ner_by_type(sections[i])
            names |= a; orgs |= b; gpes |= c
            n_words += len(tokenizer.encode(text, add_special_tokens=False))
        i -= 1
        if first_par < j < len(sections) and sections[j]["type"] == "paragraph":
            text = sections[j]["text"]
            after.append(text)
            named |= get_named_entities(sections[j])
            a, b, c = get_ner_by_type(sections[j])
            names |= a; orgs |= b; gpes |= c
            n_words += len(tokenizer.encode(text, add_special_tokens=False))
        j += 1
        if n_words >= max_words or (i <= first_par and j >= len(sections)):
            break

    context = "\n".join(paragraphs + before + after).strip()
    return context, named, names, orgs, gpes


def extract_article(
    db, article_id, tokenizer, max_n_faces: int = 4, max_words: int = 510
) -> dict[str, dict]:
    """One article → {image_hash: record} (the reference `__getitem__`
    img_dict contract, nytimes...py:43-236)."""
    projection = [
        "_id", "parsed_section.type", "parsed_section.text", "parsed_section.hash",
        "parsed_section.facenet_details", "parsed_section.named_entities",
        "image_positions", "headline", "n_images_with_faces",
    ]
    article = db.articles.find_one({"_id": {"$eq": article_id}}, projection=projection)
    sections = article["parsed_section"]
    out: dict[str, dict] = {}
    for pos in article["image_positions"]:
        caption = sections[pos]["text"].strip()
        if not caption:
            continue
        context, named, names, orgs, gpes = build_context(
            sections, pos, article.get("headline"), tokenizer, max_words
        )

        sec = sections[pos]
        person_names = [n for n in get_ner_by_type(sec)[0]]
        if "facenet_details" not in sec or len(person_names) == 0:
            face_emb, probs = np.zeros((0, 512), np.float32), []
        elif max_n_faces < sec["facenet_details"]["n_faces"]:
            face_emb, probs = top_k_faces(sec["facenet_details"], max_n_faces)
        else:
            face_emb = np.array(sec["facenet_details"]["embeddings"])
            probs = sec["facenet_details"]["detect_probs"]

        obj = db.objects.find_one({"_id": sec["hash"]})
        obj_emb = (
            np.array(obj["object_features"])
            if obj and len(obj.get("object_features", []))
            else np.zeros((0, 2048), np.float32)
        )

        cap_names, cap_orgs, cap_gpes = get_ner_by_type(sec)
        out[sec["hash"]] = {
            "article": context,
            "caption": caption,
            "named_entities": sorted(named),
            "name_art": sorted(names),
            "org_norp_art": sorted(orgs),
            "gpe_loc_art": sorted(gpes),
            # NYTimes dict key spellings (nytimes...py:636-641); the unified
            # NewsCaptionDataset reader also accepts the GoodNews spellings
            # (names / org_norp / gpe_loc / names_art).
            "name_cap": sorted(cap_names),
            "org_norp_cap": sorted(cap_orgs),
            "gpe_loc_cap": sorted(cap_gpes),
            "ner_cap": sorted(get_named_entities(sec)),
            "face_emb": face_emb,
            "face_prob": probs,
            "obj_emb": obj_emb,
        }
    return out


def save_split(
    db, split: str, out_dir: str, tokenizer, *, max_n_faces: int = 4, limit: int | None = None
) -> dict:
    """Write per-sample artifacts + the split dict (save_nytimes_seg_text_to_dict,
    nytimes...py:331-428; clean_dict drop-no-image :1334-1346)."""
    for sub in ("articles_seg", "faces", "objects"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    cursor = db.articles.find({"split": {"$eq": split}}, projection=["_id"]).sort("_id", 1)
    ids = [a["_id"] for a in cursor]
    if limit:
        ids = ids[:limit]

    split_dict: dict[str, dict] = {}
    for aid in ids:
        for img_hash, rec in extract_article(db, aid, tokenizer, max_n_faces).items():
            with open(os.path.join(out_dir, "articles_seg", f"{img_hash}.txt"), "w") as f:
                f.write(rec["article"])
            face_emb = rec.pop("face_emb")
            obj_emb = rec.pop("obj_emb")
            face_dirs = []
            if face_emb.size:
                np.save(os.path.join(out_dir, "faces", f"{img_hash}.npy"), face_emb)
                face_dirs = [f"faces/{img_hash}.npy"]
            obj_dirs = []
            if obj_emb.size:
                np.save(os.path.join(out_dir, "objects", f"{img_hash}.npy"), obj_emb)
                obj_dirs = [f"objects/{img_hash}.npy"]
            rec["face_emb_dir"] = face_dirs
            rec["obj_emb_dir"] = obj_dirs
            split_dict[img_hash] = rec

    with open(os.path.join(out_dir, f"{split}_dict_newsmep_ent_seg.json"), "w") as f:
        json.dump(split_dict, f)
    return split_dict
