"""Per-face-group analysis (evaluate_entity.py:376-497).
Port of vacnic_tpu/eval/face_groups.py, output for output.

Splits the test set into {face, noface} × {name, noname} using the data dict
(face present ⇔ `face_emb_dir` non-empty; name present ⇔ `names` non-empty)
and scores captions + entities per group. The reference's hardcoded
`len(dict)-14` metric-row skip (:385,443) is replaced by explicit filtering
of the "bleu"/"other metrics" keys.
"""

from __future__ import annotations

from typing import Any

from vacnic_tpu_torch.eval.caption_metrics import compute_caption_metrics
from vacnic_tpu_torch.eval.entity_eval import NerEngine, evaluate_entity


def split_by_face_group(output_dict: dict, data_dict: dict) -> dict[str, dict]:
    """→ {"face_name": {...}, "face_noname": ..., "noface_name": ...,
    "noface_noname": ...} each an output-dict subset aligned by order."""
    keys = [k for k in output_dict if k not in ("bleu", "other metrics")]
    data_keys = list(data_dict.keys())
    # positional alignment (reference semantics) — guard against dropped or
    # reordered samples, which would silently scramble every group
    if len(keys) != len(data_keys):
        raise ValueError(
            f"output entries ({len(keys)}) != data-dict entries "
            f"({len(data_keys)}); positional alignment would mis-score")
    groups: dict[str, dict] = {
        "face_name": {}, "face_noname": {}, "noface_name": {}, "noface_noname": {}
    }
    for i, k in enumerate(keys):
        rec = data_dict[data_keys[i]]
        # face_emb_dir is a str path when faces exist and a (possibly empty)
        # list otherwise; the reference tests `type(face_dir) is list`
        # (evaluate_entity.py:391). The caption-name key is spelled "names"
        # in GoodNews dicts and "name_cap" in NYTimes dicts
        # (evaluate_entity.py:386-390) — accept both, by key presence.
        fd = rec.get("face_emb_dir")
        face = "noface" if isinstance(fd, list) or not fd else "face"
        name_gt = rec["names"] if "names" in rec else rec.get("name_cap", ())
        name = "name" if len(name_gt) > 0 else "noname"
        groups[f"{face}_{name}"][k] = output_dict[k]
    return groups


def score_face_groups(
    output_dict: dict, data_dict: dict, ner: NerEngine | None = None,
    with_entities: bool = True,
) -> dict[str, Any]:
    results: dict[str, Any] = {}
    for group, subset in split_by_face_group(output_dict, data_dict).items():
        if not subset:
            results[group] = {"count": 0}
            continue
        pairs = [(v["gen"], v["gt"]) for v in subset.values()]
        entry: dict[str, Any] = {"count": len(pairs)}
        entry.update(compute_caption_metrics(pairs))
        if with_entities:
            entry["entities"] = evaluate_entity(subset, ner)
        results[group] = entry
    return results
