"""Fixed-bucket collation: sample dicts → static-shape numpy batches (port of
vacnic_tpu/data/collate.py: the same buckets and padding, so a batch has the
same shapes and dtypes in both packages).

The reference pads dynamically to the batch max (collate_fn_*_entity_type,
goodnews...py:22-127; nytimes...py:804-913). On TPU dynamic shapes force
recompiles, so we pad to the config buckets instead while preserving the
reference's padding *conventions* exactly:

  * token streams pad with 1 (BART pad id); CLIP caption ids pad with 0;
  * face/object features pad with rows of ones (`pad_tensor_feat`,
    goodnews...py:38-58 — the ones-row is what `face_mask` keys off);
  * 3-D per-name ids pad missing names with <bos><NONAME><eos> rows
    (`pad_sequence_from_list` special_token_id=50266, goodnews...py:118).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

NONAME_ID = 50266


def pad_ids(rows: Sequence[Sequence[int]], length: int, pad: int = 1) -> np.ndarray:
    out = np.full((len(rows), length), pad, np.int32)
    for i, r in enumerate(rows):
        r = list(r)[:length]
        out[i, : len(r)] = r
    return out


def pad_feats(rows: Sequence[np.ndarray], count: int, dim: int, pad_value: float = 1.0) -> np.ndarray:
    """[n_i, dim] feature lists → [B, count, dim]; missing rows = pad_value."""
    out = np.full((len(rows), count, dim), pad_value, np.float32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.float32).reshape(-1, dim) if np.size(r) else np.zeros((0, dim), np.float32)
        n = min(len(r), count)
        if n:
            out[i, :n] = r[:n]
    return out


def pad_names_3d(
    rows: Sequence[Sequence[Sequence[int]]],
    num_names: int,
    name_len: int,
    bos: int = 0,
    eos: int = 2,
    pad: int = 1,
    noname: int = NONAME_ID,
) -> np.ndarray:
    """Per-sample lists of per-name id lists → [B, num_names, name_len]."""
    out = np.full((len(rows), num_names, name_len), pad, np.int32)
    filler = [bos, noname, eos]
    for i, names in enumerate(rows):
        names = list(names)[:num_names]
        for j in range(num_names):
            ids = list(names[j]) if j < len(names) else list(filler)
            ids = ids[:name_len]
            out[i, j, : len(ids)] = ids
    return out


def collate(
    samples: list[dict[str, Any]],
    *,
    article_len: int = 512,
    caption_len: int = 100,
    ner_len: int = 80,
    ner_len_gt: int = 20,
    max_faces: int = 4,
    face_dim: int = 512,
    max_objects: int = 0,
    obj_dim: int = 2048,
    num_names: int = 8,
    name_len: int = 16,
    clip_len: int = 77,
    noname_id: int = NONAME_ID,
) -> dict[str, np.ndarray]:
    """Batch dict matching the §2.4 contract with static shapes."""
    batch: dict[str, Any] = {
        "article_ids": pad_ids([s["article_ids"] for s in samples], article_len),
        "caption_ids": pad_ids([s["caption_ids"] for s in samples], caption_len),
        "names_art_ids": pad_ids([s["names_art_ids"] for s in samples], ner_len),
        "names_ids_flatten": pad_ids([s["names_ids_flatten"] for s in samples], ner_len_gt),
        "org_norp_gpe_loc_art_ids": pad_ids(
            [s.get("org_norp_gpe_loc_art_ids", [1]) for s in samples], ner_len
        ),
        "org_norp_gpe_loc_ids_flatten": pad_ids(
            [s.get("org_norp_gpe_loc_ids_flatten", [1]) for s in samples], ner_len_gt
        ),
        "all_gt_ner_ids": pad_ids([s.get("all_gt_ner_ids", [1]) for s in samples], ner_len),
        "names_ids": pad_names_3d([s.get("names_ids", []) for s in samples], num_names,
                                  name_len, noname=noname_id),
        "face_emb": pad_feats([s.get("face_emb", np.zeros((0, face_dim))) for s in samples],
                              max_faces, face_dim),
        "caption": [s.get("caption", "") for s in samples],
    }
    if "article_ner_mask_ids" in samples[0]:
        batch["article_ner_mask_ids"] = pad_ids(
            [s["article_ner_mask_ids"] for s in samples], article_len
        )
    if "caption_ids_clip" in samples[0]:
        batch["caption_ids_clip"] = pad_ids(
            [s["caption_ids_clip"] for s in samples], clip_len, pad=0
        )
    if max_objects > 0:
        batch["obj_emb"] = pad_feats(
            [s.get("obj_emb", np.zeros((0, obj_dim))) for s in samples], max_objects, obj_dim
        )
    if "pixels" in samples[0]:
        batch["pixels"] = np.stack([s["pixels"] for s in samples]).astype(np.float32)
    if "person_id_positions" in samples[0]:
        batch["person_id_positions"] = [s["person_id_positions"] for s in samples]
    if "sample_idx" in samples[0]:
        # dataset row ids — host-side identity for the teacher-pooled cache
        batch["sample_idx"] = np.asarray([s["sample_idx"] for s in samples], np.int32)
    return batch
