"""GoodNews / NYTimes800k dataset readers (port of vacnic_tpu/data/datasets.py;
numpy dicts, as JAX's).

Behavioral rebuild of `GoodNewsDictDatasetEntityTypeFixLenEntPos`
(goodnews...py:524-659) and `NYTimesDictDatasetEntityTypeFixLenEntPos`
(nytimes...py:611-748): per-sample reads from the Transform-and-Tell-derived
directory layout, entity dedup, fixed-length entity-id construction, and CLIP
image preprocessing — emitting plain numpy dicts for data/collate.py.

Data-dict JSON contract per hash_id (the reference's
`*_clip{N}sent_contras_name_pos.json` files): caption, names, org_norp,
gpe_loc, names_art, org_norp_art, gpe_loc_art, sents_byclip, face_emb_dir,
obj_emb_dir, name_pos_cap. The NYTimes dict spellings (name_cap,
org_norp_cap, gpe_loc_cap, name_art — nytimes...py:636-641) are accepted as
aliases, so dicts produced by either reference pipeline load unchanged.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Any

import numpy as np

from vacnic_tpu_torch.data.preprocess.entity_ids import (
    dedupe_entities,
    make_entity_ids,
    person_token_positions,
)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


try:  # looked up once: JAX's ascii_fold retries the import on every call
    from unidecode import unidecode as _unidecode
except ImportError:
    _unidecode = None


def ascii_fold(text: str) -> str:
    """unidecode-equivalent ASCII transliteration for the common Latin cases
    (the reference unidecodes captions, goodnews...py:571): unidecode when it
    is installed, else NFKD with the non-ASCII marks dropped."""
    if _unidecode is not None:
        return _unidecode(text)
    return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")


def load_image(path: str, image_size: int = 224, hflip_rng: np.random.RandomState | None = None) -> np.ndarray:
    """jpg → normalized [H, W, 3] float32 (CLIP normalization,
    train...match.py:741-742; RandomHorizontalFlip at train :761-764)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    if hflip_rng is not None and hflip_rng.rand() < 0.5:
        arr = arr[:, ::-1, :]
    return (arr - CLIP_MEAN) / CLIP_STD


class NewsCaptionDataset:
    """Unified GoodNews/NYTimes reader (the two reference classes differ only
    in directory names; SURVEY §2.4)."""

    LAYOUTS = {
        "goodnews": dict(articles="articles_full", ner_mask="articles_full_newsmep_ent_by_count"),
        "nytimes": dict(articles="articles_seg", ner_mask="articles_seg_newsmep_ent_by_count"),
    }

    def __init__(
        self,
        data_dict: dict[str, Any],
        data_base_dir: str,
        tokenizer,
        dataset: str = "goodnews",
        *,
        ent_separator: str = "<ENT>",
        max_article_len: int = 512,
        max_caption_len: int = 100,  # the reference hardcodes 100 (goodnews...py:624)
        max_ner_type_len: int = 80,
        max_ner_type_len_gt: int = 20,
        retrieved_sent: bool = True,
        person_token_id: int = 50267,
        train: bool = False,
        image_size: int = 224,
        clip_tokenizer=None,
        seed: int = 0,
        raw_mode: bool = False,
    ):
        layout = self.LAYOUTS[dataset]
        self.dataset = dataset
        self.data_dict = data_dict
        self.hash_ids = list(data_dict.keys())
        self.face_dir = os.path.join(data_base_dir, "faces")
        self.obj_dir = os.path.join(data_base_dir, "objects")
        self.article_dir = os.path.join(data_base_dir, layout["articles"])
        self.ner_mask_dir = os.path.join(data_base_dir, layout["ner_mask"])
        self.img_dir = os.path.join(data_base_dir, "images_processed")
        self.tokenizer = tokenizer
        self.clip_tokenizer = clip_tokenizer
        self.ent_separator = ent_separator
        self.max_article_len = max_article_len
        self.max_caption_len = max_caption_len
        self.max_ner_type_len = max_ner_type_len
        self.max_ner_type_len_gt = max_ner_type_len_gt
        self.retrieved_sent = retrieved_sent
        self.person_token_id = person_token_id
        self.train = train
        self.image_size = image_size
        self._rng = np.random.RandomState(seed)
        # raw_mode: the LMM-prompting dataset variant (SURVEY §0.1,
        # src.data.dataset_entity_type_newsmep_blip): raw PIL image + raw
        # article text, no tensorization.
        self.raw_mode = raw_mode

    def __len__(self) -> int:
        return len(self.hash_ids)

    def __getitem__(self, index: int) -> dict[str, Any]:
        hash_id = self.hash_ids[index]
        rec = self.data_dict[hash_id]

        if self.raw_mode:
            from PIL import Image

            article = (
                rec["sents_byclip"] if self.retrieved_sent
                else open(os.path.join(self.article_dir, f"{hash_id}.txt")).read()
            )
            return {
                "article": article,
                "caption": (ascii_fold(rec["caption"])
                            if self.dataset == "goodnews" else rec["caption"]),
                "raw_img": Image.open(os.path.join(self.img_dir, f"{hash_id}.jpg")).convert("RGB"),
            }

        # --- image / faces / objects (goodnews...py:549-560) ----------------
        pixels = load_image(
            os.path.join(self.img_dir, f"{hash_id}.jpg"),
            self.image_size,
            self._rng if self.train else None,
        )
        # Key aliasing: the two reference dataset formats spell the entity
        # keys differently — GoodNews dicts use names/org_norp/gpe_loc/
        # names_art (goodnews...py:442, 524-659) while NYTimes dicts use
        # name_cap/org_norp_cap/gpe_loc_cap/name_art (nytimes...py:636-641).
        # The unified reader accepts both so either reference-produced dict
        # loads unchanged.
        def _rec(*keys: str, default: Any = ()) -> Any:
            for k in keys:
                if k in rec:
                    return rec[k]
            return list(default)

        names = _rec("names", "name_cap")
        if rec.get("face_emb_dir"):
            face_emb = np.load(os.path.join(self.face_dir, f"{hash_id}.npy"))
        else:
            face_emb = np.zeros((0, 512), np.float32)
            # The GoodNews reader forces names empty when the sample has no
            # faces (goodnews...py:550-555); the NYTimes reader reads
            # name_cap unconditionally (its in-branch assignment is commented
            # out, nytimes...py:636-641, names read at :656).
            if self.dataset == "goodnews":
                names = []

        obj_emb = (
            np.load(os.path.join(self.obj_dir, f"{hash_id}.npy"))
            if rec.get("obj_emb_dir")
            else np.zeros((0, 2048), np.float32)
        )

        # --- article text: retrieved segments or full article (:562-567) ----
        if self.retrieved_sent:
            article = rec["sents_byclip"]
        else:
            with open(os.path.join(self.article_dir, f"{hash_id}.txt")) as f:
                article = f.read()
        # Only the GoodNews reader unidecodes captions (goodnews...py:570);
        # the NYTimes reader tokenizes the raw caption (nytimes...py:655).
        caption = (ascii_fold(rec["caption"]) if self.dataset == "goodnews"
                   else rec["caption"])

        org_norp = _rec("org_norp", "org_norp_cap")
        gpe_loc = _rec("gpe_loc", "gpe_loc_cap")
        names_art = dedupe_entities(_rec("names_art", "name_art"))
        org_gpe_art = dedupe_entities(rec.get("org_norp_art", [])) + dedupe_entities(
            rec.get("gpe_loc_art", [])
        )
        org_norp_gpe_loc = [*org_norp, *gpe_loc]
        all_gt_ner = [*names, *org_norp, *gpe_loc]

        tok = self.tokenizer
        sample: dict[str, Any] = {
            "sample_idx": index,  # stable row id (train/loop.py teacher cache)
            "article": article,
            "caption": caption,
            "article_ids": tok.encode(article, max_length=self.max_article_len),
            "caption_ids": tok.encode(caption, max_length=self.max_caption_len),
            "names": names,
            "all_gt_ner": all_gt_ner,
            "face_emb": face_emb,
            "obj_emb": obj_emb,
            "pixels": pixels,
        }

        # --- fixed-length entity streams (:632-648) -------------------------
        sample["names_art_ids"], _ = make_entity_ids(
            article, names_art, tok, self.ent_separator, self.max_ner_type_len
        )
        sample["names_ids_flatten"], sample["names_ids"] = make_entity_ids(
            caption, names, tok, self.ent_separator, self.max_ner_type_len_gt
        )
        sample["org_norp_gpe_loc_art_ids"], _ = make_entity_ids(
            article, org_gpe_art, tok, self.ent_separator, self.max_ner_type_len
        )
        sample["org_norp_gpe_loc_ids_flatten"], _ = make_entity_ids(
            caption, org_norp_gpe_loc, tok, self.ent_separator, self.max_ner_type_len_gt
        )
        concat_gt = f" {self.ent_separator} ".join(all_gt_ner)
        sample["all_gt_ner_ids"] = tok.encode(concat_gt, max_length=self.max_ner_type_len_gt)

        # --- person-token spans from the NER-replaced article (:618-621) ----
        ner_mask_path = os.path.join(self.ner_mask_dir, f"{hash_id}.json")
        if os.path.exists(ner_mask_path):
            with open(ner_mask_path) as f:
                masked = json.load(f)
            sample["person_id_positions"] = person_token_positions(
                masked["input_ids"], self.person_token_id, self.max_article_len
            )
        else:
            sample["person_id_positions"] = []
        sample["person_id_positions_cap"] = rec.get("name_pos_cap", [])

        if self.clip_tokenizer is not None:
            sample["caption_ids_clip"] = self.clip_tokenizer.encode(caption, max_length=77)
        return sample
