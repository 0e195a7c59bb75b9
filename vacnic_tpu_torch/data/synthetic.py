"""Synthetic batches with the static shapes and padding conventions of the
data layer (port of vacnic_tpu/data/synthetic.py). The numpy RandomState
stream is the JAX package's draw for draw, so one seed gives both packages
the same batch; the arrays come back as CPU torch tensors."""

from __future__ import annotations

import numpy as np
import torch

from vacnic_tpu_torch.core.config import VacnicConfig

NONAME_ID = 50266  # <NONAME>


def synthetic_batch(cfg: VacnicConfig, batch_size: int, seed: int = 0,
                    with_pixels: bool = False, num_names: int = 3,
                    name_len: int = 4) -> dict[str, torch.Tensor]:
    """`with_pixels`: raw CLIP-normalised images `pixels` [B, H, W, 3] in
    place of the CLS features `image_cls`, drawn at the same point of the
    stream."""
    rng = np.random.RandomState(seed)
    b = batch_size
    bart, fus, data = cfg.bart, cfg.fusion, cfg.data
    v = bart.vocab_size

    def ids(shape):
        return rng.randint(4, min(v, 50000), size=shape).astype(np.int32)

    src = ids((b, data.article_max_length))
    src[:, 0] = bart.bos_token_id
    for i in range(b):  # ragged pad tails
        pad_from = rng.randint(data.article_max_length // 2, data.article_max_length)
        src[i, pad_from - 1] = bart.eos_token_id
        src[i, pad_from:] = bart.pad_token_id

    tgt = ids((b, data.caption_max_length))
    tgt[:, 0] = bart.bos_token_id
    for i in range(b):
        pad_from = rng.randint(4, data.caption_max_length)
        tgt[i, pad_from - 1] = bart.eos_token_id
        tgt[i, pad_from:] = bart.pad_token_id

    # name ids index the separate NER table, so they stay below its size too
    nv = min(v, fus.ner_vocab_size, 50000)
    names_art = rng.randint(4, nv, size=(b, fus.max_ner_type_len)).astype(np.int32)
    names_art[:, 0] = bart.bos_token_id
    names_art[:, -1] = bart.pad_token_id

    noname = min(NONAME_ID, v - 1, fus.ner_vocab_size - 1)
    names_3d = np.full((b, num_names, name_len), bart.pad_token_id, np.int32)
    names_3d[:, :, 0] = bart.bos_token_id
    names_3d[:, :, 1] = rng.randint(4, nv, size=(b, num_names))
    names_3d[:, :, 2] = bart.eos_token_id
    names_3d[:, -1, 1] = noname

    names_flat = rng.randint(4, nv, size=(b, fus.max_ner_type_len_gt)).astype(np.int32)
    names_flat[:, 0] = bart.bos_token_id

    faces = rng.randn(b, fus.max_faces, fus.face_feature_dim).astype(np.float32)
    faces[:, fus.max_faces // 2:, :] = 1.0  # pad rows of ones for missing faces

    batch = {
        "article_ids": src,
        "caption_ids": tgt,
        "names_art_ids": names_art,
        "names_ids": names_3d,
        "names_ids_flatten": names_flat,
        "face_emb": faces,
    }
    if with_pixels:
        size = cfg.clip.image_size
        batch["pixels"] = rng.randn(b, size, size, 3).astype(np.float32)
    else:
        batch["image_cls"] = rng.randn(b, fus.img_size).astype(np.float32)
    return {k: torch.from_numpy(a) for k, a in batch.items()}
