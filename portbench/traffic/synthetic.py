"""Synthetic article batches: a frozen copy of the port's
`vacnic_tpu_torch/data/synthetic.py` (`synthetic_batch`, commit 024b7cd),
kept here so that a later change to the port's generator cannot change the
benchmark's traffic. The numpy RandomState stream is the original's draw for
draw; the arrays come back as numpy arrays.

Shapes (the released configuration): articles of 512 tokens, BOS first, a
ragged pad tail whose first pad is drawn in [256, 512) with EOS before it;
captions of 100 tokens (pad from [4, 100)); 80 in-article name ids; three
names of four tokens; 20 caption name ids; four FaceNet rows of 512 (the
second half pad rows of ones); a CLIP CLS feature of 768 or 224-px pixels.
"""

from __future__ import annotations

import numpy as np

NONAME_ID = 50266  # <NONAME>


def synthetic_batch(sizes: dict, batch_size: int, seed: int = 0, with_pixels: bool = False,
                    num_names: int = 3, name_len: int = 4) -> dict[str, np.ndarray]:
    """`sizes`: vocab_size, bos/eos/pad ids, article_max_length,
    caption_max_length, ner_vocab_size, max_ner_type_len,
    max_ner_type_len_gt, max_faces, face_feature_dim, img_size, image_size
    (portbench/configs' `sizes`). `with_pixels`: raw CLIP-normalised images
    `pixels` [B, H, W, 3] in place of the CLS features `image_cls`, drawn at
    the same point of the stream."""
    rng = np.random.RandomState(seed % (2 ** 32))
    b = batch_size
    v = sizes["vocab_size"]
    bos, eos, pad = sizes["bos_token_id"], sizes["eos_token_id"], sizes["pad_token_id"]
    s_len, c_len = sizes["article_max_length"], sizes["caption_max_length"]

    def ids(shape):
        return rng.randint(4, min(v, 50000), size=shape).astype(np.int32)

    src = ids((b, s_len))
    src[:, 0] = bos
    for i in range(b):  # ragged pad tails
        pad_from = rng.randint(s_len // 2, s_len)
        src[i, pad_from - 1] = eos
        src[i, pad_from:] = pad

    tgt = ids((b, c_len))
    tgt[:, 0] = bos
    for i in range(b):
        pad_from = rng.randint(4, c_len)
        tgt[i, pad_from - 1] = eos
        tgt[i, pad_from:] = pad

    # name ids index the separate NER table, so they stay below its size too
    nv = min(v, sizes["ner_vocab_size"], 50000)
    names_art = rng.randint(4, nv, size=(b, sizes["max_ner_type_len"])).astype(np.int32)
    names_art[:, 0] = bos
    names_art[:, -1] = pad

    noname = min(NONAME_ID, v - 1, sizes["ner_vocab_size"] - 1)
    names_3d = np.full((b, num_names, name_len), pad, np.int32)
    names_3d[:, :, 0] = bos
    names_3d[:, :, 1] = rng.randint(4, nv, size=(b, num_names))
    names_3d[:, :, 2] = eos
    names_3d[:, -1, 1] = noname

    names_flat = rng.randint(4, nv, size=(b, sizes["max_ner_type_len_gt"])).astype(np.int32)
    names_flat[:, 0] = bos

    faces = rng.randn(b, sizes["max_faces"], sizes["face_feature_dim"]).astype(np.float32)
    faces[:, sizes["max_faces"] // 2:, :] = 1.0  # pad rows of ones for missing faces

    batch = {
        "article_ids": src,
        "caption_ids": tgt,
        "names_art_ids": names_art,
        "names_ids": names_3d,
        "names_ids_flatten": names_flat,
        "face_emb": faces,
    }
    if with_pixels:
        size = sizes["image_size"]
        batch["pixels"] = rng.randn(b, size, size, 3).astype(np.float32)
    else:
        batch["image_cls"] = rng.randn(b, sizes["img_size"]).astype(np.float32)
    return batch
