"""CLIP sentence retrieval (port of vacnic_tpu/data/preprocess/clip_retrieval.py):
the preprocessing stage ABSENT from the reference snapshot (SURVEY §0.1).
Score an article's segments against its image with CLIP and keep the top
`num_sentences` (8) as the encoder context (`sents_byclip`, consumed at
goodnews...py:562-563; dict files `*_clip{N}sent_contras_name_pos.json`,
train...match.py:772).

All segments of an article are embedded in one CLIP-text forward
(models/clip_text.clip_text_fwd) on the text tower's device; the ranking is
one cosine `torch.topk` there. On an exact tie of two similarities the
order of the tied segments is torch.topk's, which PyTorch does not promise;
JAX's `lax.top_k` puts the lower index first. Ties need two segments with
the same embedding direction (repeated sentences), and then both orders
give the same string only when the segments are equal.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from vacnic_tpu_torch.models.clip_text import clip_text_fwd

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def split_sentences(article: str) -> list[str]:
    """Plain punctuation-based segmentation (the reference's articles are
    pre-segmented in MongoDB `parsed_section` paragraphs; this covers raw
    text input)."""
    return [s.strip() for s in _SENT_SPLIT.split(article) if s.strip()]


@torch.no_grad()
def rank_segments(
    text_params,
    image_embed,  # [D] CLIP joint embedding of the image
    segment_ids,  # [S, 77] CLIP-tokenized segments
    num_sentences: int = 8,
) -> torch.Tensor:
    """Indices of the top-`num_sentences` segments by cosine similarity,
    best first, on the tower's device."""
    dev = text_params["token_embedding"]["weight"].device
    seg = clip_text_fwd(text_params, torch.as_tensor(segment_ids).to(dev))
    seg = seg / torch.linalg.norm(seg, dim=-1, keepdim=True)
    img = torch.as_tensor(image_embed).to(dev, torch.float32)
    img = img / torch.linalg.norm(img)
    sims = seg @ img
    k = min(num_sentences, sims.shape[0])
    return torch.topk(sims, k).indices


def retrieve_sentences(
    text_params,
    clip_tokenizer,
    image_embed,
    article: str,
    num_sentences: int = 8,
    context_length: int = 77,
) -> str:
    """article text + image embedding -> `sents_byclip` string (top segments
    joined in rank order, matching the dataset's consumption contract)."""
    segments = split_sentences(article)
    if not segments:
        return article
    params_context_length = text_params["positional_embedding"].shape[0]
    context_length = min(context_length, params_context_length)
    ids = np.zeros((len(segments), context_length), np.int32)
    for i, s in enumerate(segments):
        row = clip_tokenizer.encode(s, max_length=context_length)
        ids[i, : len(row)] = row
    idx = rank_segments(text_params, image_embed, ids, num_sentences).tolist()
    return " ".join(segments[i] for i in idx)
