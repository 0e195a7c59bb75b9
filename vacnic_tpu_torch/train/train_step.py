"""Mask helpers of the training step that the generate path needs (port of
part of vacnic_tpu/train/train_step.py). The rest of the step comes with
training."""

from __future__ import annotations

import torch


def create_mask(ids: torch.Tensor) -> torch.Tensor:
    """1 where the id is not the pad id (1), else 0."""
    return (ids != 1).to(torch.int32)


def face_mask_from_emb(face_emb: torch.Tensor) -> torch.Tensor:
    """Pad face rows are all-ones vectors: the mask keys off the last
    component == 1."""
    return (face_emb[:, :, -1] != 1).to(torch.int32)
