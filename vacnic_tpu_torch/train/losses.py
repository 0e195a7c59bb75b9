"""Training losses (port of vacnic_tpu/train/losses.py): caption LM,
CoLaM margin, SECLA face naming, the face-name and CLIP InfoNCE losses.

total = txt_loss + mapping_loss_weight * face_name_loss + alpha * margin_loss
(+ the optional CLIP contrastive loss). The contrastive losses are B x B
over the whole batch. `.detach()` stands where JAX writes stop_gradient.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def _masked_mean(last_hidden: torch.Tensor, mask: torch.Tensor):
    m = mask.to(last_hidden.dtype)[..., None]
    summed = (last_hidden * m).sum(dim=1)
    denom = m.sum(dim=1)
    # the divide is guarded before the `where`: a raw 0/0 would be NaN, and
    # its gradient leaks through the branch `where` does not take (nan * 0)
    return summed / torch.clamp(denom, min=1e-9), denom


def pool(last_hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over axis 1; an all-masked row gives 1.0 (the reference's
    nan_to_num(nan=1.0) after 0/0)."""
    emb, denom = _masked_mean(last_hidden, mask)
    return torch.where(denom > 0, emb, torch.ones_like(emb))


def pool_replace(last_hidden: torch.Tensor, mask: torch.Tensor,
                 img_feat: torch.Tensor) -> torch.Tensor:
    """As `pool`, but an all-masked row takes the (detached) image feature."""
    emb, denom = _masked_mean(last_hidden, mask)
    return torch.where(denom > 0, emb, img_feat.detach())


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=axis, keepdim=True), min=eps)


# ---------------------------------------------------------------------------
# LM loss
# ---------------------------------------------------------------------------

def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = 1) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=pad): the mean NLL over non-pad labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    valid = (labels != ignore_index).float()
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


# ---------------------------------------------------------------------------
# CoLaM margin loss
# ---------------------------------------------------------------------------

def colam_margin_loss(decoder_hidden: torch.Tensor, teacher_decoder_hidden: torch.Tensor,
                      caption_mask: torch.Tensor, margin: float) -> torch.Tensor:
    """mean(max(0, margin - cos(pooled student, pooled teacher))): the
    HingeEmbeddingLoss with target -1 of the reference."""
    h_t = l2_normalize(pool(teacher_decoder_hidden.detach(), caption_mask))
    return colam_margin_from_pooled(decoder_hidden, h_t, caption_mask, margin)


def colam_margin_from_pooled(decoder_hidden: torch.Tensor, teacher_pooled: torch.Tensor,
                             caption_mask: torch.Tensor, margin: float) -> torch.Tensor:
    """CoLaM against the teacher's pooled, L2-normalised [B, d] state (what
    the training loop caches across epochs)."""
    h = l2_normalize(pool(decoder_hidden, caption_mask))
    sim = (h * teacher_pooled.detach()).sum(dim=-1)
    return torch.clamp(margin - sim, min=0.0).mean()


# ---------------------------------------------------------------------------
# SECLA
# ---------------------------------------------------------------------------

def _batch_softmax(match: torch.Tensor) -> torch.Tensor:
    """match [B, B, spans, regions] -> CE of the span-averaged B x B logits
    against the identity. The max over regions is torch.amax, whose gradient
    is split evenly among tied maxima as jnp.max's is (padded faces are
    identical rows, so ties occur); Tensor.max(dim) would give it to one."""
    num_spans = match.shape[2]
    logits = torch.amax(match, dim=-1).sum(dim=-1) / num_spans
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def secla_loss(face_states: torch.Tensor, name_embeds: torch.Tensor) -> torch.Tensor:
    """Symmetric weakly supervised face naming: face_states [B, F, d] (the
    fusion encoder's face stream), name_embeds [B, N, d] (no-grad)."""
    face_ner = torch.einsum("and,bfd->abnf", name_embeds, face_states)
    ner_face = torch.einsum("afd,bnd->abfn", face_states, name_embeds)
    return _batch_softmax(face_ner) + _batch_softmax(ner_face)


# ---------------------------------------------------------------------------
# InfoNCE
# ---------------------------------------------------------------------------

def _sym_infonce(a: torch.Tensor, b: torch.Tensor, logit_scale) -> torch.Tensor:
    """0.5 CE(a b^T) + 0.5 CE(b a^T) with identity targets."""
    logits = logit_scale * (a @ b.T)
    logp1 = torch.log_softmax(logits, dim=-1)
    logp2 = torch.log_softmax(logits.T, dim=-1)
    return -0.5 * logp1.diagonal().mean() - 0.5 * logp2.diagonal().mean()


def face_name_infonce(face_states: torch.Tensor, face_mask: torch.Tensor,
                      name_states: torch.Tensor, name_mask: torch.Tensor,
                      logit_scale) -> torch.Tensor:
    """The non-SECLA mapping loss: pooled, normalised face stream against the
    detached pooled flat-name stream, CLIP-style, scaled by logit_scale."""
    f = l2_normalize(pool(face_states, face_mask))
    n = l2_normalize(pool(name_states.detach(), name_mask))
    return _sym_infonce(n, f, logit_scale)


def clip_contrastive_loss(image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                          logit_scale) -> torch.Tensor:
    """The optional CLIP image/caption loss."""
    return _sym_infonce(l2_normalize(image_embeds), l2_normalize(text_embeds), logit_scale)
