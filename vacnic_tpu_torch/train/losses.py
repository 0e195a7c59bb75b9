"""Training losses (port of vacnic_tpu/train/losses.py): caption LM,
CoLaM margin, SECLA face naming, the face-name and CLIP InfoNCE losses.

total = txt_loss + mapping_loss_weight * face_name_loss + alpha * margin_loss
(+ the optional CLIP contrastive loss). The contrastive losses are B x B
over the whole batch. `.detach()` stands where JAX writes stop_gradient.

Data parallel (`group`, a torch.distributed process group whose ranks each
hold an equal contiguous share of the global batch): every loss returns
this rank's share, such that the shares summed over the ranks are the loss
of the global batch, and so are the gradients they give each rank summed
(the training step all-reduces both with SUM). The token mean and the row
mean divide the rank's sum by the global count; the contrastive losses see
the global batch's rows through `gather_rows`, compute the global B x B
loss on every rank, and return it over the world size, the gather's
backward summing the ranks' gradients for this rank's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vacnic_tpu_torch.models.products import product


# ---------------------------------------------------------------------------
# Data parallel
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """all_gather of equal row shares in rank order; the backward sums the
    incoming gradient over the ranks (every rank's loss reads every rank's
    rows) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.rows = group, (rank * x.shape[0], (rank + 1) * x.shape[0])
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.rows[0]:ctx.rows[1]], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of every rank's `x` in rank order (x itself without a
    group); differentiable where x requires grad."""
    return x if group is None else _GatherRows.apply(x, group)


def world_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x (no gradient) summed over the group's ranks; x without a group."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


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
                     ignore_index: int = 1, group=None) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=pad): the mean NLL over non-pad labels
    (with a group: this rank's NLL sum over the global count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    valid = (labels != ignore_index).float()
    return (nll * valid).sum() / torch.clamp(_global_sum(valid.sum(), group), min=1.0)


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
                             caption_mask: torch.Tensor, margin: float,
                             group=None) -> torch.Tensor:
    """CoLaM against the teacher's pooled, L2-normalised [B, d] state (what
    the training loop caches across epochs); with a group, this rank's sum
    over the global rows."""
    h = l2_normalize(pool(decoder_hidden, caption_mask))
    sim = (h * teacher_pooled.detach()).sum(dim=-1)
    hinge = torch.clamp(margin - sim, min=0.0)
    return hinge.mean() if group is None else hinge.sum() / (sim.shape[0] * world_size(group))


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


def secla_loss(face_states: torch.Tensor, name_embeds: torch.Tensor,
               group=None) -> torch.Tensor:
    """Symmetric weakly supervised face naming: face_states [B, F, d] (the
    fusion encoder's face stream), name_embeds [B, N, d] (no-grad), B x B
    over the global batch."""
    if group is not None:
        face_states = gather_rows(face_states, group)
        name_embeds = gather_rows(name_embeds.detach(), group)
        return secla_loss(face_states, name_embeds) / world_size(group)
    return (_batch_softmax(_pair_products(name_embeds, face_states))
            + _batch_softmax(_pair_products(face_states, name_embeds)))


def _pair_products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [A, P, d], y [B, Q, d] -> [A, B, P, Q]: every row of x against
    every row of y, in float32."""
    (a, p, d), (b, q, _) = x.shape, y.shape
    xy = product(x.reshape(a * p, d), y.reshape(b * q, d).t(), cotangent="f32")
    return xy.reshape(a, p, b, q).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# InfoNCE
# ---------------------------------------------------------------------------

def _sym_infonce(a: torch.Tensor, b: torch.Tensor, logit_scale) -> torch.Tensor:
    """0.5 CE(a b^T) + 0.5 CE(b a^T) with identity targets."""
    logits = logit_scale * product(a, b.T, cotangent="f32")
    logp1 = torch.log_softmax(logits, dim=-1)
    logp2 = torch.log_softmax(logits.T, dim=-1)
    return -0.5 * logp1.diagonal().mean() - 0.5 * logp2.diagonal().mean()


def face_name_infonce(face_states: torch.Tensor, face_mask: torch.Tensor,
                      name_states: torch.Tensor, name_mask: torch.Tensor,
                      logit_scale, group=None) -> torch.Tensor:
    """The non-SECLA mapping loss: pooled, normalised face stream against the
    detached pooled flat-name stream, CLIP-style, scaled by logit_scale."""
    f = gather_rows(l2_normalize(pool(face_states, face_mask)), group)
    n = gather_rows(l2_normalize(pool(name_states.detach(), name_mask)), group)
    return _sym_infonce(n, f, logit_scale) / world_size(group)


def clip_contrastive_loss(image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                          logit_scale, group=None) -> torch.Tensor:
    """The optional CLIP image/caption loss."""
    img = gather_rows(l2_normalize(image_embeds), group)
    txt = gather_rows(l2_normalize(text_embeds), group)
    return _sym_infonce(img, txt, logit_scale) / world_size(group)
