"""The training step (port of vacnic_tpu/train/train_step.py): CLIP image
features (frozen, no grad), the differentiated multimodal forward, the
frozen CoLaM teacher (no grad), the SECLA or InfoNCE face-name loss, the
optional CLIP contrastive loss, then the gradients and the two-group AdamW
update (train/optim.py).

Differences from JAX, by design:
- the state is updated in place where JAX donates it: `step_fn` adds the
  update to the parameter tensors and the moments, and returns the same
  `TrainState` object;
- dropout seeds are 63-bit integers (models/layers.fold_in), not keys;
- the differentiated forward runs `mm_forward(allow_fused_encoder=False)`
  as JAX does, and `attention_core` takes its plain path under autograd,
  so no kernel without a backward is reached; the teacher, the CLIP
  feature tower and `eval_step` run under torch.no_grad() and use the
  kernels on the card (flash attention in the teacher, the fused encoder
  stack in `eval_step`).

Data parallel: `make_train_step(..., group=)` with a torch.distributed
process group of N ranks, one process and one device each, every rank
given the same global batch. Each rank takes its `local_batch_slice`, the
losses return its share of the global batch's (train/losses), its dropout
draws its rows of the global batch's masks (models/layers.RowShardSeed),
and the gradients and the metrics are all-reduced with SUM before the
gradient norm, the clipping and the update. So the step equals the
one-process step on the global batch up to the order of sums, the
invariant JAX's sharded step holds by construction. `fit` and `cli train`
stay one process, as the JAX package's `fit` has no mesh.

Tensor parallel: `make_train_step(..., model_group=)` (the dp x tp step of
JAX's `__graft_entry__._dryrun_body`, its groups from
core/distributed.grid_groups). `init_fn` keeps each rank's shard of the
params and the teacher by core/mesh's rule (core/tensor_parallel.
shard_params); the forwards take the rank's `ModelShard` and issue the
model group's collectives themselves; every gradient leaf, shard or
whole, is then summed over the data group only (a replicated leaf's
gradient is already the same on every model rank); the gradient norm and
the clipping sum the cut leaves' squares over the model group. Under a
model group, a data group of one process (a dp 1 grid) is no group.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from vacnic_tpu_torch.core import tensor_parallel as TP
from vacnic_tpu_torch.core.config import VacnicConfig, dtype_of
from vacnic_tpu_torch.core.device import as_tensor, resolve_device
from vacnic_tpu_torch.core.distributed import local_batch_slice
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.clip_vit import clip_image_embed, clip_vision_fwd
from vacnic_tpu_torch.models.layers import RowShardSeed, fold_in, split
from vacnic_tpu_torch.models.weights_io import tree_to
from vacnic_tpu_torch.train import losses as L
from vacnic_tpu_torch.train.optim import global_norm, make_optimizer, trainable

Params = dict[str, Any]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params   # {"model": multimodal BART, "clip": vision tower[, "clip_text"]}
    teacher: Params  # frozen text-only BART (the CoLaM teacher)
    opt_state: dict  # train/optim.Optimizer state: moments and step counts
    rng: int         # the dropout seed state, split once a step


def create_mask(ids: torch.Tensor) -> torch.Tensor:
    """1 where the id is not the pad id (1), else 0."""
    return (ids != 1).to(torch.int32)


def face_mask_from_emb(face_emb: torch.Tensor) -> torch.Tensor:
    """Pad face rows are all-ones vectors: the mask keys off the last
    component == 1."""
    return (face_emb[:, :, -1] != 1).to(torch.int32)


def device_of(params: Params) -> torch.device:
    return params["shared"]["weight"].device


def _feed(batch: dict, dev: torch.device) -> dict[str, torch.Tensor]:
    """The batch's arrays on `dev`; lists and strings (captions) stay behind."""
    return {k: as_tensor(v, dev) for k, v in batch.items() if not isinstance(v, (list, str))}


@torch.no_grad()
def embed_names_3d(model_params: Params, names_ids_3d: torch.Tensor, cfg) -> torch.Tensor:
    """No-grad embedding of [B, N, Lname] per-name ids through the NER table,
    positions and LN, unmasked mean over the length -> [B, N, d] f32."""
    bsz, n, ln = names_ids_3d.shape
    enc = model_params["encoder"]
    h = B.embed_and_norm(enc["embed_tokens_ner"], enc["embed_positions_ner"],
                         enc["layernorm_embedding_ner"], names_ids_3d.reshape(bsz * n, ln),
                         cfg, torch.float32)
    return h.mean(dim=1).reshape(bsz, n, -1)


@torch.no_grad()
def embed_tgt(model_params: Params, tgt_ids: torch.Tensor, cfg) -> torch.Tensor:
    """No-grad decoder-side token + position embedding of target ids."""
    return B.embed_and_norm(model_params["shared"], model_params["decoder"]["embed_positions"],
                            model_params["decoder"]["layernorm_embedding"], tgt_ids, cfg,
                            torch.float32)


@torch.no_grad()
def get_hidden_states_ner(model_params: Params, src_ids, src_mask, img_feat, name_ids,
                          name_mask, face_features, face_mask, cfg, fcfg) -> torch.Tensor:
    """No-grad encoder pass returning the NER stream's hidden states."""
    out = F.mm_encoder_fwd(model_params, src_ids, src_mask, img_feat, cfg, fcfg,
                           face_features=face_features, face_mask=face_mask,
                           name_ids=name_ids, name_mask=name_mask, add_ner_ffn=True)
    return out["ner"]


def _image_features(params: Params, feed: dict, cfg: VacnicConfig, dtype,
                    tp: TP.ModelShard | None = None) -> torch.Tensor:
    if "image_cls" in feed:
        return feed["image_cls"]
    with torch.no_grad():  # frozen CLIP: torch.no_grad in the reference
        return clip_vision_fwd(params["clip"], feed["pixels"], cfg.clip, dtype, tp)[1]


def _mm_kwargs(feed: dict, fcfg) -> dict[str, Any]:
    if fcfg.only_image:
        return {}
    face_emb = feed["face_emb"]
    return dict(face_features=face_emb, face_mask=face_mask_from_emb(face_emb),
                name_ids=feed["names_art_ids"], name_mask=create_mask(feed["names_art_ids"]),
                add_ner_ffn=True)


def compute_losses(params: Params, teacher: Params, batch: dict, cfg: VacnicConfig,
                   dropout_rng: int | None, group=None, tp: TP.ModelShard | None = None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The reference's loss composition -> (total, metrics). Runs on the
    device of params["model"]; the batch is moved there. With a process
    group, `batch` is this rank's rows and every term is its share of the
    global batch's (train/losses). With `tp`, params and teacher are this
    model rank's shards and every term is whole on each model rank."""
    bart_cfg, fcfg, tcfg = cfg.bart, cfg.fusion, cfg.train
    dtype = dtype_of(tcfg.compute_dtype)
    dev = device_of(params["model"])
    feed = _feed(batch, dev)

    src_ids, tgt_ids = feed["article_ids"], feed["caption_ids"]
    src_mask, tgt_mask = create_mask(src_ids), create_mask(tgt_ids)
    tgt_input = B.shift_tokens_right(tgt_ids, bart_cfg.pad_token_id, bart_cfg.eos_token_id)
    img_feat_cls = _image_features(params, feed, cfg, dtype, tp)

    # the differentiated forward: never the fused encoder (its kernels have
    # no backward), as in JAX
    out = F.mm_forward(params["model"], src_ids, src_mask, tgt_input, img_feat_cls, bart_cfg,
                       fcfg, dropout_rng=None if dropout_rng is None else fold_in(dropout_rng, 0),
                       dtype=dtype, remat=tcfg.grad_checkpoint, allow_fused_encoder=False,
                       device=dev, tp=tp, **_mm_kwargs(feed, fcfg))

    txt_loss = L.lm_cross_entropy(out["logits"], tgt_ids, bart_cfg.pad_token_id, group=group)
    metrics = {"txt_loss": txt_loss}
    total = txt_loss

    if tcfg.alpha > 0:  # CoLaM against the frozen text-only teacher
        if "teacher_pooled" in feed:  # the loop's cross-epoch cache
            t_pooled = feed["teacher_pooled"].float()
        else:
            with torch.no_grad():  # deterministic teacher: no dropout, no grad
                t_out = B.bart_forward(teacher, src_ids, src_mask, tgt_input, bart_cfg, dtype,
                                       tp=tp)
                t_pooled = L.l2_normalize(L.pool(t_out["decoder_hidden"].float(), tgt_mask))
            if tcfg.teacher_cache:
                metrics["teacher_pooled"] = t_pooled  # popped by the loop before logging
        margin_loss = L.colam_margin_from_pooled(out["decoder_hidden"].float(), t_pooled,
                                                 tgt_mask, tcfg.margin, group=group)
        metrics["margin_loss"] = margin_loss
        total = total + tcfg.alpha * margin_loss

    if not fcfg.only_image and not tcfg.no_mapping:  # face-name mapping loss
        if tcfg.use_secla:
            name_embeds = embed_names_3d(params["model"], feed["names_ids"], bart_cfg)
            fn_loss = L.secla_loss(out["hidden_states_face"].float(), name_embeds, group=group)
        else:
            flat_ids = feed["names_ids_flatten"]
            flat_mask = create_mask(flat_ids)
            with torch.no_grad():  # only its detached "ner" stream is used
                aux = F.mm_encoder_fwd(
                    params["model"], src_ids, src_mask, img_feat_cls, bart_cfg, fcfg,
                    face_features=feed["face_emb"], face_mask=face_mask_from_emb(feed["face_emb"]),
                    name_ids=flat_ids, name_mask=flat_mask, add_ner_ffn=False, dtype=dtype,
                    tp=tp)
            # exp(logit_scale) of the text tower when one is loaded, else of
            # the vision tree, else OpenAI CLIP's trained exp(ln 100) = 100
            scale_src = params.get("clip_text") or params.get("clip") or {}
            log_scale = scale_src.get("logit_scale")
            if log_scale is None:
                log_scale = torch.log(torch.tensor(100.0, device=dev))
            fn_loss = L.face_name_infonce(
                out["hidden_states_face"].float(), face_mask_from_emb(feed["face_emb"]),
                aux["ner"].float(), flat_mask, torch.exp(log_scale), group=group)
        metrics["face_name_loss"] = fn_loss
        total = total + tcfg.mapping_loss_weight * fn_loss

    # the optional CLIP image/caption loss (off in the released script)
    if not tcfg.no_clip_loss and "pixels" in feed and "caption_ids_clip" in feed:
        from vacnic_tpu_torch.models.clip_text import clip_text_fwd

        if "clip_text" not in params:
            raise ValueError("train.no_clip_loss=false needs a CLIP text tower: build "
                             "params['clip_text'] with clip_text_init or "
                             "convert_clip_text_openai; params['clip'] holds only the "
                             "vision tower")
        img_emb = clip_image_embed(params["clip"], feed["pixels"], cfg.clip, dtype, tp)
        txt_emb = clip_text_fwd(params["clip_text"], feed["caption_ids_clip"], dtype,
                                num_heads=cfg.clip.text_heads, tp=tp)
        clip_loss = L.clip_contrastive_loss(img_emb, txt_emb,
                                            torch.exp(params["clip_text"]["logit_scale"]),
                                            group=group)
        metrics["clip_loss"] = clip_loss
        total = total + clip_loss

    metrics["loss"] = total
    return total, metrics


def perturb_bos(params: Params, generator: torch.Generator, scale: float = 1.0) -> Params:
    """--perturb: Gaussian noise from `generator` added to the BOS row of the
    shared embedding. Returns a new tree; the input is left as it is."""
    w = params["shared"]["weight"]
    noise = torch.randn(w.shape[1], generator=generator, device=generator.device) * scale
    w = w.detach().clone()
    w[0] += noise.to(w.device, w.dtype)
    out = dict(params)
    out["shared"] = {"weight": w}
    return out


def local_rows(batch: dict, group) -> dict:
    """This rank's contiguous share of every array, tensor and list of the
    global batch whose leading dimension is the batch's rows (those of
    article_ids); anything else is kept whole. The rows must divide by the
    group's size."""
    rows = len(batch["article_ids"])
    if rows % dist.get_world_size(group):
        raise ValueError(f"data-parallel step: a global batch of {rows} rows does not divide "
                         f"over {dist.get_world_size(group)} ranks")
    sl = local_batch_slice(rows, group)

    def cut(v):
        if (isinstance(v, (np.ndarray, torch.Tensor, list)) and getattr(v, "ndim", 1)
                and len(v) == rows):
            return v[sl]
        return v

    return {k: cut(v) for k, v in batch.items()}


def _all_reduce_sum(tensors: list, group) -> list:
    """The tensors (None kept) summed over the group's ranks, through one
    flat buffer a dtype: one collective a dtype instead of one a leaf."""
    out = list(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def loss_and_grads(params: Params, teacher: Params, batch: dict, cfg: VacnicConfig,
                   dropout_rng: int | None, group=None, tp: TP.ModelShard | None = None):
    """-> (metrics, grads): the detached metrics of compute_losses and the
    gradient of the total loss for each leaf of `params` (None where the
    leaf is not trained). With a group, of the global batch: this rank's
    rows are taken from `batch` (the global one), its dropout draws its rows
    of the global masks, and the gradients and the metrics but
    "teacher_pooled" (this rank's rows) come back summed over the ranks.
    With `tp` (the model group's), params and teacher are this rank's
    shards, and so are the gradients of the cut leaves."""
    leaves = [p for _, p in leaves_with_path(params)]
    wrt = [trainable(p) and p.requires_grad for p in leaves]
    if group is not None:
        batch = local_rows(batch, group)
        if dropout_rng is not None:
            dropout_rng = RowShardSeed(dropout_rng, dist.get_rank(group),
                                       dist.get_world_size(group))
    with record_function("train_step.forward"):
        loss, metrics = compute_losses(params, teacher, batch, cfg, dropout_rng, group=group,
                                       tp=tp)
    with record_function("train_step.backward"):
        got = iter(torch.autograd.grad(loss, [p for p, w in zip(leaves, wrt) if w],
                                       allow_unused=True))
    grads = [next(got) if w else None for w in wrt]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is not None:
        with record_function("train_step.all_reduce"):
            grads = _all_reduce_sum(grads, group)
            keys = [k for k in metrics if k != "teacher_pooled"]
            summed = _all_reduce_sum([torch.stack([metrics[k].float() for k in keys])], group)
            metrics.update(zip(keys, summed[0].unbind()))
    return metrics, grads


def heads_of(cfg: VacnicConfig):
    """path of an attention in the params or the teacher tree -> its head
    count (core/tensor_parallel.check_heads)."""
    def heads(path: tuple) -> int:
        if path[0] == "clip":
            return cfg.clip.heads
        if path[0] == "clip_text":
            return cfg.clip.text_heads
        if "decoder" in path:
            return cfg.bart.decoder_attention_heads
        return cfg.bart.encoder_attention_heads

    return heads


def make_train_step(cfg: VacnicConfig, num_training_steps: int, mu_dtype=None, nu_dtype=None,
                    device=None, group=None, model_group=None):
    """-> (init_fn, step_fn). init_fn(params, teacher, rng: int) moves the
    trees to `device` ("cuda" by default; leaves already there are kept, not
    copied) and marks params' floating leaves as requiring grad.
    step_fn(state, batch) -> (state, metrics) updates the state in place and
    returns it; metrics are detached 0-d tensors on the device (and
    "teacher_pooled" [B, d] when the teacher cache asks for it). Its parts
    run under the profiler ranges "train_step.forward", ".backward",
    ".all_reduce" (with a group) and ".optimizer" (the backward's ops run on
    autograd's own thread on the card, outside its range); the model
    group's collectives run under "tensor_parallel.all_reduce" (and
    ".all_gather"), inside those.

    `group`: a torch.distributed process group, each rank a process on its
    own device (`core/distributed.initialize`). Every rank calls step_fn
    with the same global batch; the step is that batch's one-process step
    (module docstring). init_fn then also broadcasts the first rank's trees
    to the others, in place, so every rank starts from the same weights.

    `model_group`: the process's model group of a dp x tp grid (`group` is
    then its data group). init_fn takes the whole trees, the same on every
    rank of a model group (made from one seed), keeps this rank's shards
    (refusing a group size that does not divide an attention's heads or a
    cut dimension) and broadcasts the shards over the data group; the
    state then holds shards, which `core/tensor_parallel.gather_params`
    makes whole again; a data group of one process (a dp 1 grid) is then
    no group, and a model group of one process is none either."""
    tx = make_optimizer(cfg.train, num_training_steps, train_clip=not cfg.train.freeze_clip,
                        mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    dev = resolve_device(device)
    if model_group is not None and group is not None and dist.get_world_size(group) == 1:
        group = None
    tp = TP.model_shard(model_group)

    def init_fn(params: Params, teacher: Params, rng: int) -> TrainState:
        params, teacher = tree_to(params, dev), tree_to(teacher, dev)
        if tp is not None:
            for tree in (params, teacher):
                TP.check_heads(tree, tp.size, heads_of(cfg))
            params, teacher = TP.shard_params(params, tp), TP.shard_params(teacher, tp)
        if group is not None:
            src = dist.get_global_rank(group, 0)
            with torch.no_grad():
                for _, t in leaves_with_path(params) + leaves_with_path(teacher):
                    if isinstance(t, torch.Tensor):
                        dist.broadcast(t, src=src, group=group)
        for _, p in leaves_with_path(params):
            if trainable(p):
                p.requires_grad_(True)
        return TrainState(step=0, params=params, teacher=teacher,
                          opt_state=tx.init(params), rng=int(rng))

    def step_fn(state: TrainState, batch: dict):
        rng, dropout_rng = split(state.rng)
        metrics, grads = loss_and_grads(state.params, state.teacher, batch, cfg, dropout_rng,
                                        group, tp)
        cut = [TP.is_cut(path, p) for path, p in leaves_with_path(state.params)] if tp else None
        with record_function("train_step.optimizer"):
            # a leaf without a gradient counts as 0; under tp the model group's sum
            metrics["grad_norm"] = global_norm(grads, cut, tp)
            tx.step_(state.params, grads, state.opt_state, cut, tp)
        state.step += 1
        state.rng = rng
        return state, metrics

    return init_fn, step_fn


@torch.no_grad()
def eval_step(params: Params, batch: dict, cfg: VacnicConfig, device=None) -> dict:
    """Teacher-forced validation: the LM loss and the greedy argmax ids
    [B, T], deterministic. It leaves allow_fused_encoder at its default, so
    an eligible config runs the fused encoder stack."""
    bart_cfg, fcfg = cfg.bart, cfg.fusion
    dtype = dtype_of(cfg.train.compute_dtype)
    dev = resolve_device(device)
    params = tree_to(params, dev)
    feed = _feed(batch, dev)
    src_ids, tgt_ids = feed["article_ids"], feed["caption_ids"]
    tgt_input = B.shift_tokens_right(tgt_ids, bart_cfg.pad_token_id, bart_cfg.eos_token_id)
    img_feat_cls = _image_features(params, feed, cfg, dtype)
    out = F.mm_forward(params["model"], src_ids, create_mask(src_ids), tgt_input, img_feat_cls,
                       bart_cfg, fcfg, dtype=dtype, device=dev, **_mm_kwargs(feed, fcfg))
    return {"val_loss": L.lm_cross_entropy(out["logits"], tgt_ids, bart_cfg.pad_token_id),
            "argmax_ids": out["logits"].argmax(dim=-1)}
