"""The plain reference of the released training step: a frozen copy of the
arithmetic of the port's train/train_step.py (compute_losses with SECLA,
the CoLaM teacher and frozen CLIP on pixels), train/losses.py and
train/optim.py (two-group AdamW, the bart group's linear warmup, CLIP
frozen) at commit 024b7cd, in float32 (or on float8 operands, the control)
and without remat, which changes no value. It imports nothing of the port.

The step's dropout seeds are the port's: the state's seed is split once a
step into (the next state's seed, the step's seed); the multimodal forward
takes fold_in(step seed, 0), split into the encoder's and the decoder's."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import Model, Rng, fold_in, split


def clip_cls(r: Model, clip: dict, pixels: torch.Tensor) -> torch.Tensor:
    """The CLIP ViT's CLS feature after ln_post [B, width]: patches by one
    product, the class token, positions, ln_pre, pre-LN blocks with
    quick-gelu."""
    s = r.s
    p_sz, w = s["patch_size"], s["clip_width"]
    b, h, wd, c = pixels.shape
    gh, gw = h // p_sz, wd // p_sz
    x = pixels[:, :gh * p_sz, :gw * p_sz].float()
    x = x.reshape(b, gh, p_sz, gw, p_sz, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, -1)
    x = r.mm(x, clip["conv1"]["kernel"].reshape(-1, w))
    cls = clip["class_embedding"].float().expand(b, 1, w)
    x = torch.cat([cls, x], 1) + clip["positional_embedding"].float()[None]
    x = r.layernorm(clip["ln_pre"], x)
    for p in clip["layers"]:
        x = x + r.mha(p["attn"], r.layernorm(p["ln_1"], x), heads=s["clip_heads"])
        y = r.linear(p["mlp"]["c_fc"], r.layernorm(p["ln_2"], x))
        x = x + r.linear(p["mlp"]["c_proj"], y * torch.sigmoid(1.702 * y))
    return r.layernorm(clip["ln_post"], x[:, 0])


def _pool(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()[..., None]
    denom = m.sum(1)
    emb = (h * m).sum(1) / torch.clamp(denom, min=1e-9)
    return torch.where(denom > 0, emb, torch.ones_like(emb))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _batch_softmax(match: torch.Tensor) -> torch.Tensor:
    logits = torch.amax(match, dim=-1).sum(dim=-1) / match.shape[2]
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def losses(r: Model, params: dict, teacher: dict, batch: dict, dropout_rng: int) -> dict:
    """The step's loss terms -> {"loss", "txt_loss", "margin_loss",
    "face_name_loss"}; "loss" carries the gradient."""
    s = r.s
    pad, eos = s["pad_token_id"], s["eos_token_id"]
    src, tgt = batch["article_ids"], batch["caption_ids"]
    src_mask, tgt_mask = (src != pad).to(torch.int32), (tgt != pad).to(torch.int32)
    tgt_in = torch.roll(tgt, 1, dims=-1)
    tgt_in[:, 0] = eos
    plain = Model(s, "f32")  # the frozen parts: no dropout, float32
    with torch.no_grad():
        img = clip_cls(plain, params["clip"], batch["pixels"])
    x = dict(input_ids=src, attention_mask=src_mask, image_features=img)
    if not s["only_image"]:
        face = batch["face_emb"]
        x.update(face_features=face, face_mask=(face[:, :, -1] != 1).to(torch.int32),
                 name_ids=batch["names_art_ids"],
                 name_mask=(batch["names_art_ids"] != pad).to(torch.int32))
    rng_e, rng_d = split(fold_in(dropout_rng, 0))
    model = params["model"]
    enc = r.encode(model, x, dropout_rng=rng_e)
    dec = r.decode(model, tgt_in, enc["last_hidden"], src_mask, dropout_rng=rng_d)
    logp = torch.log_softmax(r.logits(model, dec), -1)
    nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
    valid = (tgt != pad).float()
    out = {"txt_loss": (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)}
    total = out["txt_loss"]
    if s["alpha"] > 0:
        with torch.no_grad():
            t_enc = plain.encode_text(teacher, src, src_mask)
            t_dec = plain.decode(teacher, tgt_in, t_enc, src_mask)
            t_pooled = _l2n(_pool(t_dec, tgt_mask))
        sim = (_l2n(_pool(dec, tgt_mask)) * t_pooled).sum(-1)
        out["margin_loss"] = torch.clamp(s["margin"] - sim, min=0.0).mean()
        total = total + s["alpha"] * out["margin_loss"]
    if not s["only_image"]:
        with torch.no_grad():
            names = batch["names_ids"]
            b, n, ln = names.shape
            e = model["encoder"]
            nh = plain.embed_and_norm(e["embed_tokens_ner"], e["embed_positions_ner"],
                                      e["layernorm_embedding_ner"], names.reshape(b * n, ln),
                                      Rng(None))
            name_embeds = nh.mean(1).reshape(b, n, -1)
        faces = enc["face"]
        face_ner = torch.einsum("and,bfd->abnf", name_embeds, faces)
        ner_face = torch.einsum("afd,bnd->abfn", faces, name_embeds)
        out["face_name_loss"] = _batch_softmax(face_ner) + _batch_softmax(ner_face)
        total = total + s["mapping_loss_weight"] * out["face_name_loss"]
    out["loss"] = total
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def lr_at(s: dict, count: int, num_training_steps: int) -> float:
    """HF's linear warmup and decay, in float32, as the port's schedule."""
    f32 = np.float32
    warmup = max(1, int(s["warmup_rate"] * num_training_steps))
    step = min(int(count), num_training_steps)
    if step < warmup:
        frac = f32(step) / f32(warmup)
    else:
        frac = max(f32(0.0), f32(num_training_steps - step) / f32(max(1, num_training_steps - warmup)))
    return float(f32(s["lr_bart"]) * f32(frac))


def train(r: Model, params: dict, teacher: dict, batches: list, seed: int, steps: int,
          num_training_steps: int) -> dict:
    """`steps` steps of AdamW on the bart group (params["model"]), from
    `seed` as the state's seed, batch i at step i. Updates params in place.
    -> {"loss": [a step's total], "grad_norms": [the first step's gradient,
    a bart leaf's norm], "bart": [the bart leaves, in order]}."""
    s = r.s
    bart = [t for _, t in _leaves(params["model"])]
    for t in bart:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in bart]
    nu = [torch.zeros_like(t) for t in bart]
    b1, b2, eps, wd = s["adam_b1"], s["adam_b2"], s["adam_eps"], s["weight_decay"]
    out = {"loss": [], "grad_norms": None, "bart": bart}
    rng = int(seed)
    for i in range(steps):
        rng, step_rng = split(rng)
        terms = losses(r, params, teacher, batches[i], step_rng)
        grads = torch.autograd.grad(terms["loss"], bart, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g.float() for t, g in zip(bart, grads)]
        out["loss"].append(float(terms["loss"].detach()))
        if i == 0:
            out["grad_norms"] = [float(torch.linalg.vector_norm(g)) for g in grads]
        count = i + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = lr_at(s, i, num_training_steps)
        with torch.no_grad():
            for t, g, m, v in zip(bart, grads, mu, nu):
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * g * (1 - b2))
                u = (m / c1) / (torch.sqrt(v / c2) + eps)
                t.add_((u + t * wd) * -lr)
    for t in bart:
        t.requires_grad_(False)
    return out
