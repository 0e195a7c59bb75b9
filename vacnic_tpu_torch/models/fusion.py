"""Multimodal BART fusion encoder (port of vacnic_tpu/models/fusion.py).

The image prompt comes from the CLS feature through the clipcap mapper (the
released configurations') or from the patch tokens through the mlp mapper
(`prompt_mlp_type="mlp"`, KV = map_size[-1] prompt rows);
`extract_visual_prompt` is the mapping alone, without a gradient.

Per fusion layer, with streams threaded layer to layer:
  img  : residual FFN (d -> ffn_dim -> d) + LN
  face : residual FFN (d -> 3072 -> d) + LN
  ner  : attention of the name states over concat(face, name), then a
         length-compressing FFN 80 -> 4*20 -> 20 across the length dimension
         (the reference's raw reshape, not a transpose) + LN
  text : self-attention (+ pad mask), cross-attention to
         concat(img_prompt, ner_prefix) (only_image: img_prompt), FFN + LN.

`mm_encoder_fwd` is the layer-by-layer reference and the differentiated
training path (dropout at JAX's sites, per-layer remat); `mm_encoder_fwd_fused`
runs the stream prologue here and the text path through
kernels/encoder_stack.encoder_text_stack (CUDA on the card, its plain twin on
the CPU), which has no backward. `mm_forward` is the teacher-forced forward
of the whole model (encoder, decoder, tied LM head), an entry point like
infer/generate's.

Tensor parallelism (`tp`, core/tensor_parallel) runs the layer-by-layer
encoder on a model rank's shard: the attentions by heads, the img/face/text
FFNs and ner_map_up/down as column/row pairs, the clipcap mapper's
prompt_fc1/prompt_fc2 likewise; the mlp mapper's stages run whole. The
fused encoder takes whole weights only (it serves inference, where the tree
is whole).
"""

from __future__ import annotations

import copy
from typing import Any

import torch

from vacnic_tpu_torch.core.config import BartConfig, FusionConfig
from vacnic_tpu_torch.core.device import as_tensor, resolve_device
from vacnic_tpu_torch.core.tensor_parallel import ModelShard, copy_to_model_parallel
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models.layers import (
    ACT2FN,
    NO_DROPOUT,
    Params,
    RngStream,
    column_linear,
    column_seed,
    dropout,
    embedding_init,
    expand_mask,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mha,
    mha_init,
    row_linear,
    split,
)
from vacnic_tpu_torch.models.products import product
from vacnic_tpu_torch.models.weights_io import tree_to


# ---------------------------------------------------------------------------
# Prompt mappers: clipcap (the released configs') and mlp (over patch tokens)
# ---------------------------------------------------------------------------

def prompt_mlp_clipcap_init(g: torch.Generator, img_size: int, prompt_size: int,
                            device=None) -> Params:
    """ClipCap mapper: Linear(img -> img*P/2) -> tanh -> Linear(-> img*P)."""
    mid = (img_size * prompt_size) // 2
    return {"prompt_fc1": linear_init(g, img_size, mid, device),
            "prompt_fc2": linear_init(g, mid, img_size * prompt_size, device)}


def prompt_mlp_clipcap_fwd(p: Params, cls_feat: torch.Tensor, img_size: int,
                           prompt_size: int, tp: ModelShard | None = None) -> torch.Tensor:
    """[B, img_size] -> [B, prompt_size, img_size]."""
    h = torch.tanh(column_linear(p["prompt_fc1"], copy_to_model_parallel(cls_feat, tp), tp))
    h = row_linear(p["prompt_fc2"], h, tp)
    return h.reshape(h.shape[0], prompt_size, img_size)


def prompt_mlp_patch_init(g: torch.Generator, map_size: tuple[int, ...],
                          device=None) -> Params:
    """The mlp mapper: one linear map_size[i] -> map_size[i + 1] a stage,
    over the patch dimension."""
    return {"stages": tuple(linear_init(g, map_size[i], map_size[i + 1], device)
                            for i in range(len(map_size) - 1))}


def prompt_mlp_patch_fwd(p: Params, patch_feat: torch.Tensor) -> torch.Tensor:
    """[B, n_patches, width] -> [B, map_size[-1], width]: the stages with
    tanh between them (none after the last). The reference reshapes the
    patch tokens to [B, width, n_patches], a reinterpretation of the
    row-major memory that mixes patch and channel axes, not a transpose;
    torch.reshape has numpy's row-major semantics whatever the strides, so
    converted checkpoints of this mapper match."""
    b, n_patches, width = patch_feat.shape
    x = patch_feat.reshape(b, width, n_patches)
    n = len(p["stages"])
    for i, stage in enumerate(p["stages"]):
        x = linear(stage, x)
        if i < n - 1:
            x = torch.tanh(x)
    return x.reshape(b, -1, width)


def map_image_prompt(enc: Params, image_features: torch.Tensor, cfg: BartConfig,
                     fcfg: FusionConfig, tp: ModelShard | None = None) -> torch.Tensor:
    """CLIP features -> prompt tokens [B, P, d_model]: the CLS feature
    [B, img_size] through clipcap, or patch tokens [B, n_patches, width]
    through the mlp mapper, then visual_map (768 -> 1024) at d_model 1024.
    Under `tp` the clipcap pair runs column/row-parallel; the mlp stages
    are replicated (their parent is a tuple index, which the sharding rule
    does not cut) and run whole on every rank."""
    if fcfg.prompt_mlp_type == "clipcap":
        img = prompt_mlp_clipcap_fwd(enc["prompt_mlp"], image_features, fcfg.img_size,
                                     fcfg.prompt_size, tp)
    else:
        img = prompt_mlp_patch_fwd(enc["prompt_mlp"], image_features)
    if cfg.d_model == 1024:
        img = linear(enc["visual_map"], img)
    return img


@torch.no_grad()
def extract_visual_prompt(params: Params, image_features, cfg: BartConfig,
                          fcfg: FusionConfig, device=None) -> torch.Tensor:
    """The prompt tokens of `image_features` without a gradient (the
    reference's prompt-representation analysis): map_image_prompt on the
    mapper's and visual_map's leaves, moved to `device` ("cuda" by
    default) with the features."""
    dev = resolve_device(device)
    enc = tree_to({k: v for k, v in params["encoder"].items()
                   if k in ("prompt_mlp", "visual_map")}, dev)
    return map_image_prompt(enc, as_tensor(image_features, dev), cfg, fcfg)


def embed_ner_stream(enc: Params, name_ids: torch.Tensor, cfg: BartConfig,
                     dtype, rngs: RngStream = NO_DROPOUT) -> torch.Tensor:
    """NER stream embedding: separate table + positions + LN + dropout."""
    return B.embed_and_norm(enc["embed_tokens_ner"], enc["embed_positions_ner"],
                            enc["layernorm_embedding_ner"], name_ids, cfg, dtype, rngs=rngs)


# ---------------------------------------------------------------------------
# Layer-by-layer encoder (reference path)
# ---------------------------------------------------------------------------

def _ner_prefix(p: Params, ner: torch.Tensor, act, cfg: BartConfig, fcfg: FusionConfig,
                rngs: RngStream = NO_DROPOUT, tp: ModelShard | None = None) -> torch.Tensor:
    bsz, ner_len, d = ner.shape
    t = ner.reshape(bsz, d, ner_len)  # the reference reshapes, not transposes
    t = column_linear(p["ner_map_up"], copy_to_model_parallel(t, tp), tp)
    t = dropout(act(t), cfg.activation_dropout, column_seed(rngs.next(), tp))
    t = dropout(row_linear(p["ner_map_down"], t, tp), cfg.dropout, rngs.next())
    return layernorm(p["ner_map_layer_norm"], t.reshape(bsz, fcfg.max_ner_type_len_gt, d))


def fusion_encoder_layer_fwd(p: Params, x: torch.Tensor, attn_mask: torch.Tensor,
                             streams: dict[str, Any], masks: dict[str, Any],
                             cfg: BartConfig, fcfg: FusionConfig, fused: bool,
                             add_ner_ffn: bool = True, rngs: RngStream = NO_DROPOUT,
                             tp: ModelShard | None = None):
    """One encoder layer; `streams` = {"img", "face", "ner"} threaded between
    layers. Returns (x, streams). Dropout draws from `rngs` in JAX's order."""
    act = ACT2FN[cfg.activation_function]
    if not fused:
        return B.encoder_layer_fwd(p, x, attn_mask, cfg, rngs, tp), streams

    img = B.residual_ffn(p["img_up"], p["img_down"], p["img_layer_norm"], streams["img"], act,
                         cfg, rngs, tp)
    face, ner = streams.get("face"), streams.get("ner")
    if not fcfg.only_image:
        face = B.residual_ffn(p["face_up"], p["face_down"], p["face_layer_norm"], face, act,
                              cfg, rngs, tp)
        if add_ner_ffn:
            h = mha(p["self_attn_img_name"], ner, key_value=torch.cat([face, ner], dim=1),
                    mask=masks["face_name"], num_heads=cfg.encoder_attention_heads, tp=tp)
            ner = layernorm(p["img_name_attn_layer_norm"], ner + h)
            kv = torch.cat([img, _ner_prefix(p, ner, act, cfg, fcfg, rngs, tp)], dim=1)
            cross_mask = masks["img_ner"]
        else:
            kv = torch.cat([img, ner, x], dim=1)
            cross_mask = masks["img_ner_text"]
    else:
        kv = img
        cross_mask = masks["img_ner"]

    h = B.encoder_self_attention(p, x, attn_mask, cfg, tp)
    x = layernorm(p["self_attn_layer_norm"], x + dropout(h, cfg.dropout, rngs.next()))
    h = mha(p["cross_attn_img_ner"], x, key_value=kv, mask=cross_mask,
            num_heads=cfg.encoder_attention_heads, tp=tp)
    x = layernorm(p["img_ner_attn_layer_norm"], x + dropout(h, cfg.dropout, rngs.next()))
    x = B.residual_ffn(p["fc1"], p["fc2"], p["final_layer_norm"], x, act, cfg, rngs, tp)
    return x, {"img": img, "face": face, "ner": ner}


def _prompt_len(fcfg: FusionConfig) -> int:
    return fcfg.prompt_size if fcfg.prompt_mlp_type == "clipcap" else fcfg.map_size[-1]


def _fusion_layer(p, x, attn_mask, streams, masks, cfg, fcfg, fused, add_ner_ffn, seed, tp):
    return fusion_encoder_layer_fwd(p, x, attn_mask, streams, masks, cfg, fcfg, fused,
                                    add_ner_ffn, RngStream(seed), tp)


def mm_encoder_fwd(params: Params, input_ids, attention_mask, image_features,
                   cfg: BartConfig, fcfg: FusionConfig, *, face_features=None,
                   face_mask=None, name_ids=None, name_mask=None,
                   add_ner_ffn: bool = True, dtype=torch.float32,
                   dropout_rng: int | None = None, remat: bool = False,
                   tp: ModelShard | None = None) -> dict[str, Any]:
    """Modified BartEncoder.forward -> {"last_hidden", "img", "ner", "face"}.
    `dropout_rng` seeds dropout (None: none); `remat` recomputes each layer
    in the backward (models/bart.run_layer); `tp` runs a model rank's shard."""
    enc = params["encoder"]
    bsz, src_len = input_ids.shape
    dev = input_ids.device
    rngs = RngStream(dropout_rng)
    x = B.embed_and_norm(params["shared"], enc["embed_positions"], enc["layernorm_embedding"],
                         input_ids, cfg, dtype, rngs=rngs)
    masks: dict[str, Any] = {}
    streams: dict[str, Any] = {}
    plen = _prompt_len(fcfg)
    if not fcfg.only_image:
        streams["ner"] = embed_ner_stream(enc, name_ids, cfg, dtype, rngs)
        streams["face"] = linear(enc["face_proj"], face_features.to(dtype))
        if add_ner_ffn:
            fn_mask = torch.cat([face_mask, name_mask], dim=1)
            masks["face_name"] = expand_mask(fn_mask, fcfg.max_ner_type_len, dtype)
        ones = torch.ones(bsz, plen + fcfg.max_ner_type_len_gt, dtype=dtype, device=dev)
        masks["img_ner"] = expand_mask(ones, src_len, dtype)
        ones_in = torch.ones(bsz, plen + name_ids.shape[-1], dtype=dtype, device=dev)
        masks["img_ner_text"] = expand_mask(
            torch.cat([ones_in, attention_mask.to(dtype)], dim=1), src_len, dtype)
    else:
        masks["img_ner"] = expand_mask(torch.ones(bsz, plen, dtype=dtype, device=dev),
                                       src_len, dtype)
    streams["img"] = map_image_prompt(enc, image_features, cfg, fcfg, tp).to(dtype)
    attn_mask = B.encoder_self_mask(attention_mask, cfg, dtype)
    fused_set = set(fcfg.fusion_layers)
    for i, p in enumerate(enc["layers"]):
        x, streams = B.run_layer(_fusion_layer, remat, p, x, attn_mask, streams, masks, cfg,
                                 fcfg, i in fused_set, add_ner_ffn,
                                 B.layer_seed(dropout_rng, i), tp)
    return {"last_hidden": x, "img": streams.get("img"), "ner": streams.get("ner"),
            "face": streams.get("face")}


# ---------------------------------------------------------------------------
# Fused encoder: stream prologue here, text stack in kernels/encoder_stack
# ---------------------------------------------------------------------------

def fused_encoder_eligible(fcfg: FusionConfig, cfg: BartConfig, add_ner_ffn: bool) -> bool:
    """Every layer fused and a precomputable cross KV: add_ner_ffn=True
    (kv = img + ner_prefix) or only_image (kv = img). add_ner_ffn=False puts
    x itself in the KV and stays on the layer-by-layer path."""
    return (set(fcfg.fusion_layers) == set(range(cfg.encoder_layers))
            and (fcfg.only_image or add_ner_ffn))


def _stack(layers, *path) -> torch.Tensor:
    def leaf(p):
        for k in path:
            p = p[k]
        return p

    return torch.stack([leaf(p) for p in layers])


def linear_batched(t: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[L, B, N, din] @ [L, din, dout] + [L, dout] with linear()'s recipe:
    the kernel rounded to t's dtype first, float32 accumulate, cast back."""
    lyr, b, n, _ = t.shape
    y = product(t.reshape(lyr, b * n, -1), kern.to(t.dtype), cotangent="bf16")
    return (y.reshape(lyr, b, n, -1) + bias.float()[:, None, None, :]).to(t.dtype)


def _fused_encoder_prologue(params: Params, input_ids, attention_mask, image_features,
                            cfg: BartConfig, fcfg: FusionConfig, *, face_features=None,
                            face_mask=None, name_ids=None, name_mask=None,
                            add_ner_ffn: bool = True, dtype=torch.float32):
    """Token embedding, the sequential stream evolution, the batched ner_map
    and cross-K/V projections, the stacked text-path weights and the pad
    biases. Returns (x, sp, cross_k [L,B,d,KV], cross_v [L,B,KV,d],
    self_bias [B,S], cross_bias [B,KV], streams)."""
    from vacnic_tpu_torch.kernels.encoder_stack import EncStackParams

    assert fused_encoder_eligible(fcfg, cfg, add_ner_ffn)
    act = ACT2FN[cfg.activation_function]
    enc = params["encoder"]
    layers = enc["layers"]
    x = B.embed_and_norm(params["shared"], enc["embed_positions"], enc["layernorm_embedding"],
                         input_ids, cfg, dtype)

    img = map_image_prompt(enc, image_features, cfg, fcfg).to(dtype)
    face = ner = fn_mask_bias = None
    if not fcfg.only_image:
        ner = embed_ner_stream(enc, name_ids, cfg, dtype)
        face = linear(enc["face_proj"], face_features.to(dtype))
        fn_mask_bias = expand_mask(torch.cat([face_mask, name_mask], dim=1),
                                   fcfg.max_ner_type_len, dtype)

    def ln_batched(name, t):
        """layernorm with per-layer params over stacked [L, B, N, d]."""
        g = _stack(layers, name, "scale").float()[:, None, None, :]
        b = _stack(layers, name, "bias").float()[:, None, None, :]
        tf = t.float()
        mu = tf.mean(-1, keepdim=True)
        var = (tf - mu).square().mean(-1, keepdim=True)
        return ((tf - mu) * torch.rsqrt(var + 1e-5) * g + b).to(t.dtype)

    img_states, ner_states = [], []
    for p in layers:
        img = B.residual_ffn(p["img_up"], p["img_down"], p["img_layer_norm"], img, act, cfg)
        if not fcfg.only_image:
            face = B.residual_ffn(p["face_up"], p["face_down"], p["face_layer_norm"], face, act,
                                  cfg)
            h = mha(p["self_attn_img_name"], ner, key_value=torch.cat([face, ner], dim=1),
                    mask=fn_mask_bias, num_heads=cfg.encoder_attention_heads)
            ner = layernorm(p["img_name_attn_layer_norm"], ner + h)
            ner_states.append(ner)
        img_states.append(img)

    img_stack = torch.stack(img_states)  # [L, B, P, d]
    if fcfg.only_image:
        kv = img_stack
    else:
        ner_stack = torch.stack(ner_states)  # [L, B, N, d]
        n_l, bsz, ner_len, d = ner_stack.shape
        # the reference's raw .reshape quirk ([L,B,N,d] -> [L,B,d,N]) preserved
        t = ner_stack.reshape(n_l, bsz, d, ner_len)
        t = act(linear_batched(t, _stack(layers, "ner_map_up", "kernel"),
                               _stack(layers, "ner_map_up", "bias")))
        t = linear_batched(t, _stack(layers, "ner_map_down", "kernel"),
                           _stack(layers, "ner_map_down", "bias"))
        ner_prefix = ln_batched("ner_map_layer_norm",
                                t.reshape(n_l, bsz, fcfg.max_ner_type_len_gt, d))
        kv = torch.cat([img_stack, ner_prefix], dim=2)  # [L, B, KV, d]

    cross_k = linear_batched(kv, _stack(layers, "cross_attn_img_ner", "k_proj", "kernel"),
                             _stack(layers, "cross_attn_img_ner", "k_proj", "bias")
                             ).transpose(2, 3).contiguous()  # [L, B, d, KV]
    cross_v = linear_batched(kv, _stack(layers, "cross_attn_img_ner", "v_proj", "kernel"),
                             _stack(layers, "cross_attn_img_ner", "v_proj", "bias"))

    # stacked text-path weights: bf16 for the card's kernels, f32 on the CPU
    wd = torch.bfloat16 if x.is_cuda else torch.float32

    def w(*path):
        return _stack(layers, *path).to(wd).contiguous()

    def b(*path):
        return _stack(layers, *path).float().contiguous()

    def ln2(name):
        return torch.stack([torch.stack([p[name]["scale"], p[name]["bias"]])
                            for p in layers]).float().contiguous()

    led = {}
    if cfg.attention_window:  # LED's global projections
        led = dict(w_qg=w("self_attn_global", "q_proj", "kernel"),
                   b_qg=b("self_attn_global", "q_proj", "bias"),
                   w_kvg=torch.cat([w("self_attn_global", "k_proj", "kernel"),
                                    w("self_attn_global", "v_proj", "kernel")], dim=-1).contiguous(),
                   b_kvg=torch.cat([b("self_attn_global", "k_proj", "bias"),
                                    b("self_attn_global", "v_proj", "bias")], dim=-1).contiguous())

    sp = EncStackParams(
        w_qkv=torch.cat([w("self_attn", "q_proj", "kernel"), w("self_attn", "k_proj", "kernel"),
                         w("self_attn", "v_proj", "kernel")], dim=-1).contiguous(),
        b_qkv=torch.cat([b("self_attn", "q_proj", "bias"), b("self_attn", "k_proj", "bias"),
                         b("self_attn", "v_proj", "bias")], dim=-1).contiguous(),
        w_so=w("self_attn", "out_proj", "kernel"),
        b_so=b("self_attn", "out_proj", "bias"),
        ln_s=ln2("self_attn_layer_norm"),
        w_cq=w("cross_attn_img_ner", "q_proj", "kernel"),
        b_cq=b("cross_attn_img_ner", "q_proj", "bias"),
        w_co=w("cross_attn_img_ner", "out_proj", "kernel"),
        b_co=b("cross_attn_img_ner", "out_proj", "bias"),
        ln_c=ln2("img_ner_attn_layer_norm"),
        w_fc1=w("fc1", "kernel"),
        b_fc1=b("fc1", "bias"),
        w_fc2=w("fc2", "kernel"),
        b_fc2=b("fc2", "bias"),
        ln_f=ln2("final_layer_norm"),
        **led,
    )
    self_bias = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min  # [B, S]
    cross_bias = torch.zeros(input_ids.shape[0], cross_v.shape[2], device=x.device)
    return x, sp, cross_k, cross_v, self_bias, cross_bias, {"img": img, "ner": ner, "face": face}


def mm_encoder_fwd_fused(params: Params, input_ids, attention_mask, image_features,
                         cfg: BartConfig, fcfg: FusionConfig, *, face_features=None,
                         face_mask=None, name_ids=None, name_mask=None,
                         add_ner_ffn: bool = True, dtype=torch.float32) -> dict[str, Any]:
    """mm_encoder_fwd with the text path of all layers run by
    encoder_text_stack. The streams evolve independently of the text states,
    so the prologue precomputes each layer's cross K/V."""
    from vacnic_tpu_torch.kernels.encoder_stack import encoder_text_stack

    x, sp, cross_k, cross_v, self_bias, cross_bias, streams = _fused_encoder_prologue(
        params, input_ids, attention_mask, image_features, cfg, fcfg,
        face_features=face_features, face_mask=face_mask, name_ids=name_ids,
        name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype)
    last = encoder_text_stack(sp, x, cross_k, cross_v, self_bias, cross_bias, cfg)
    return {"last_hidden": last, **streams}


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def mm_forward(params: Params, input_ids, attention_mask, decoder_input_ids, image_features,
               cfg: BartConfig, fcfg: FusionConfig, *, face_features=None, face_mask=None,
               name_ids=None, name_mask=None, add_ner_ffn: bool = True, dtype=torch.float32,
               dropout_rng: int | None = None, remat: bool = False,
               allow_fused_encoder: bool = True, device=None,
               tp: ModelShard | None = None) -> dict[str, Any]:
    """BartForMultiModalGeneration.forward, teacher-forced: multimodal
    encoder, BART decoder, tied LM head + final_logits_bias ->
    {"logits", "decoder_hidden", "encoder_hidden", "hidden_states_img",
    "hidden_states_ner", "hidden_states_face"}. Params and inputs move to
    `device` ("cuda" by default); leaves already there are used as they are,
    so gradients reach them.

    JAX's gate (vacnic_tpu/models/fusion.py:648-708): the fused encoder runs
    only when allow_fused_encoder is true, there is no dropout and no remat,
    and the config is eligible. Its kernels have no backward: a
    differentiated forward passes allow_fused_encoder=False, as JAX
    training does, or runs with dropout or remat. `tp` (a model rank's
    shard of the tree, core/tensor_parallel) runs the layer-by-layer
    encoder."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    (input_ids, attention_mask, decoder_input_ids, image_features, face_features, face_mask,
     name_ids, name_mask) = (as_tensor(x, dev) for x in (
        input_ids, attention_mask, decoder_input_ids, image_features, face_features, face_mask,
        name_ids, name_mask))
    rng_e, rng_d = split(dropout_rng) if dropout_rng is not None else (None, None)
    fused = (allow_fused_encoder and dropout_rng is None and not remat and tp is None
             and fused_encoder_eligible(fcfg, cfg, add_ner_ffn))
    enc_fwd = mm_encoder_fwd_fused if fused else mm_encoder_fwd
    enc_kw = {} if fused else dict(dropout_rng=rng_e, remat=remat, tp=tp)
    enc_out = enc_fwd(params, input_ids, attention_mask, image_features, cfg, fcfg,
                      face_features=face_features, face_mask=face_mask, name_ids=name_ids,
                      name_mask=name_mask, add_ner_ffn=add_ner_ffn, dtype=dtype, **enc_kw)
    dec_out = B.decoder_fwd(params, decoder_input_ids, enc_out["last_hidden"], attention_mask,
                            cfg, dtype, dropout_rng=rng_d, remat=remat, tp=tp)
    return {"logits": B.lm_logits(params, dec_out), "decoder_hidden": dec_out,
            "encoder_hidden": enc_out["last_hidden"], "hidden_states_img": enc_out["img"],
            "hidden_states_ner": enc_out["ner"], "hidden_states_face": enc_out["face"]}


# ---------------------------------------------------------------------------
# Init: the tree and shapes of vacnic_tpu/models/fusion.multimodal_bart_init
# ---------------------------------------------------------------------------

def fusion_encoder_layer_init(g: torch.Generator, cfg: BartConfig, fcfg: FusionConfig,
                              fused: bool, device=None) -> Params:
    p = B.encoder_layer_init(g, cfg, device)
    if not fused:
        return p
    d = cfg.d_model
    p.update({
        "img_up": linear_init(g, d, cfg.encoder_ffn_dim, device),
        "img_down": linear_init(g, cfg.encoder_ffn_dim, d, device),
        "img_layer_norm": layernorm_init(d, device),
    })
    if not fcfg.only_image:
        p.update({
            "face_up": linear_init(g, d, 3072, device),
            "face_down": linear_init(g, 3072, d, device),
            "face_layer_norm": layernorm_init(d, device),
            "self_attn_img_name": mha_init(g, d, device),
            "img_name_attn_layer_norm": layernorm_init(d, device),
            "ner_map_up": linear_init(g, fcfg.max_ner_type_len, 4 * fcfg.max_ner_type_len_gt,
                                      device),
            "ner_map_down": linear_init(g, 4 * fcfg.max_ner_type_len_gt,
                                        fcfg.max_ner_type_len_gt, device),
            "ner_map_layer_norm": layernorm_init(d, device),
        })
    p.update({
        "cross_attn_img_ner": mha_init(g, d, device),
        "img_ner_attn_layer_norm": layernorm_init(d, device),
    })
    return p


def multimodal_bart_init(g: torch.Generator, cfg: BartConfig, fcfg: FusionConfig,
                         device=None) -> Params:
    """Random multimodal BART parameters from generator `g` (normal std 0.02
    kernels and embeddings, zero biases, unit LN scales), on `device`."""
    params = B.bart_init(g, cfg, device)
    enc = params["encoder"]
    fused_set = set(fcfg.fusion_layers)
    enc["layers"] = tuple(fusion_encoder_layer_init(g, cfg, fcfg, i in fused_set, device)
                          for i in range(cfg.encoder_layers))
    if fcfg.prompt_mlp_type == "clipcap":
        enc["prompt_mlp"] = prompt_mlp_clipcap_init(g, fcfg.img_size, fcfg.prompt_size, device)
    else:
        enc["prompt_mlp"] = prompt_mlp_patch_init(g, fcfg.map_size, device)
    if cfg.d_model == 1024:
        enc["visual_map"] = linear_init(g, 768, 1024, device)
    if not fcfg.only_image:
        ner_w = embedding_init(g, fcfg.ner_vocab_size, cfg.d_model, device)["weight"]
        shared_w = params["shared"]["weight"]
        n_seed = min(shared_w.shape[0], fcfg.ner_vocab_size, 50265)
        ner_w[:n_seed] = shared_w[:n_seed]
        enc["embed_tokens_ner"] = {"weight": ner_w}
        enc["embed_positions_ner"] = copy.deepcopy(enc["embed_positions"])
        enc["layernorm_embedding_ner"] = layernorm_init(cfg.d_model, device)
        enc["face_proj"] = linear_init(g, fcfg.face_feature_dim, fcfg.dim_common, device)
    if fcfg.init_attn_weight:
        params = tie_fusion_attn_weights(params, fcfg)
    return params


def tie_fusion_attn_weights(params: Params, fcfg: FusionConfig) -> Params:
    """Tie each fused layer's fusion attentions to copies of its CURRENT
    self_attn (init_attn_weight_encoder, reference :1858-1869). Applied at
    init, and again after pretrained BART weights are merged in (cli train
    --init-bart): the tie must copy the pretrained self_attn, not the random
    init it would otherwise have captured. The encoder's layer tuple and the
    tied layers' dicts are replaced; the other layers are shared."""
    enc = params["encoder"]
    layers = list(enc["layers"])
    for i in set(fcfg.fusion_layers):
        if i >= len(layers):
            continue
        lp = dict(layers[i])
        lp["cross_attn_img_ner"] = copy.deepcopy(lp["self_attn"])
        if not fcfg.only_image and "self_attn_img_name" in lp:
            lp["self_attn_img_name"] = copy.deepcopy(lp["self_attn"])
        layers[i] = lp
    enc["layers"] = tuple(layers)
    return params
