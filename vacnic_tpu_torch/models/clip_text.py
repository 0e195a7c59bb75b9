"""CLIP text tower (port of vacnic_tpu/models/clip_text.py), used by the
optional CLIP contrastive loss of training (train/train_step.compute_losses).

OpenAI CLIP's text encoder: token embedding + positions -> causal pre-LN
transformer (quick-gelu MLP) -> ln_final -> the features at each row's
highest id (the EOT token) -> text projection. It runs as library products,
as JAX computes it outside any Pallas kernel; 77 tokens are not
`flash_eligible`. Under tensor parallelism (`tp`, core/tensor_parallel) the
attention runs a model rank's heads and the MLP stays whole, as JAX's
sharding rule leaves it.
"""

from __future__ import annotations

import math

import torch

from vacnic_tpu_torch.core.tensor_parallel import ModelShard
from vacnic_tpu_torch.models.layers import (
    ACT2FN,
    Params,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mha,
    mha_init,
    normal_,
)
from vacnic_tpu_torch.models.products import product
from vacnic_tpu_torch.models.weights_io import _layernorm, _linear, _t, tree_to


def clip_text_init(g: torch.Generator, vocab_size: int = 49408, context_length: int = 77,
                   width: int = 512, layers: int = 12, heads: int = 8,
                   output_dim: int = 512, device=None) -> Params:
    """Random tower from generator `g` with the JAX package's shapes and
    scales (token embedding N(0, 0.02^2), positions N(0, 0.01^2), projection
    N(0, 1/width), logit_scale ln(1/0.07)). The int leaf "heads" is kept as
    JAX keeps it; strip it before the tree is trained, as JAX must."""
    p: Params = {
        "token_embedding": {"weight": normal_((vocab_size, width), g, 0.02, device)},
        "positional_embedding": normal_((context_length, width), g, 0.01, device),
        "ln_final": layernorm_init(width, device),
        "text_projection": normal_((width, output_dim), g, width ** -0.5, device),
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device),
        "heads": heads,
    }
    p["layers"] = tuple({
        "attn": mha_init(g, width, device),
        "ln_1": layernorm_init(width, device),
        "ln_2": layernorm_init(width, device),
        "mlp": {"c_fc": linear_init(g, width, width * 4, device),
                "c_proj": linear_init(g, width * 4, width, device)},
    } for _ in range(layers))
    return p


def convert_clip_text_openai(sd, layers: int = 12, heads: int = 8, device="cpu") -> Params:
    """OpenAI CLIP full-model state dict -> the text-tower tree of f32
    tensors on `device` (the packed `in_proj_weight` split into q, k, v)."""
    p: Params = {
        "token_embedding": {"weight": _t(sd["token_embedding.weight"])},
        "positional_embedding": _t(sd["positional_embedding"]),
        "ln_final": _layernorm(sd, "ln_final"),
        "text_projection": _t(sd["text_projection"]),
        "logit_scale": _t(sd["logit_scale"]),
    }
    lyrs = []
    for i in range(layers):
        pre = f"transformer.resblocks.{i}"
        in_w = _t(sd[f"{pre}.attn.in_proj_weight"])  # (3d, d)
        in_b = _t(sd[f"{pre}.attn.in_proj_bias"])
        d = in_w.shape[1]
        attn = {name: {"kernel": in_w[j * d:(j + 1) * d].T.contiguous(),
                       "bias": in_b[j * d:(j + 1) * d].clone()}
                for j, name in enumerate(("q_proj", "k_proj", "v_proj"))}
        attn["out_proj"] = _linear(sd, f"{pre}.attn.out_proj")
        lyrs.append({
            "attn": attn,
            "ln_1": _layernorm(sd, f"{pre}.ln_1"),
            "ln_2": _layernorm(sd, f"{pre}.ln_2"),
            "mlp": {"c_fc": _linear(sd, f"{pre}.mlp.c_fc"),
                    "c_proj": _linear(sd, f"{pre}.mlp.c_proj")},
        })
    p["layers"] = tuple(lyrs)
    p = tree_to(p, device)
    p["heads"] = heads
    return p


def clip_text_fwd(params: Params, token_ids, dtype=torch.float32,
                  num_heads: int | None = None, tp: ModelShard | None = None) -> torch.Tensor:
    """[B, T] CLIP-BPE ids -> [B, output_dim] f32 text features, computed in
    `dtype`. `num_heads` is read from the tree's "heads" leaf when not given."""
    heads = num_heads if num_heads is not None else int(params["heads"])
    w = params["token_embedding"]["weight"]
    token_ids = torch.as_tensor(token_ids).to(w.device).long()
    x = w[token_ids].to(dtype)
    t = x.shape[1]
    x = x + params["positional_embedding"][:t].to(dtype)[None]
    causal = torch.triu(torch.full((t, t), torch.finfo(torch.float32).min, device=x.device),
                        diagonal=1)[None, None]
    for p in params["layers"]:
        x = x + mha(p["attn"], layernorm(p["ln_1"], x), mask=causal, num_heads=heads, tp=tp)
        y = layernorm(p["ln_2"], x)
        x = x + linear(p["mlp"]["c_proj"], ACT2FN["quick_gelu"](linear(p["mlp"]["c_fc"], y)))
    x = layernorm(params["ln_final"], x)
    eot = token_ids.argmax(dim=-1)  # the EOT token has the highest id (OpenAI's convention)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return product(feats, params["text_projection"].to(dtype), cotangent="bf16").to(dtype).float()
