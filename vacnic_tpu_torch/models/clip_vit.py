"""CLIP ViT vision tower (port of vacnic_tpu/models/clip_vit.py).

What the reference's `extract_clip_img_feat` computes by unrolling OpenAI
CLIP's visual backbone: patchify -> prepend the class embedding -> add the
positional embedding -> ln_pre -> pre-LN transformer blocks (quick-gelu MLP)
-> ln_post applied separately to the CLS token and to the patch tokens.
Returns (patch_tokens, cls); with `prompt_mlp_type="clipcap"` only the CLS
feeds the captioning model.

Pixels come in as [B, H, W, 3] (the serving contract's layout) and the
patch embedding reads the tree's HWIO `conv1` kernel (models/weights_io
converts torch's OIHW): the image is cut into patches and multiplied once,
which is the stride-P convolution without padding. Like the JAX tower,
which computes it outside any Pallas kernel, this runs as library products.
ViT-B/16 at 224 has 197 tokens and no mask, so `attention_core` takes
`attention_plain` (`flash_eligible` refuses it), as JAX does.

The tower runs where its parameters are; `pixels` (a tensor or an array) is
moved there. Under tensor parallelism (`tp`, core/tensor_parallel) the
attention runs a model rank's heads; the MLP (c_fc, c_proj) stays whole,
as JAX's sharding rule leaves it.
"""

from __future__ import annotations

import torch

from vacnic_tpu_torch.core.config import ClipVisionConfig
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


def clip_vision_init(g: torch.Generator, cfg: ClipVisionConfig, device=None) -> Params:
    """Random tower from generator `g` (on `device`), with the JAX
    package's shapes and scales: the embeddings and the projection
    N(0, width^-1), the linears N(0, 0.02^2)."""
    scale = cfg.width ** -0.5
    p: Params = {
        "conv1": {"kernel": normal_((cfg.patch_size, cfg.patch_size, 3, cfg.width), g, scale,
                                    device)},
        "class_embedding": normal_((cfg.width,), g, scale, device),
        "positional_embedding": normal_((cfg.num_patches + 1, cfg.width), g, scale, device),
        "ln_pre": layernorm_init(cfg.width, device),
        "ln_post": layernorm_init(cfg.width, device),
        "proj": normal_((cfg.width, cfg.output_dim), g, scale, device),
    }
    p["layers"] = tuple({
        "attn": mha_init(g, cfg.width, device),
        "ln_1": layernorm_init(cfg.width, device),
        "ln_2": layernorm_init(cfg.width, device),
        "mlp": {"c_fc": linear_init(g, cfg.width, cfg.width * 4, device),
                "c_proj": linear_init(g, cfg.width * 4, cfg.width, device)},
    } for _ in range(cfg.layers))
    return p


def _resblock(p: Params, x: torch.Tensor, heads: int,
              tp: ModelShard | None = None) -> torch.Tensor:
    x = x + mha(p["attn"], layernorm(p["ln_1"], x), num_heads=heads, tp=tp)
    y = layernorm(p["ln_2"], x)
    y = linear(p["mlp"]["c_proj"], ACT2FN["quick_gelu"](linear(p["mlp"]["c_fc"], y)))
    return x + y


def patch_embed(kernel: torch.Tensor, x: torch.Tensor, patch: int) -> torch.Tensor:
    """The stride-`patch` convolution without padding of x [B, H, W, C] by
    an HWIO kernel [P, P, C, width] -> [B, G*G, width] in x.dtype: each
    patch flattened in (row, column, channel) order times the kernel
    reshaped alike, a float32 accumulator rounded once (the `linear`
    recipe). Rows and columns past the last whole patch are dropped."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x[:, :gh * patch, :gw * patch]
    patches = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, gh * gw, patch * patch * c)
    k = kernel.to(x.dtype).reshape(patch * patch * c, kernel.shape[-1])
    return product(patches, k, cotangent="bf16").to(x.dtype)


def clip_vision_fwd(params: Params, pixels, cfg: ClipVisionConfig,
                    dtype=torch.float32,
                    tp: ModelShard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """pixels [B, H, W, 3] (CLIP-normalised) -> (patch_tokens [B, G^2, width],
    cls [B, width]), both float32, computed in `dtype`."""
    w = params["conv1"]["kernel"]
    x = torch.as_tensor(pixels).to(w.device, dtype)
    x = patch_embed(w, x, cfg.patch_size)  # [B, G^2, width]
    b = x.shape[0]
    cls_tok = params["class_embedding"].to(dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls_tok, x], dim=1)
    x = x + params["positional_embedding"].to(dtype)[None]
    x = layernorm(params["ln_pre"], x)
    for p in params["layers"]:
        x = _resblock(p, x, cfg.heads, tp)
    cls = layernorm(params["ln_post"], x[:, 0, :])
    patches = layernorm(params["ln_post"], x[:, 1:, :])
    return patches.float(), cls.float()


def clip_image_embed(params: Params, pixels, cfg: ClipVisionConfig,
                     dtype=torch.float32, tp: ModelShard | None = None) -> torch.Tensor:
    """CLS -> the joint-embedding projection (OpenAI `visual.proj`) [B, output_dim] f32."""
    _, cls = clip_vision_fwd(params, pixels, cfg, dtype, tp)
    return product(cls, params["proj"], cotangent="f32")
