"""Checkpoints into the port (port of vacnic_tpu/models/weights_io.py).

Two ways in:
- `load_state_dict` reads a reference or HF checkpoint (torch `.bin` / `.pt`,
  a pickled whole module, or `.safetensors` through the reader below, which
  needs no package beyond PyTorch), and `convert_bart`,
  `convert_multimodal_bart`, `convert_clip_vision_openai` and
  `convert_clip_vision_hf` map its flat state dict onto the parameter trees
  of models/bart.py, models/fusion.py and models/clip_vit.py;
- `params_from_jax` takes a JAX pytree whose leaves were converted to numpy.

Both give the JAX package's tree: the same dicts and tuples, f32 leaves, and
its linear layout. A `kernel` is [in, out] (torch's (out, in) weights are
transposed on the way in), so `models/layers.linear` computes
`x @ kernel`; the CUDA GEMM (kernels/csrc/gemm_bf16.cu) reads its weight
operand in the same [K, N] row-major layout. The CLIP patch embedding's
`conv1` kernel is HWIO.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping

import numpy as np
import torch

from vacnic_tpu_torch.core.config import BartConfig, ClipVisionConfig, FusionConfig
from vacnic_tpu_torch.core.tree import tree_map

Params = dict[str, Any]


def params_from_jax(tree: Any, device: str | torch.device = "cpu",
                    dtype: torch.dtype | None = None) -> Any:
    """JAX parameter pytree whose leaves the caller converted to numpy ->
    the same tree of torch tensors on `device`. Dicts stay dicts and tuples
    stay tuples; floating leaves are cast to `dtype` when one is given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" and arr.dtype != np.float32:
        arr = arr.astype(np.float32)  # numpy has no bfloat16: widen first
    t = torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tree_to(tree: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """Move (and for floating leaves, cast) every tensor of a parameter tree.
    A tensor already on `device` in `dtype` comes back as the same object, so
    gradients taken through the moved tree reach the caller's leaves; leaves
    that are not tensors (None, a tower's int "heads") are kept as they are."""

    def move(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.to(device) if device is not None else t
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return tree_map(move, tree)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}. The format: an 8-byte
    little-endian header length, a JSON header mapping each name to its
    `dtype`, `shape` and `data_offsets` (begin, end) into the data that
    follows (plus an optional `__metadata__`), then the raw little-endian
    bytes. Raises ValueError, naming the key, on a dtype outside
    SAFETENSORS_DTYPES or on offsets that do not fit the file."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than the header length field")
    n_header = int.from_bytes(data[:8], "little")
    if 8 + n_header > len(data):
        raise ValueError(f"{path}: header of {n_header} bytes overruns the file "
                         f"({len(data)} bytes)")
    header = json.loads(bytes(data[8:8 + n_header]))
    base, size = 8 + n_header, len(data) - 8 - n_header
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']!r}, not one of "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = math.prod(shape)
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size or end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name!r} at data offsets [{begin}, {end}) does not "
                             f"fit its {nbytes} bytes in the file's {size} bytes of data")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape).clone()
    return out


def load_state_dict(path: str) -> dict[str, Any]:
    """Load a checkpoint file into a flat state dict: HF safetensors
    (model.safetensors), torch .bin/.pt (pytorch_model.bin, the reference's
    pickled `torch.save(model)` checkpoints -- then the module's state_dict
    is taken), or a directory holding either."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no checkpoint file in {path}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):  # whole pickled module (reference format)
        obj = obj.state_dict()
    return obj


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    """torch tensor / ndarray -> a new f32 CPU tensor (detached; it shares no
    memory with the state dict)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _kernel(x) -> torch.Tensor:
    """torch (out, in) weight -> [in, out], contiguous."""
    return _t(x).T.contiguous()


def _linear(sd: Mapping[str, Any], prefix: str) -> Params:
    p = {"kernel": _kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _embedding(sd: Mapping[str, Any], key: str) -> Params:
    return {"weight": _t(sd[key])}


def _mha(sd: Mapping[str, Any], prefix: str) -> Params:
    return {name: _linear(sd, f"{prefix}.{name}")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _strip_model_prefix(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    """The model's keys without ForConditionalGeneration's prefix: `model.`
    (BART) or `led.` (LED)."""
    for pre in ("model.", "led."):
        if any(k.startswith(pre) for k in sd):
            return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)} | {
                k: v for k, v in sd.items() if not k.startswith(pre)}
    return sd


def _led_self_attn(sd, prefix: str) -> tuple[Params, Params]:
    """LED's encoder self-attention (`{prefix}.longformer_self_attn.{query,
    key, value, query_global, key_global, value_global}` and
    `{prefix}.output`) -> (self_attn, self_attn_global) of the port's tree."""
    lf = f"{prefix}.longformer_self_attn"
    local = {"q_proj": _linear(sd, f"{lf}.query"), "k_proj": _linear(sd, f"{lf}.key"),
             "v_proj": _linear(sd, f"{lf}.value"), "out_proj": _linear(sd, f"{prefix}.output")}
    glob = {"q_proj": _linear(sd, f"{lf}.query_global"),
            "k_proj": _linear(sd, f"{lf}.key_global"),
            "v_proj": _linear(sd, f"{lf}.value_global")}
    return local, glob


def _bart_encoder_layer(sd, prefix: str) -> Params:
    if f"{prefix}.self_attn.longformer_self_attn.query.weight" in sd:  # LED
        local, glob = _led_self_attn(sd, f"{prefix}.self_attn")
        return {
            "self_attn": local,
            "self_attn_global": glob,
            "self_attn_layer_norm": _layernorm(sd, f"{prefix}.self_attn_layer_norm"),
            "fc1": _linear(sd, f"{prefix}.fc1"),
            "fc2": _linear(sd, f"{prefix}.fc2"),
            "final_layer_norm": _layernorm(sd, f"{prefix}.final_layer_norm"),
        }
    return {
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "self_attn_layer_norm": _layernorm(sd, f"{prefix}.self_attn_layer_norm"),
        "fc1": _linear(sd, f"{prefix}.fc1"),
        "fc2": _linear(sd, f"{prefix}.fc2"),
        "final_layer_norm": _layernorm(sd, f"{prefix}.final_layer_norm"),
    }


def _bart_decoder_layer(sd, prefix: str) -> Params:
    return {
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "self_attn_layer_norm": _layernorm(sd, f"{prefix}.self_attn_layer_norm"),
        "encoder_attn": _mha(sd, f"{prefix}.encoder_attn"),
        "encoder_attn_layer_norm": _layernorm(sd, f"{prefix}.encoder_attn_layer_norm"),
        "fc1": _linear(sd, f"{prefix}.fc1"),
        "fc2": _linear(sd, f"{prefix}.fc2"),
        "final_layer_norm": _layernorm(sd, f"{prefix}.final_layer_norm"),
    }


def convert_bart(sd: Mapping[str, Any], cfg: BartConfig, device="cpu") -> Params:
    """HF `BartForConditionalGeneration.state_dict()` -> models/bart.py tree
    of f32 tensors on `device`. Accepts both `model.`-prefixed
    (ForConditionalGeneration) and bare (BartModel) key layouts; a missing
    `final_logits_bias` becomes zeros. Also LED's
    (`LEDForConditionalGeneration`, `led.`-prefixed): its encoder layers'
    longformer_self_attn query/key/value and output become `self_attn`'s
    q/k/v/out_proj, query/key/value_global `self_attn_global`'s; its
    position tables carry no offset rows (cfg.position_offset 0)."""
    sd = _strip_model_prefix(sd)
    params: Params = {
        "shared": _embedding(sd, "shared.weight"),
        "encoder": {
            "embed_positions": _embedding(sd, "encoder.embed_positions.weight"),
            "layernorm_embedding": _layernorm(sd, "encoder.layernorm_embedding"),
            "layers": tuple(_bart_encoder_layer(sd, f"encoder.layers.{i}")
                            for i in range(cfg.encoder_layers)),
        },
        "decoder": {
            "embed_positions": _embedding(sd, "decoder.embed_positions.weight"),
            "layernorm_embedding": _layernorm(sd, "decoder.layernorm_embedding"),
            "layers": tuple(_bart_decoder_layer(sd, f"decoder.layers.{i}")
                            for i in range(cfg.decoder_layers)),
        },
    }
    if "final_logits_bias" in sd:
        params["final_logits_bias"] = _t(sd["final_logits_bias"]).reshape(-1)
    else:
        params["final_logits_bias"] = torch.zeros(params["shared"]["weight"].shape[0])
    return tree_to(params, device)


def resize_vocab(params: Params, new_vocab: int) -> Params:
    """Extend (or cut) the shared embedding and the logits bias to
    `new_vocab` rows, as `resize_token_embeddings` +
    `_resize_final_logits_bias` do: new rows drawn N(0, 0.02^2) from
    np.random.RandomState(0) -- the JAX package's draws, bit for bit -- and
    the bias zero-extended. The result stays on the tree's device."""
    old = params["shared"]["weight"]
    bias = params["final_logits_bias"]
    v, d = old.shape
    if new_vocab <= v:
        new_w, new_b = old[:new_vocab], bias[:new_vocab]
    else:
        rng = np.random.RandomState(0)
        extra = rng.normal(0.0, 0.02, size=(new_vocab - v, d)).astype(np.float32)
        new_w = torch.cat([old, torch.from_numpy(extra).to(old.device, old.dtype)])
        new_b = torch.cat([bias, bias.new_zeros(new_vocab - v)])
    out = dict(params)
    out["shared"] = {"weight": new_w}
    out["final_logits_bias"] = new_b
    return out


def convert_multimodal_bart(sd: Mapping[str, Any], cfg: BartConfig, fcfg: FusionConfig,
                            device="cpu") -> Params:
    """Reference `BartForMultiModalGeneration.state_dict()` -> models/fusion.py
    tree of f32 tensors on `device`. Reference member names: per fusion
    layer `_linear_1up/_linear_1down` (img FFN), `_face_up/_face_down`,
    `self_attn_img_name`, `ner_map_up/ner_map_down`, `cross_attn_img_ner` +
    their layer norms; encoder-level `prompt_mlp.model.{0,2}`, `visual_map`,
    `embed_tokens_ner`, `embed_positions_ner`, `layernorm_embedding_ner`,
    `_linear_1` (face proj)."""
    sd = _strip_model_prefix(sd)
    params = convert_bart(sd, cfg)
    enc = params["encoder"]
    fusion_layers = set(fcfg.fusion_layers)
    layers = []
    for i, base in enumerate(enc["layers"]):
        p = dict(base)
        pre = f"encoder.layers.{i}"
        if f"{pre}._linear_1up.weight" in sd and i in fusion_layers:
            p.update({
                "img_up": _linear(sd, f"{pre}._linear_1up"),
                "img_down": _linear(sd, f"{pre}._linear_1down"),
                "img_layer_norm": _layernorm(sd, f"{pre}.img_layer_norm"),
                "cross_attn_img_ner": _mha(sd, f"{pre}.cross_attn_img_ner"),
                "img_ner_attn_layer_norm": _layernorm(sd, f"{pre}.img_ner_attn_layer_norm"),
            })
            if not fcfg.only_image:
                p.update({
                    "face_up": _linear(sd, f"{pre}._face_up"),
                    "face_down": _linear(sd, f"{pre}._face_down"),
                    "face_layer_norm": _layernorm(sd, f"{pre}.face_layer_norm"),
                    "self_attn_img_name": _mha(sd, f"{pre}.self_attn_img_name"),
                    "img_name_attn_layer_norm": _layernorm(sd, f"{pre}.img_name_attn_layer_norm"),
                    "ner_map_up": _linear(sd, f"{pre}.ner_map_up"),
                    "ner_map_down": _linear(sd, f"{pre}.ner_map_down"),
                    "ner_map_layer_norm": _layernorm(sd, f"{pre}.ner_map_layer_norm"),
                })
        layers.append(p)
    enc["layers"] = tuple(layers)

    # Both reference mapper classes serialize as prompt_mlp.model.{0,2,...};
    # the configured type picks the layout (a clipcap checkpoint has exactly
    # two linears, an "mlp" one len(map_size) - 1 of them).
    if "encoder.prompt_mlp.model.0.weight" in sd:
        if fcfg.prompt_mlp_type == "clipcap":
            enc["prompt_mlp"] = {
                "prompt_fc1": _linear(sd, "encoder.prompt_mlp.model.0"),
                "prompt_fc2": _linear(sd, "encoder.prompt_mlp.model.2"),
            }
        else:
            stages = []
            i = 0
            while f"encoder.prompt_mlp.model.{i}.weight" in sd:
                stages.append(_linear(sd, f"encoder.prompt_mlp.model.{i}"))
                i += 2
            enc["prompt_mlp"] = {"stages": tuple(stages)}
    if "encoder.visual_map.weight" in sd:
        enc["visual_map"] = _linear(sd, "encoder.visual_map")
    if not fcfg.only_image and "encoder.embed_tokens_ner.weight" in sd:
        enc["embed_tokens_ner"] = _embedding(sd, "encoder.embed_tokens_ner.weight")
        enc["embed_positions_ner"] = _embedding(sd, "encoder.embed_positions_ner.weight")
        enc["layernorm_embedding_ner"] = _layernorm(sd, "encoder.layernorm_embedding_ner")
        enc["face_proj"] = _linear(sd, "encoder._linear_1")
    return tree_to(params, device)


def _hwio(x) -> torch.Tensor:
    """torch OIHW conv weight -> HWIO, contiguous."""
    return _t(x).permute(2, 3, 1, 0).contiguous()


def convert_clip_vision_openai(sd: Mapping[str, Any], cfg: ClipVisionConfig,
                               device="cpu") -> Params:
    """OpenAI CLIP `visual.*` state dict -> models/clip_vit.py tree of f32
    tensors on `device` (the packed `in_proj_weight` split into q, k, v)."""
    p: Params = {
        "conv1": {"kernel": _hwio(sd["visual.conv1.weight"])},
        "class_embedding": _t(sd["visual.class_embedding"]),
        "positional_embedding": _t(sd["visual.positional_embedding"]),
        "ln_pre": _layernorm(sd, "visual.ln_pre"),
        "ln_post": _layernorm(sd, "visual.ln_post"),
    }
    if "visual.proj" in sd:
        p["proj"] = _t(sd["visual.proj"])
    layers = []
    for i in range(cfg.layers):
        pre = f"visual.transformer.resblocks.{i}"
        in_w = _t(sd[f"{pre}.attn.in_proj_weight"])  # (3d, d)
        in_b = _t(sd[f"{pre}.attn.in_proj_bias"])
        d = in_w.shape[1]
        attn = {name: {"kernel": in_w[j * d:(j + 1) * d].T.contiguous(),
                       "bias": in_b[j * d:(j + 1) * d].clone()}
                for j, name in enumerate(("q_proj", "k_proj", "v_proj"))}
        attn["out_proj"] = _linear(sd, f"{pre}.attn.out_proj")
        layers.append({
            "attn": attn,
            "ln_1": _layernorm(sd, f"{pre}.ln_1"),
            "ln_2": _layernorm(sd, f"{pre}.ln_2"),
            "mlp": {"c_fc": _linear(sd, f"{pre}.mlp.c_fc"),
                    "c_proj": _linear(sd, f"{pre}.mlp.c_proj")},
        })
    p["layers"] = tuple(layers)
    return tree_to(p, device)


def convert_clip_vision_hf(sd: Mapping[str, Any], cfg: ClipVisionConfig,
                           device="cpu") -> Params:
    """HF `CLIPVisionModel.state_dict()` -> models/clip_vit.py tree of f32
    tensors on `device`."""
    pre = "vision_model"
    if not any(k.startswith(pre) for k in sd):
        raise ValueError("not an HF CLIP vision state dict")
    p: Params = {
        "conv1": {"kernel": _hwio(sd[f"{pre}.embeddings.patch_embedding.weight"])},
        "class_embedding": _t(sd[f"{pre}.embeddings.class_embedding"]),
        "positional_embedding": _t(sd[f"{pre}.embeddings.position_embedding.weight"]),
        "ln_pre": _layernorm(sd, f"{pre}.pre_layrnorm"),  # (sic) HF misspells it
        "ln_post": _layernorm(sd, f"{pre}.post_layernorm"),
    }
    layers = []
    for i in range(cfg.layers):
        lp = f"{pre}.encoder.layers.{i}"
        layers.append({
            "attn": {name: _linear(sd, f"{lp}.self_attn.{name}")
                     for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln_1": _layernorm(sd, f"{lp}.layer_norm1"),
            "ln_2": _layernorm(sd, f"{lp}.layer_norm2"),
            "mlp": {"c_fc": _linear(sd, f"{lp}.mlp.fc1"),
                    "c_proj": _linear(sd, f"{lp}.mlp.fc2")},
        })
    p["layers"] = tuple(layers)
    if "visual_projection.weight" in sd:
        p["proj"] = _kernel(sd["visual_projection.weight"])
    return tree_to(p, device)
