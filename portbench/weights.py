"""The benchmark's weights, made from the seed on the device in a few large
calls: one normal draw for every kernel and embedding of a std, one buffer
of zeros for the biases and one of ones for the LayerNorm scales, each cut
into the leaves as views. The tree has the layout and leaf order of the
port's `multimodal_bart_init`, `bart_init` and `clip_vision_init`
(vacnic_tpu_torch/models/{fusion,bart,clip_vit}.py, commit 024b7cd), so the
port takes it as its own; the plain reference reads the same tensors.

`sizes` is a configuration file's `sizes` (portbench/configs)."""

from __future__ import annotations

import torch

STD = 0.02


class _Plan:
    """Leaves to fill: (shape, kind) with kind "normal:<std>", "zeros" or
    "ones"; `make` fills them from one generator, a draw a std."""

    def __init__(self):
        self.leaves: list[tuple[tuple[int, ...], str]] = []
        self.std = STD  # of the kernels and embeddings

    def add(self, shape, kind: str) -> int:
        self.leaves.append((tuple(shape), kind))
        return len(self.leaves) - 1

    def make(self, gen: torch.Generator, device, dtype) -> list[torch.Tensor]:
        out: list[torch.Tensor | None] = [None] * len(self.leaves)
        kinds = sorted({k for _, k in self.leaves})
        for kind in kinds:
            idx = [i for i, (_, k) in enumerate(self.leaves) if k == kind]
            sizes = [_numel(self.leaves[i][0]) for i in idx]
            n = sum(sizes)
            if kind == "zeros":
                buf = torch.zeros(n, device=device, dtype=dtype)
            elif kind == "ones":
                buf = torch.ones(n, device=device, dtype=dtype)
            else:
                buf = torch.randn(n, generator=gen, device=device, dtype=dtype)
                buf.mul_(float(kind.split(":")[1]))
            for i, part in zip(idx, buf.split(sizes)):
                out[i] = part.view(self.leaves[i][0])
        return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _linear(plan: _Plan, d_in: int, d_out: int, std: float | None = None):
    std = std or plan.std
    return {"kernel": plan.add((d_in, d_out), f"normal:{std}"), "bias": plan.add((d_out,), "zeros")}


def _ln(plan: _Plan, d: int):
    return {"scale": plan.add((d,), "ones"), "bias": plan.add((d,), "zeros")}


def _mha(plan: _Plan, d: int):
    return {n: _linear(plan, d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _emb(plan: _Plan, n: int, d: int, std: float | None = None):
    std = std or plan.std
    return {"weight": plan.add((n, d), f"normal:{std}")}


def _bart(plan: _Plan, s: dict, fused_encoder: bool):
    d, n_pos = s["d_model"], s["max_position_embeddings"] + 2

    def enc_layer():
        p = {"self_attn": _mha(plan, d), "self_attn_layer_norm": _ln(plan, d),
             "fc1": _linear(plan, d, s["encoder_ffn_dim"]),
             "fc2": _linear(plan, s["encoder_ffn_dim"], d), "final_layer_norm": _ln(plan, d)}
        if not fused_encoder:
            return p
        p.update({"img_up": _linear(plan, d, s["encoder_ffn_dim"]),
                  "img_down": _linear(plan, s["encoder_ffn_dim"], d),
                  "img_layer_norm": _ln(plan, d)})
        if not s["only_image"]:
            p.update({"face_up": _linear(plan, d, s["face_ffn_dim"]),
                      "face_down": _linear(plan, s["face_ffn_dim"], d),
                      "face_layer_norm": _ln(plan, d),
                      "self_attn_img_name": _mha(plan, d),
                      "img_name_attn_layer_norm": _ln(plan, d),
                      "ner_map_up": _linear(plan, s["max_ner_type_len"],
                                            4 * s["max_ner_type_len_gt"]),
                      "ner_map_down": _linear(plan, 4 * s["max_ner_type_len_gt"],
                                              s["max_ner_type_len_gt"]),
                      "ner_map_layer_norm": _ln(plan, d)})
        p.update({"cross_attn_img_ner": _mha(plan, d), "img_ner_attn_layer_norm": _ln(plan, d)})
        return p

    def dec_layer():
        return {"self_attn": _mha(plan, d), "self_attn_layer_norm": _ln(plan, d),
                "encoder_attn": _mha(plan, d), "encoder_attn_layer_norm": _ln(plan, d),
                "fc1": _linear(plan, d, s["decoder_ffn_dim"]),
                "fc2": _linear(plan, s["decoder_ffn_dim"], d), "final_layer_norm": _ln(plan, d)}

    return {
        "shared": _emb(plan, s["vocab_size"], d),
        "encoder": {"embed_positions": _emb(plan, n_pos, d),
                    "layernorm_embedding": _ln(plan, d),
                    "layers": tuple(enc_layer() for _ in range(s["encoder_layers"]))},
        "decoder": {"embed_positions": _emb(plan, n_pos, d),
                    "layernorm_embedding": _ln(plan, d),
                    "layers": tuple(dec_layer() for _ in range(s["decoder_layers"]))},
        "final_logits_bias": plan.add((s["vocab_size"],), "zeros"),
    }


def _multimodal(plan: _Plan, s: dict):
    """The tree of multimodal_bart_init: BART with every encoder layer fused
    (the released configurations fuse all twelve), the clipcap prompt
    mapper, visual_map and, unless only_image, the NER and face streams."""
    d = s["d_model"]
    p = _bart(plan, s, fused_encoder=True)
    enc = p["encoder"]
    mid = s["img_size"] * s["prompt_size"] // 2
    enc["prompt_mlp"] = {"prompt_fc1": _linear(plan, s["img_size"], mid),
                         "prompt_fc2": _linear(plan, mid, s["img_size"] * s["prompt_size"])}
    if d == 1024:  # the port maps CLIP's 768 to BART-large's width only
        enc["visual_map"] = _linear(plan, 768, 1024)
    if not s["only_image"]:
        enc["embed_tokens_ner"] = _emb(plan, s["ner_vocab_size"], d)
        enc["embed_positions_ner"] = _emb(plan, s["max_position_embeddings"] + 2, d)
        enc["layernorm_embedding_ner"] = _ln(plan, d)
        enc["face_proj"] = _linear(plan, s["face_feature_dim"], s["dim_common"])
    return p


def _clip(plan: _Plan, s: dict):
    w, scale = s["clip_width"], s["clip_width"] ** -0.5
    grid = s["image_size"] // s["patch_size"]
    p = {"conv1": {"kernel": plan.add((s["patch_size"], s["patch_size"], 3, w),
                                      f"normal:{scale}")},
         "class_embedding": plan.add((w,), f"normal:{scale}"),
         "positional_embedding": plan.add((grid * grid + 1, w), f"normal:{scale}"),
         "ln_pre": _ln(plan, w), "ln_post": _ln(plan, w),
         "proj": plan.add((w, s["clip_output_dim"]), f"normal:{scale}")}
    p["layers"] = tuple({"attn": _mha(plan, w), "ln_1": _ln(plan, w), "ln_2": _ln(plan, w),
                         "mlp": {"c_fc": _linear(plan, w, 4 * w),
                                 "c_proj": _linear(plan, 4 * w, w)}}
                        for _ in range(s["clip_layers"]))
    return p


def _fill(tree, leaves):
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_fill(v, leaves) for v in tree)
    return leaves[tree]


def _seed_ner_tables(model: dict, s: dict) -> None:
    """multimodal_bart_init's copies: the NER table's first rows are the
    shared embedding's, its positions the encoder's."""
    enc = model["encoder"]
    if "embed_tokens_ner" not in enc:
        return
    n_seed = min(s["vocab_size"], s["ner_vocab_size"], 50265)
    with torch.no_grad():
        enc["embed_tokens_ner"]["weight"][:n_seed].copy_(model["shared"]["weight"][:n_seed])
        enc["embed_positions_ner"]["weight"].copy_(enc["embed_positions"]["weight"])


def make_model(sizes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The multimodal BART tree from `seed`, on `device`, in `dtype`."""
    plan = _Plan()
    tree = _multimodal(plan, sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    model = _fill(tree, plan.make(gen, device, dtype))
    _seed_ner_tables(model, sizes)
    return model


def make_training_trees(sizes: dict, seed: int, device, dtype=torch.float32):
    """(params {"model", "clip"}, teacher): the multimodal model, the CLIP
    vision tower and the text-only BART teacher, from `seed`, on `device`."""
    plan = _Plan()
    trees = (_multimodal(plan, sizes), _clip(plan, sizes), _bart(plan, sizes, False))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = plan.make(gen, device, dtype)
    model, clip, teacher = (_fill(t, leaves) for t in trees)
    _seed_ner_tables(model, sizes)
    return {"model": model, "clip": clip}, teacher
