"""Convert pretrained checkpoints to the port's parameter trees, saved as
.npz (port of scripts/convert_checkpoint.py, same file format).

Sources:
  * HF BART (a directory with model.safetensors / pytorch_model.bin, or the
    file) -> the text BART tree (CoLaM teacher / init), with the vocab
    resized 50265 -> 50267 (<ENT>, <NONAME>; train...match.py:753).
  * An OpenAI CLIP state dict (ViT-B/16 .pt) -> the vision (+ text) towers.
  * A reference VACNIC pickled checkpoint (`torch.save(model)`,
    train...match.py:467) -> the full multimodal tree.

Usage:
  python -m vacnic_tpu_torch.convert_checkpoint bart /path/to/bart-large out_bart.npz
  python -m vacnic_tpu_torch.convert_checkpoint clip /path/to/ViT-B-16.pt out_clip.npz
  python -m vacnic_tpu_torch.convert_checkpoint vacnic /path/to/model.pt out_mm.npz

The .npz holds one array a leaf, named by the leaf's path joined with "/"
(tuple and list items by their index), as the JAX package writes it: a tree
either package writes, the other reads. numpy has no bfloat16, so bf16
leaves are written widened to float32, which is exact. On read, a bfloat16
entry (the JAX package writes ml_dtypes' bfloat16, which numpy reads as a
2-byte void type) comes back as a torch.bfloat16 tensor, bit for bit.
`load_tree` gives CPU tensors; a 0-d integer leaf (the CLIP text tower's
"heads") stays a 0-d tensor, which `int()` reads.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): _to_numpy(tree)}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bfloat16; widening is exact
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _listify(tree)


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return tuple(_listify(node[str(i)]) for i in range(len(keys)))
        return {k: _listify(v) for k, v in node.items()}
    return node


def save_tree(tree, path: str):
    np.savez_compressed(path, **flatten(tree))


def load_tree(path: str):
    with np.load(path) as z:
        return unflatten({k: _to_tensor(z[k]) for k in z.files})


def main(argv=None) -> int:
    import argparse
    import dataclasses

    from vacnic_tpu_torch.core.config import BartConfig, ClipVisionConfig, FusionConfig
    from vacnic_tpu_torch.models import weights_io as W

    ap = argparse.ArgumentParser(
        description="Convert torch checkpoints (HF BART / OpenAI CLIP / "
                    "reference VACNIC pickles) to .npz parameter trees")
    ap.add_argument("kind", choices=["bart", "clip", "vacnic"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--vocab-size", type=int, default=50265,
                    help="source BART vocab (before <ENT>/<NONAME> resize)")
    ap.add_argument("--resize-to", type=int, default=50267,
                    help="extend vocab+logits bias to this size "
                         "(resize_token_embeddings, model :1906-1918)")
    ap.add_argument("--layers", type=int, default=None,
                    help="encoder/decoder layer count (default bart-large 12)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--ffn-dim", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--max-pos", type=int, default=None)
    args = ap.parse_args(argv)
    kind, src, dst = args.kind, args.src, args.dst

    sd = W.load_state_dict(src)
    if kind == "bart":
        cfg = BartConfig(vocab_size=args.vocab_size)
        over = {
            "encoder_layers": args.layers, "decoder_layers": args.layers,
            "d_model": args.d_model,
            "encoder_ffn_dim": args.ffn_dim, "decoder_ffn_dim": args.ffn_dim,
            "encoder_attention_heads": args.heads,
            "decoder_attention_heads": args.heads,
            "max_position_embeddings": args.max_pos,
        }
        cfg = dataclasses.replace(cfg, **{k: v for k, v in over.items() if v is not None})
        params = W.convert_bart(sd, cfg)
        if args.resize_to != args.vocab_size:
            params = W.resize_vocab(params, args.resize_to)
    elif kind == "clip":
        params = {
            "vision": W.convert_clip_vision_openai(sd, ClipVisionConfig()),
        }
        try:
            from vacnic_tpu_torch.models.clip_text import convert_clip_text_openai

            params["text"] = convert_clip_text_openai(sd)
        except KeyError:
            pass
    elif kind == "vacnic":
        params = W.convert_multimodal_bart(sd, BartConfig(), FusionConfig())
    else:
        raise SystemExit(f"unknown kind {kind}")
    save_tree(params, dst)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
