"""The yardstick's arithmetic: the H100's published peaks and the operations
and bytes of the work, from shapes alone.

The peaks, `bound`, and the byte counts of a `gemm_bf16` product and a
`dec_cross_attention` call are frozen copies of `chip_smoke.py` (commit
024b7cd: PEAK_* :293-296, `bound` :396, the gemm cases' bytes :444,
`dec_cross_bytes` :937), so that the benchmark's rooflines do not move with
later edits of that script. Peaks: NVIDIA's data sheet for the SXM part,
dense, at the full 700 W power limit."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # outside the tensor cores
PEAK_8BIT_OPS = 1979e12   # int8 / fp8 tensor-core rate
PEAK_BYTES = 3.35e12      # HBM3


def bound(byts: float, ops: float, peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time in ms for `ops` operations and `byts` bytes, and which
    of the two bounds it."""
    t_bytes, t_ops = byts / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# One layer's gemm_bf16 products: (name, K, N, epilogue residual, output bytes)
# with d the model width and F the FFN width; cross_out is self_out's product.
def layer_products(d: int, ffn: int) -> list[tuple[str, int, int, bool, int]]:
    return [("qkv", d, 3 * d, False, 2), ("self_out", d, d, True, 4),
            ("cross_q", d, d, False, 2), ("cross_out", d, d, True, 4),
            ("fc1", d, ffn, False, 2), ("fc2", ffn, d, True, 4)]


def gemm_bytes(m: int, k: int, n: int, res: bool, out_bytes: int) -> int:
    """bf16 A [m, k] and W [k, n] read once, the f32 bias, the f32 residual
    read where the epilogue adds one, the output written once."""
    return (m * k + k * n) * 2 + n * 4 + (m * n * 4 if res else 0) + m * n * out_bytes


def gemm_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * n * k


def dec_cross_bytes(items: int, beams: int, heads: int, head_dim: int, s_len: int,
                    kv_bytes: int = 1) -> int:
    """A dec_cross_attention call: q in and out (bf16), K and V once an item,
    the f32 pad bias and (int8) the f32 per-channel scales of K and V."""
    q = items * beams * heads * head_dim
    kv = items * heads * head_dim * s_len
    scales = 2 * items * heads * head_dim * 4 if kv_bytes == 1 else 0
    return 2 * q * 2 + 2 * kv * kv_bytes + items * s_len * 4 + scales


def dec_cross_ops(items: int, beams: int, heads: int, head_dim: int, s_len: int) -> float:
    return 4.0 * items * beams * heads * head_dim * s_len


# ---------------------------------------------------------------------------
# a captioning batch (infer/generate.generate_mm at `sizes`)
# ---------------------------------------------------------------------------

def decode_steps(sizes: dict) -> int:
    """Decoder steps of a batch in which every caption runs to max_length
    (min_length = max_length - 1): max_length - 1."""
    return sizes["max_length"] - 1


def caption_gemm_bf16(sizes: dict, batch: int) -> tuple[float, float, int]:
    """(least seconds, operations, launches) of the products that the port's
    gemm_bf16 kernels run in one batch: the fused encoder stack's six
    products a layer at M = batch x S, and the decoder stack's six a layer
    and step at M = batch x beams."""
    d, s_len = sizes["d_model"], sizes["article_max_length"]
    secs = ops = 0.0
    launches = 0
    shapes = [(batch * s_len, sizes["encoder_ffn_dim"], sizes["encoder_layers"]),
              (batch * sizes["num_beams"], sizes["decoder_ffn_dim"],
               sizes["decoder_layers"] * decode_steps(sizes))]
    for m, ffn, times in shapes:
        for _, k, n, res, ob in layer_products(d, ffn):
            ms, _ = bound(gemm_bytes(m, k, n, res, ob), gemm_ops(m, k, n))
            secs += times * ms / 1e3
            ops += times * gemm_ops(m, k, n)
            launches += times
    return secs, ops, launches


def caption_dec_cross(sizes: dict, batch: int) -> tuple[float, int]:
    """(least seconds, launches) of a batch's dec_cross_attention calls
    (int8 cross K/V): one a decoder layer and step."""
    d, heads = sizes["d_model"], sizes["decoder_attention_heads"]
    launches = sizes["decoder_layers"] * decode_steps(sizes)
    ms, _ = bound(dec_cross_bytes(batch, sizes["num_beams"], heads, d // heads,
                                  sizes["article_max_length"]),
                  dec_cross_ops(batch, sizes["num_beams"], heads, d // heads,
                                sizes["article_max_length"]))
    return launches * ms / 1e3, launches


def caption_products(sizes: dict, batch: int) -> list[tuple[str, int, int, int, int]]:
    """Every matrix product of a captioning batch, whatever kernel runs it,
    as (name, M, K, N, count): the prompt mapper and visual_map, the face
    projection; each encoder layer's streams (the image and face FFNs, the
    names' attention projections), ner_map and cross K/V; the text stack's
    six a layer at batch x S rows; the decoder's cross K/V, once a batch;
    each decode step's six a layer and the LM head at batch x beams rows.
    Attention's scores and values are not among them: they run inside the
    attention kernels."""
    d, s_len, v = sizes["d_model"], sizes["article_max_length"], sizes["vocab_size"]
    enc_l, dec_l = sizes["encoder_layers"], sizes["decoder_layers"]
    p, img = sizes["prompt_size"], sizes["img_size"]
    mid = img * p // 2
    out = [("prompt_fc1", batch, img, mid, 1), ("prompt_fc2", batch, mid, img * p, 1)]
    if d == 1024:
        out.append(("visual_map", batch * p, 768, 1024, 1))
    out += [("img_up", batch * p, d, sizes["encoder_ffn_dim"], enc_l),
            ("img_down", batch * p, sizes["encoder_ffn_dim"], d, enc_l)]
    kv = p
    if not sizes["only_image"]:
        faces, n_len, gt = sizes["max_faces"], sizes["max_ner_type_len"], sizes["max_ner_type_len_gt"]
        ffn_f = sizes["face_ffn_dim"]
        out += [("face_proj", batch * faces, sizes["face_feature_dim"], sizes["dim_common"], 1),
                ("face_up", batch * faces, d, ffn_f, enc_l),
                ("face_down", batch * faces, ffn_f, d, enc_l),
                ("names_q", batch * n_len, d, d, enc_l), ("names_o", batch * n_len, d, d, enc_l),
                ("names_kv", batch * (faces + n_len), d, d, 2 * enc_l),
                ("ner_map_up", batch * d, n_len, 4 * gt, enc_l),
                ("ner_map_down", batch * d, 4 * gt, gt, enc_l)]
        kv += gt
    out.append(("enc_cross_kv", batch * kv, d, d, 2 * enc_l))
    for name, k, n, _, _ in layer_products(d, sizes["encoder_ffn_dim"]):
        out.append(("enc_" + name, batch * s_len, k, n, enc_l))
    out.append(("dec_cross_kv", batch * s_len, d, d, 2 * dec_l))
    rows, steps = batch * sizes["num_beams"], decode_steps(sizes)
    for name, k, n, _, _ in layer_products(d, sizes["decoder_ffn_dim"]):
        out.append(("dec_" + name, rows, k, n, dec_l * steps))
    out.append(("lm_head", rows, d, v, steps))
    return out


def products_least_s(products) -> float:
    """The least seconds of (name, M, K, N, count) products on the H100:
    each at its bf16 tensor-core operations or its bytes (bf16 operands
    read once, a bf16 result written once), whichever bounds it."""
    return sum(count * bound(2 * (m * k + k * n + m * n), gemm_ops(m, k, n))[0] / 1e3
               for _, m, k, n, count in products)


def encoder_flops(sizes: dict, batch: int) -> float:
    """The multimodal encoder's model operations (products and attention):
    the prompt mapper, the streams (img FFN, face FFN, the names' attention
    and length map unless only_image), the text layers' self- and
    cross-attention and FFN."""
    d, s_len, heads = sizes["d_model"], sizes["article_max_length"], sizes["encoder_attention_heads"]
    ffn, layers = sizes["encoder_ffn_dim"], sizes["encoder_layers"]
    p, img = sizes["prompt_size"], sizes["img_size"]
    mid = img * p // 2
    f = 2.0 * batch * (img * mid + mid * img * p) + 2.0 * batch * p * img * d  # clipcap, visual_map
    kv = p
    per_layer = 2.0 * batch * p * 2 * d * ffn  # img FFN
    if not sizes["only_image"]:
        n_len, gt, faces = sizes["max_ner_type_len"], sizes["max_ner_type_len_gt"], sizes["max_faces"]
        f += 2.0 * batch * faces * sizes["face_feature_dim"] * d
        per_layer += 2.0 * batch * faces * 2 * d * sizes["face_ffn_dim"]
        per_layer += 2.0 * batch * (n_len * 2 * d * d + (faces + n_len) * 2 * d * d)  # q, o; k, v
        per_layer += 4.0 * batch * n_len * (faces + n_len) * d  # the names' attention
        per_layer += 2.0 * batch * d * (n_len * 4 * gt + 4 * gt * gt)  # ner_map up, down
        kv += gt
    tokens = batch * s_len
    per_layer += 2.0 * tokens * d * (3 * d + d + d + d + 2 * ffn)  # qkv, so, cross q and out, FFN
    per_layer += 4.0 * batch * s_len * s_len * d  # self-attention scores and values
    per_layer += 2.0 * batch * kv * 2 * d * d + 4.0 * batch * s_len * kv * d  # cross K/V, attention
    return f + layers * per_layer


def caption_flops(sizes: dict, batch: int) -> float:
    """A captioning batch's model operations: the encoder, the decoder's
    cross K/V (once a batch), and every decode step's layers and LM head
    over batch x beams rows (self-attention over the steps so far)."""
    d, s_len, v = sizes["d_model"], sizes["article_max_length"], sizes["vocab_size"]
    layers, ffn = sizes["decoder_layers"], sizes["decoder_ffn_dim"]
    rows = batch * sizes["num_beams"]
    steps = decode_steps(sizes)
    f = encoder_flops(sizes, batch)
    f += layers * 2.0 * batch * s_len * 2 * d * d
    per_step = layers * (2.0 * rows * d * (3 * d + d + d + d + 2 * ffn)
                         + 4.0 * rows * s_len * d) + 2.0 * rows * d * v
    f += steps * per_step
    f += layers * 4.0 * rows * d * sum(range(1, steps + 1))  # self-attention over the cache
    return f


# ---------------------------------------------------------------------------
# a training step (train/train_step.make_train_step at `sizes`)
# ---------------------------------------------------------------------------

def bart_text_flops(sizes: dict, batch: int, s_len: int, t_len: int) -> float:
    """A text-only BART forward (the teacher): encoder over s_len, decoder
    over t_len with cross-attention, LM head."""
    d, v = sizes["d_model"], sizes["vocab_size"]
    enc = sizes["encoder_layers"] * (2.0 * batch * s_len * d * (4 * d + 2 * sizes["encoder_ffn_dim"])
                                     + 4.0 * batch * s_len * s_len * d)
    dec = sizes["decoder_layers"] * (2.0 * batch * t_len * d * (4 * d + 2 * d + 2 * sizes["decoder_ffn_dim"])
                                     + 2.0 * batch * s_len * 2 * d * d
                                     + 4.0 * batch * t_len * t_len * d + 4.0 * batch * t_len * s_len * d)
    return enc + dec + 2.0 * batch * t_len * d * v


def clip_flops(sizes: dict, batch: int) -> float:
    """The frozen CLIP ViT's forward on pixels."""
    w, grid = sizes["clip_width"], sizes["image_size"] // sizes["patch_size"]
    n = grid * grid + 1
    f = 2.0 * batch * grid * grid * sizes["patch_size"] ** 2 * 3 * w
    f += sizes["clip_layers"] * (2.0 * batch * n * w * (4 * w + 8 * w) + 4.0 * batch * n * n * w)
    return f


def train_step_flops(sizes: dict, batch: int) -> float:
    """A training step's model operations: the student's forward and
    backward (3x its forward; remat's recompute not counted), the teacher's
    forward, CLIP's forward."""
    s_len, t_len = sizes["article_max_length"], sizes["caption_max_length"]
    d, v = sizes["d_model"], sizes["vocab_size"]
    student = encoder_flops(sizes, batch)
    student += sizes["decoder_layers"] * (
        2.0 * batch * t_len * d * (4 * d + 2 * d + 2 * sizes["decoder_ffn_dim"])
        + 2.0 * batch * s_len * 2 * d * d
        + 4.0 * batch * t_len * t_len * d + 4.0 * batch * t_len * s_len * d)
    student += 2.0 * batch * t_len * d * v
    return 3.0 * student + bart_text_flops(sizes, batch, s_len, t_len) + clip_flops(sizes, batch)
