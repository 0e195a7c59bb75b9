"""The plain reference of the VACNIC model: plain PyTorch, float32, no
kernel, no cache, no batching tricks. A frozen copy of the arithmetic of the
port's layer-by-layer model code (vacnic_tpu_torch/models/layers.py,
bart.py, fusion.py and clip_vit.py at commit 024b7cd), written out again
here; it imports nothing of the port.

It reads the benchmark's weight tree (portbench/weights.py: the port's
layout) and a configuration's `sizes`. Every product runs in float32 with
TF32 off (the caller sets `torch.backends.cuda.matmul.allow_tf32 = False`)
or, with `prec="fp8"`, on operands rounded to float8 e4m3 with one scale a
tensor: the control that stands for a lower-precision path.

Dropout (training) is the port's: a mask of uniform 16-bit integers from a
generator on the tensor's device seeded with a per-site seed, the seeds
derived with splitmix64 in the port's order (`fold_in`, `RngStream`), so the
reference draws the masks the port draws.
"""

from __future__ import annotations

import torch

POS_OFFSET = 2
FP8_MAX = 448.0
_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# precision and dropout
# ---------------------------------------------------------------------------

def q8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale (amax / 448) for the tensor,
    back in float32; the gradient passes through the rounding unchanged."""
    t = t.float()
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    return _mix64(_mix64(seed & _M64) ^ (data & _M64)) >> 1


def split(seed: int) -> tuple[int, int]:
    return fold_in(seed, 0), fold_in(seed, 1)


class Rng:
    """The n-th `next()` is fold_in(seed, n); None yields None."""

    def __init__(self, seed):
        self.seed, self.n = seed, 0

    def next(self):
        if self.seed is None:
            return None
        self.n += 1
        return fold_in(self.seed, self.n)


def dropout(x: torch.Tensor, rate: float, seed) -> torch.Tensor:
    if seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    thresh = min(int(round(keep * 65536.0)), 65535)
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed))
    bits = torch.randint(0, 65536, list(x.shape), generator=g, device=x.device,
                         dtype=torch.int32)
    return torch.where(bits < thresh, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Model:
    """The reference over one weight tree. `prec` "f32" or "fp8" (the
    control); `rate` the dropout rate (0 for inference)."""

    def __init__(self, sizes: dict, prec: str = "f32", rate: float = 0.0):
        if prec not in ("f32", "fp8"):
            raise ValueError(f"prec must be f32 or fp8, got {prec!r}")
        self.s, self.prec, self.rate = sizes, prec, rate

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.prec == "fp8":
            return torch.matmul(q8(a), q8(w))
        return torch.matmul(a.float(), w.float())

    def linear(self, p, x):
        return self.mm(x, p["kernel"]) + p["bias"].float()

    @staticmethod
    def layernorm(p, x, eps: float = 1e-5):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()

    @staticmethod
    def gelu(x):
        return torch.nn.functional.gelu(x, approximate="none")

    def drop(self, x, rng: Rng):
        return dropout(x, self.rate, rng.next())

    def embed_and_norm(self, table, pos, ln, ids, rng: Rng):
        x = table["weight"][ids.long()].float()
        positions = torch.arange(ids.shape[-1], device=ids.device) + POS_OFFSET
        x = x + pos["weight"][positions].float()[None]
        return self.drop(self.layernorm(ln, x), rng)

    def ffn(self, up, down, ln, x, rng: Rng):
        h = self.gelu(self.linear(up, x))
        rng.next()  # the activation dropout's site (rate 0 in these configurations)
        h = self.drop(self.linear(down, h), rng)
        return self.layernorm(ln, x + h)

    def mha(self, p, x, kv=None, mask=None, heads: int | None = None):
        heads = heads or self.s["encoder_attention_heads"]
        b, t, d = x.shape
        hd = d // heads
        src = x if kv is None else kv

        def split_heads(y):
            return y.reshape(y.shape[0], y.shape[1], heads, hd).permute(0, 2, 1, 3)

        q = split_heads(self.linear(p["q_proj"], x) * hd ** -0.5)
        k = split_heads(self.linear(p["k_proj"], src))
        v = split_heads(self.linear(p["v_proj"], src))
        scores = torch.einsum("bhtd,bhsd->bhts", q, k)
        if mask is not None:
            scores = scores + mask
        out = torch.einsum("bhts,bhsd->bhtd", torch.softmax(scores, -1), v)
        return self.linear(p["out_proj"], out.permute(0, 2, 1, 3).reshape(b, t, d))

    @staticmethod
    def pad_bias(mask: torch.Tensor, tgt_len: int) -> torch.Tensor:
        """[B, S] keep-mask -> additive [B, 1, T, S] (HF `_expand_mask`)."""
        b, s = mask.shape
        m = mask[:, None, None, :].float().expand(b, 1, tgt_len, s)
        return (1.0 - m) * torch.finfo(torch.float32).min

    @staticmethod
    def causal(t: int, device) -> torch.Tensor:
        i = torch.arange(t, device=device)
        keep = i[None, :] <= i[:, None]
        return torch.where(keep, 0.0, torch.finfo(torch.float32).min)[None, None]

    # -- the multimodal encoder ----------------------------------------------

    def image_prompt(self, enc, cls):
        s = self.s
        h = torch.tanh(self.linear(enc["prompt_mlp"]["prompt_fc1"], cls))
        h = self.linear(enc["prompt_mlp"]["prompt_fc2"], h)
        h = h.reshape(h.shape[0], s["prompt_size"], s["img_size"])
        return self.linear(enc["visual_map"], h) if "visual_map" in enc else h

    def encode(self, model, x: dict, dropout_rng=None) -> dict:
        """The fused-layer encoder of the released configurations
        (add_ner_ffn) -> {"last_hidden", "face"}. `x`: input_ids,
        attention_mask, image_features and, unless only_image,
        face_features, face_mask, name_ids, name_mask."""
        s, enc = self.s, model["encoder"]
        rng = Rng(dropout_rng)
        ids, amask = x["input_ids"], x["attention_mask"]
        h = self.embed_and_norm(model["shared"], enc["embed_positions"],
                                enc["layernorm_embedding"], ids, rng)
        face = ner = fn_bias = None
        if not s["only_image"]:
            ner = self.embed_and_norm(enc["embed_tokens_ner"], enc["embed_positions_ner"],
                                      enc["layernorm_embedding_ner"], x["name_ids"], rng)
            face = self.linear(enc["face_proj"], x["face_features"].float())
            fn_bias = self.pad_bias(torch.cat([x["face_mask"], x["name_mask"]], 1),
                                    s["max_ner_type_len"])
        img = self.image_prompt(enc, x["image_features"].float())
        self_bias = self.pad_bias(amask, ids.shape[1])
        for i, p in enumerate(enc["layers"]):
            lr = Rng(None if dropout_rng is None else fold_in(dropout_rng, i))
            img = self.ffn(p["img_up"], p["img_down"], p["img_layer_norm"], img, lr)
            if not s["only_image"]:
                face = self.ffn(p["face_up"], p["face_down"], p["face_layer_norm"], face, lr)
                a = self.mha(p["self_attn_img_name"], ner, torch.cat([face, ner], 1), fn_bias)
                ner = self.layernorm(p["img_name_attn_layer_norm"], ner + a)
                b, n_len, d = ner.shape
                t = self.gelu(self.linear(p["ner_map_up"], ner.reshape(b, d, n_len)))
                lr.next()
                t = self.drop(self.linear(p["ner_map_down"], t), lr)
                prefix = self.layernorm(p["ner_map_layer_norm"],
                                        t.reshape(b, s["max_ner_type_len_gt"], d))
                kv = torch.cat([img, prefix], 1)
            else:
                kv = img
            a = self.mha(p["self_attn"], h, mask=self_bias)
            h = self.layernorm(p["self_attn_layer_norm"], h + self.drop(a, lr))
            a = self.mha(p["cross_attn_img_ner"], h, kv)
            h = self.layernorm(p["img_ner_attn_layer_norm"], h + self.drop(a, lr))
            h = self.ffn(p["fc1"], p["fc2"], p["final_layer_norm"], h, lr)
        return {"last_hidden": h, "face": face}

    def encode_text(self, model, ids, amask):
        """The text-only BART encoder (the CoLaM teacher's), no dropout."""
        enc, rng = model["encoder"], Rng(None)
        h = self.embed_and_norm(model["shared"], enc["embed_positions"],
                                enc["layernorm_embedding"], ids, rng)
        bias = self.pad_bias(amask, ids.shape[1])
        for p in enc["layers"]:
            a = self.mha(p["self_attn"], h, mask=bias)
            h = self.layernorm(p["self_attn_layer_norm"], h + a)
            h = self.ffn(p["fc1"], p["fc2"], p["final_layer_norm"], h, rng)
        return h

    # -- the decoder and the head ----------------------------------------------

    def decode(self, model, dec_ids, enc_out, enc_mask, dropout_rng=None):
        """Teacher-forced decoder over dec_ids [B, T] -> hidden [B, T, d]."""
        dec = model["decoder"]
        h = self.embed_and_norm(model["shared"], dec["embed_positions"],
                                dec["layernorm_embedding"], dec_ids, Rng(dropout_rng))
        t = dec_ids.shape[1]
        self_bias = self.causal(t, dec_ids.device)
        cross_bias = self.pad_bias(enc_mask, t)
        for i, p in enumerate(dec["layers"]):
            lr = Rng(None if dropout_rng is None else fold_in(dropout_rng, i))
            a = self.mha(p["self_attn"], h, mask=self_bias)
            h = self.layernorm(p["self_attn_layer_norm"], h + self.drop(a, lr))
            a = self.mha(p["encoder_attn"], h, enc_out, cross_bias)
            h = self.layernorm(p["encoder_attn_layer_norm"], h + self.drop(a, lr))
            h = self.ffn(p["fc1"], p["fc2"], p["final_layer_norm"], h, lr)
        return h

    def logits(self, model, hidden):
        return self.mm(hidden, model["shared"]["weight"].t()) + model["final_logits_bias"].float()


# ---------------------------------------------------------------------------
# captions: the beam score of a served caption
# ---------------------------------------------------------------------------

def scored_positions(seqs: torch.Tensor, sizes: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Which positions of each served caption [B, L] add a log-probability
    to its beam score, and the score's length: transformers-4.18 beam search
    (the port's `hf_compat="4.18"`) adds log p(token) at every position from
    1 to the caption's EOS, except a forced BOS at position 1 and a forced EOS
    at position L - 1, which add nothing; a caption ending in EOS at position
    t is scored sum / t ** length_penalty, one without EOS sum / L ** lp.
    -> (mask [B, L] bool, length [B] float)."""
    b, length = seqs.shape
    pos = torch.arange(length, device=seqs.device)[None, :].expand(b, length)
    is_eos = (seqs == sizes["eos_token_id"]) & (pos >= 1)
    first = torch.where(is_eos, pos, torch.full_like(pos, length)).amin(1)
    mask = (pos >= 1) & (pos <= first[:, None]) & (pos < length)
    if sizes.get("forced_bos_token_id") is not None:
        mask &= pos != 1
    mask &= pos != length - 1  # the forced EOS of the last step
    denom = torch.where(first < length, first, torch.full_like(first, length)).float()
    return mask, denom


def caption_sums(ref: Model, model, x: dict, seqs: torch.Tensor) -> torch.Tensor:
    """The reference's sum of the scored log-probabilities of each served
    caption (teacher-forced over its own tokens) -> [B] float32 (nats)."""
    enc = ref.encode(model, x)["last_hidden"]
    dec_in = seqs[:, :-1]
    h = ref.decode(model, dec_in, enc, x["attention_mask"])
    mask, _ = scored_positions(seqs, ref.s)
    tgt = seqs[:, 1:]
    out = torch.zeros(seqs.shape[0], device=seqs.device)
    for t0 in range(0, tgt.shape[1], 8):  # the [B, T, V] log-probabilities in slices
        lp = torch.log_softmax(ref.logits(model, h[:, t0:t0 + 8]), -1)
        got = lp.gather(-1, tgt[:, t0:t0 + 8, None].long())[..., 0]
        out += (got * mask[:, 1 + t0:1 + t0 + 8]).sum(1)
    return out
