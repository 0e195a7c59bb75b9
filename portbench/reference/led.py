"""The plain reference of VACNIC on LED-large-16384 (the configuration
vacnic_led): plain PyTorch, float32, no kernel, no cache. It is
portbench/reference/model.py's Model, whose helpers it takes and whose file
it leaves as it is, with LED's two departures from BART:

* the learned positions have no offset (sizes["position_offset"], 0), the
  encoder's table holds 16384 rows and the decoder's 1024;
* every encoder layer's self-attention is LED's (transformers'
  LEDEncoderSelfAttention with its `output` projection; Beltagy et al.,
  arXiv:2004.05150 §3): row i attends to the keys within w =
  attention_window / 2 of it and to the item's global keys (the first
  sizes["global_tokens"]), through q, k and v_proj; the softmax over
  [global columns || band] is f32; a padded row's probabilities are 0; each
  global token's row is then replaced by its attention over every unpadded
  key through the layer's self_attn_global q, k and v_proj (LED's
  query_global, key_global, value_global).

The window is computed from those equations in blocks of w query rows
against their key range [i0 - w, i1 + w) and the global keys, so that S
16384 fits. As in transformers, a key removed from a row (padded, global
inside the band, or outside it) gets finfo(f32).min added, not -inf: its
probability is exactly 0 either way. Departures from transformers' LED: the
global tokens are the leading ones (LED takes any mask), the sequence is
not padded to a multiple of the window (the benchmark's S is one), and
there is no dropout.

Every product runs in float32 with TF32 off (the caller sets
`torch.backends.cuda.matmul.allow_tf32 = False`) or, with `prec="fp8"`,
on operands rounded to float8 e4m3 with one scale a tensor, as Model's."""

from __future__ import annotations

import torch

from portbench.reference.model import Model, Rng

MIN = torch.finfo(torch.float32).min


class LedModel(Model):
    """Model with LED's positions and encoder self-attention."""

    def embed_and_norm(self, table, pos, ln, ids, rng: Rng):
        x = table["weight"][ids.long()].float()
        positions = torch.arange(ids.shape[-1], device=ids.device) + self.s["position_offset"]
        x = x + pos["weight"][positions].float()[None]
        return self.drop(self.layernorm(ln, x), rng)

    def self_attention(self, p, pg, x, keep):
        """LED's self-attention of one layer: x [B, S, d], keep [B, S] {0, 1}."""
        s = self.s
        heads, w, g = s["encoder_attention_heads"], s["attention_window"] // 2, s["global_tokens"]
        b, n, d = x.shape
        hd = d // heads

        def split(y):
            return y.reshape(b, n, heads, hd).permute(0, 2, 1, 3)

        q = split(self.linear(p["q_proj"], x) * hd ** -0.5)
        k, v = split(self.linear(p["k_proj"], x)), split(self.linear(p["v_proj"], x))
        padded = keep == 0
        removed = padded.clone()
        removed[:, :g] = True  # the global keys leave the band; they come back as columns
        out = torch.zeros_like(q)
        for i0 in range(0, n, max(w, 1)):
            i1 = min(n, i0 + max(w, 1))
            j0, j1 = max(0, i0 - w), min(n, i1 + w)
            i = torch.arange(i0, i1, device=x.device)[:, None]
            j = torch.arange(j0, j1, device=x.device)[None, :]
            band = torch.einsum("bhid,bhjd->bhij", q[:, :, i0:i1], k[:, :, j0:j1])
            outside = ((i - j).abs() > w)[None, None]
            band = band + torch.where(outside | removed[:, None, None, j0:j1], MIN, 0.0)
            glob = torch.einsum("bhid,bhjd->bhij", q[:, :, i0:i1], k[:, :, :g])
            glob = glob + torch.where(padded[:, None, None, :g], MIN, 0.0)
            prob = torch.softmax(torch.cat([glob, band], -1), -1)
            prob = prob.masked_fill(padded[:, None, i0:i1, None], 0.0)
            out[:, :, i0:i1] = (torch.einsum("bhij,bhjd->bhid", prob[..., :g], v[:, :, :g])
                                + torch.einsum("bhij,bhjd->bhid", prob[..., g:], v[:, :, j0:j1]))
        out = out.permute(0, 2, 1, 3).reshape(b, n, d)
        if g:
            qg = self.linear(pg["q_proj"], x[:, :g]).reshape(b, g, heads, hd).permute(0, 2, 1, 3)
            qg = qg * hd ** -0.5
            kg, vg = split(self.linear(pg["k_proj"], x)), split(self.linear(pg["v_proj"], x))
            sc = torch.einsum("bhid,bhjd->bhij", qg, kg) + torch.where(padded, MIN, 0.0)[:, None, None]
            og = torch.einsum("bhij,bhjd->bhid", torch.softmax(sc, -1), vg)
            out = torch.cat([og.permute(0, 2, 1, 3).reshape(b, g, d), out[:, g:]], 1)
        return self.linear(p["out_proj"], out)

    def encode(self, model, x: dict, dropout_rng=None) -> dict:
        """Model.encode with LED's self-attention in every layer."""
        s, enc = self.s, model["encoder"]
        rng = Rng(None)
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
        for p in enc["layers"]:
            img = self.ffn(p["img_up"], p["img_down"], p["img_layer_norm"], img, rng)
            if not s["only_image"]:
                face = self.ffn(p["face_up"], p["face_down"], p["face_layer_norm"], face, rng)
                a = self.mha(p["self_attn_img_name"], ner, torch.cat([face, ner], 1), fn_bias)
                ner = self.layernorm(p["img_name_attn_layer_norm"], ner + a)
                b, n_len, d = ner.shape
                t = self.gelu(self.linear(p["ner_map_up"], ner.reshape(b, d, n_len)))
                t = self.linear(p["ner_map_down"], t)
                prefix = self.layernorm(p["ner_map_layer_norm"],
                                        t.reshape(b, s["max_ner_type_len_gt"], d))
                kv = torch.cat([img, prefix], 1)
            else:
                kv = img
            a = self.self_attention(p["self_attn"], p["self_attn_global"], h, amask)
            h = self.layernorm(p["self_attn_layer_norm"], h + a)
            a = self.mha(p["cross_attn_img_ner"], h, kv)
            h = self.layernorm(p["img_ner_attn_layer_norm"], h + a)
            h = self.ffn(p["fc1"], p["fc2"], p["final_layer_norm"], h, rng)
        return {"last_hidden": h, "face": face}
