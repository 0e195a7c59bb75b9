"""The plain reference of VACNIC on LED for the CPU tests: plain PyTorch,
float32, importing nothing of the port and nothing of JAX.

`led_attention` is LED's encoder self-attention with its output projection
(transformers' LEDEncoderAttention; Beltagy et al., arXiv:2004.05150 §3)
written straight from its equations: for each block of query rows the keys
they may see, the global keys (the leading `g`) and the band [i0 - w, i1 +
w) of the block, then for every row i and key j the rule "j is not padded,
and j < g or |i - j| <= w", each allowed key once; an f32 softmax over
them; a padded row's output 0 before the output projection; each global
token's row replaced by its query_global against key_global of every
unpadded token, times value_global. Departures from transformers: a removed
key gets -inf where transformers adds finfo(f32).min (a probability of 0
either way), the global tokens are the leading ones, the length is not
padded to a multiple of the window, and there is no dropout.

`LedReference` is the whole LED-VACNIC forward: the benchmark's plain model
(portbench/reference/model.py, which imports nothing of the port either) with
`led_attention` as every encoder layer's self-attention and LED's positions
without offset (portbench/reference/led.py's LedModel, whose own window
code the tests hold to this one)."""

from __future__ import annotations

import torch

from portbench.reference.led import LedModel


def _lin(p, x):
    return x @ p["kernel"].float() + p["bias"].float()


def led_attention(x, keep, p, pg, heads: int, w: int, g: int):
    """x [B, S, d] f32, keep [B, S] {0, 1}; p: q/k/v/out_proj, pg: the
    global q/k/v_proj ({"kernel" [in, out], "bias"}) -> [B, S, d]."""
    b, n, d = x.shape
    hd = d // heads
    keep = keep.bool()

    def heads_of(y):
        return y.reshape(b, -1, heads, hd).permute(0, 2, 1, 3)

    q = heads_of(_lin(p["q_proj"], x) / hd ** 0.5)
    k, v = heads_of(_lin(p["k_proj"], x)), heads_of(_lin(p["v_proj"], x))
    out = torch.zeros(b, heads, n, hd)
    blk = max(w, 1)
    for i0 in range(0, n, blk):
        i1 = min(n, i0 + blk)
        keys = sorted(set(range(g)) | set(range(max(0, i0 - w), min(n, i1 + w))))
        kk = torch.tensor(keys)
        i = torch.arange(i0, i1)[:, None]
        allowed = (kk[None, :] < g) | ((i - kk[None, :]).abs() <= w)  # [rows, keys]
        allowed = allowed[None] & keep[:, None, kk]                     # [B, rows, keys]
        s = q[:, :, i0:i1] @ k[:, :, kk].transpose(-1, -2)
        s = s.masked_fill(~allowed[:, None], float("-inf"))
        prob = torch.softmax(s, -1).masked_fill(~keep[:, None, i0:i1, None], 0.0)
        out[:, :, i0:i1] = prob @ v[:, :, kk]
    out = out.permute(0, 2, 1, 3).reshape(b, n, d)
    if g:
        qg = heads_of(_lin(pg["q_proj"], x[:, :g]) / hd ** 0.5)
        kg, vg = heads_of(_lin(pg["k_proj"], x)), heads_of(_lin(pg["v_proj"], x))
        s = (qg @ kg.transpose(-1, -2)).masked_fill(~keep[:, None, None, :], float("-inf"))
        og = torch.softmax(s, -1) @ vg
        out = torch.cat([og.permute(0, 2, 1, 3).reshape(b, g, d), out[:, g:]], 1)
    return _lin(p["out_proj"], out)


class LedReference(LedModel):
    """The LED-VACNIC forward with led_attention in every encoder layer."""

    def self_attention(self, p, pg, x, keep):
        s = self.s
        return led_attention(x, keep, p, pg, s["encoder_attention_heads"],
                             s["attention_window"] // 2, s["global_tokens"])


def sizes_of(cfg) -> dict:
    """A port VacnicConfig's sizes as the references read them."""
    b, f, dc = cfg.bart, cfg.fusion, cfg.decode
    return {"encoder_attention_heads": b.encoder_attention_heads, "d_model": b.d_model,
            "only_image": f.only_image, "max_ner_type_len": f.max_ner_type_len,
            "max_ner_type_len_gt": f.max_ner_type_len_gt, "prompt_size": f.prompt_size,
            "img_size": f.img_size, "eos_token_id": b.eos_token_id,
            "forced_bos_token_id": b.forced_bos_token_id, "length_penalty": dc.length_penalty,
            "position_offset": b.position_offset, "attention_window": b.attention_window,
            "global_tokens": b.global_tokens}
