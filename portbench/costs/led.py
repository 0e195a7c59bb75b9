"""The operations and bytes of VACNIC on LED's new work (configuration
vacnic_led), from shapes and the traced batch's article lengths, as
(operations, bytes) parts that portbench/costs' `bound` turns into least
times (the LED driver does; this file imports nothing, as the other
yardstick files):

* the window attention of a layer (enc_window_kernel): each unpadded query
  row against its band of 2w + 1 keys, cut by the item's ends, and the
  global keys outside the band; the scores and the value sum once each
  (4 x hd operations a key and head); q, k, v read and the output written
  once, bf16, over every position;
* the global rows of a layer: the query_global product of the global
  tokens, the key_global | value_global product of every token (as LED
  writes it, not folded into q), written and read once in bf16, and one
  query an (item, head) over all S;
* a layer of the decoder's long cross K/V (cross_kv past 1024 positions):
  the product of every position, x and the weights read once, int8 K and V
  and their f32 scales written once;
* the global rows' two products in costs.caption_products' form, for the
  roofline of every product;
* for mfu, what LED changes in costs.caption_flops: the encoder's dense S^2
  self-attention out, the window's and the global rows' operations over
  every position in.
The split dec_cross_attention is costs.caption_dec_cross at S."""

from __future__ import annotations


def band_keys(s_len: int, w: int, g: int, rows: int) -> int:
    """Keys summed over query rows 0 .. rows - 1 of an item of s_len
    positions: the band [i - w, i + w] within [0, s_len), and the global
    keys 0 .. g - 1 where the band does not hold them."""
    total = 0
    for i in range(rows):
        lo, hi = max(0, i - w), min(s_len - 1, i + w)
        total += hi - lo + 1 + max(0, min(g, lo))
    return total


def window_layer(sizes: dict, lengths: list[int]) -> tuple[float, float]:
    """(operations, bytes) of one layer's window attention over a batch of
    items of these lengths (unpadded positions)."""
    d, s_len = sizes["d_model"], sizes["article_max_length"]
    w, g = sizes["attention_window"] // 2, sizes["global_tokens"]
    ops = sum(4.0 * d * band_keys(s_len, w, g, n) for n in lengths)
    byts = len(lengths) * s_len * 4 * d * 2  # q, k, v in; the output out
    return ops, byts


def global_parts(sizes: dict, batch: int) -> list[tuple[float, float]]:
    """(operations, bytes) of one layer's global rows: the query_global
    product, the key_global | value_global product, the attention."""
    d, s_len, g = sizes["d_model"], sizes["article_max_length"], sizes["global_tokens"]
    if not g:
        return []
    q = (2.0 * batch * g * d * d, (batch * g * d + d * d) * 2 + d * 4 + batch * g * d * 2)
    kv = (2.0 * batch * s_len * d * 2 * d,
          (batch * s_len * d + d * 2 * d) * 2 + 2 * d * 4 + batch * s_len * 2 * d * 2)
    att = (4.0 * batch * g * s_len * d,
           batch * s_len * 2 * d * 2 + batch * s_len * 4 + 2 * batch * g * d * 2)
    return [q, kv, att]


def global_products(sizes: dict, batch: int) -> list[tuple[str, int, int, int, int]]:
    """The global rows' matrix products of a batch as costs.caption_products
    lists them, (name, M, K, N, count): query_global of the global tokens,
    key_global | value_global of every token, in every encoder layer."""
    d, s_len, layers = sizes["d_model"], sizes["article_max_length"], sizes["encoder_layers"]
    g = sizes["global_tokens"]
    if not g:
        return []
    return [("global_q", batch * g, d, d, layers), ("global_kv", batch * s_len, d, 2 * d, layers)]


def window_parts(sizes: dict, lengths: list[int]) -> list[tuple[float, float]]:
    """One layer's window attention and global rows, part by part."""
    return [window_layer(sizes, lengths)] + global_parts(sizes, len(lengths))


def cross_kv_layer(sizes: dict, batch: int) -> tuple[float, float]:
    """(operations, bytes) of one layer of the decoder's int8 cross K/V."""
    d, s_len = sizes["d_model"], sizes["article_max_length"]
    ops = 2.0 * batch * s_len * d * 2 * d
    byts = ((batch * s_len * d + d * 2 * d) * 2 + 2 * d * 4 + batch * s_len * 2 * d
            + 2 * batch * d * 4)
    return ops, byts


def attention_flops_change(sizes: dict, batch: int) -> float:
    """What LED adds to costs.caption_flops: every encoder layer's window
    and global rows' operations over every position, less the dense S^2
    self-attention that caption_flops counts."""
    d, s_len, layers = sizes["d_model"], sizes["article_max_length"], sizes["encoder_layers"]
    w, g = sizes["attention_window"] // 2, sizes["global_tokens"]
    window = 4.0 * d * batch * band_keys(s_len, w, g, s_len)
    glob = sum(o for o, _ in global_parts(sizes, batch))
    return layers * (window + glob - 4.0 * batch * s_len * s_len * d)
