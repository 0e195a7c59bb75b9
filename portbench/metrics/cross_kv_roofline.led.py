"""The decoder's long cross K/V's share of its roofline in the traced
batches: the least time of the int8 K/V of every layer
(portbench/costs/led.cross_kv_least_s) over the device time of
cross_kv_gemm_kernel and cross_kv_quant_kernel launched under the port's
"generate.decode_cache" span (the encoder's global rows launch the product
kernel too, under "generate.encode"). Silent without the span, or where
the product's launches there are not one a decoder layer and batch."""

import re

from portbench import kernel_spans, spans

PRODUCT = re.compile(r"\bcross_kv_gemm_kernel\b")
QUANT = re.compile(r"\bcross_kv_quant_kernel\b")


def read(rec):
    if (rec is None or "cross_kv_least_s" not in rec.extra
            or not spans.present(rec, "generate.decode_cache")):
        return None
    prod_s, n = kernel_spans.seconds_in(rec, "generate.decode_cache",
                                        lambda name: PRODUCT.search(name) is not None)
    quant_s, _ = kernel_spans.seconds_in(rec, "generate.decode_cache",
                                         lambda name: QUANT.search(name) is not None)
    if n != rec.extra["cross_kv_launches"] or prod_s + quant_s <= 0:
        return None
    return 100.0 * rec.extra["cross_kv_least_s"] / (prod_s + quant_s)
