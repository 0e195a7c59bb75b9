"""Every matrix product's share of its roofline in the traced batches,
whatever kernel runs it: the least time of all of a batch's products
(portbench/costs.caption_products: the encoder's streams and text stack,
the decoder's cross K/V, each decode step's six a layer and the LM head)
over the device time of every kernel that runs a product: the port's
gemm_bf16 kernels and LM heads, and the library's (cuBLAS, CUTLASS) gemm
and gemv kernels with their split-K reductions. Attention kernels are not
among them. Silent where no such kernel ran."""

import re

PRODUCT = re.compile(r"gemm|gemv|nvjet|splitKreduce|lm_head_kernel|lm_stats_kernel", re.I)
ATTENTION = re.compile(r"fmha|flash|attn|attention", re.I)


def is_product(name: str) -> bool:
    return PRODUCT.search(name) is not None and ATTENTION.search(name) is None


def read(rec):
    if rec is None or "products_least_s" not in rec.extra:
        return None
    secs, _ = rec.kernel_seconds(is_product)
    if secs <= 0:
        return None
    return 100.0 * rec.extra["products_least_s"] / secs
