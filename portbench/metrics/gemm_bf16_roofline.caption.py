"""gemm_bf16's share of its roofline in the traced batches: the least time
of the products it runs (the encoder stack's six a layer at batch x 512
rows, the decoder stack's six a layer and step at batch x beams rows;
portbench/costs.caption_gemm_bf16) over the device time of the port's
gemm kernels (gemm_small_kernel, gemm_mid_kernel, gemm_large_kernel).
Silent where their launches are not the count of those products."""

import re

GEMM = re.compile(r"\bgemm_(small|mid|large)_kernel\b")


def read(rec):
    if rec is None or "gemm_bf16_least_s" not in rec.extra:
        return None
    return rec.roofline_pct(lambda n: GEMM.search(n) is not None, rec.extra["gemm_bf16_least_s"],
                            rec.extra["gemm_bf16_launches"])
