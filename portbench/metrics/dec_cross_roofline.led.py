"""The split dec_cross_attention's share of its roofline in the traced
batches (LED's 16384 positions over a cluster): the least time of its calls
(int8 cross K/V, one a decoder layer and step, bytes-bound;
portbench/costs/led.dec_cross_least_s) over the device time of
dec_cross_kernel_split. Silent where its launches are not that count."""

import re

SPLIT = re.compile(r"\bdec_cross_kernel_split\b")


def read(rec):
    if rec is None or "dec_cross_least_s" not in rec.extra:
        return None
    return rec.roofline_pct(lambda n: SPLIT.search(n) is not None, rec.extra["dec_cross_least_s"],
                            rec.extra["dec_cross_launches"])
