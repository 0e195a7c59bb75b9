"""dec_cross_attention's share of its roofline in the traced batches: the
least time of its calls (int8 cross K/V, one a decoder layer and step;
portbench/costs.caption_dec_cross) over the device time of the
dec_cross_kernel family. Silent where its launches are not that count."""

import re

CROSS = re.compile(r"\bdec_cross_kernel")


def read(rec):
    if rec is None or "dec_cross_least_s" not in rec.extra:
        return None
    return rec.roofline_pct(lambda n: CROSS.search(n) is not None, rec.extra["dec_cross_least_s"],
                            rec.extra["dec_cross_launches"])
