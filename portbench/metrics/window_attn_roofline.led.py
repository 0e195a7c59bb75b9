"""LED's window attention and global rows' share of their roofline in the
traced batches: their least time (portbench/costs/led.window_least_s: each
unpadded row's band and global keys, the global rows' products and
attention) over the device time of everything launched under the port's
"encoder.window_attention" spans (enc_window_kernel, the query_global
product, the key_global | value_global product, the global rows'
dec_cross_attention and their copies). Silent without the span, or where
enc_window_kernel's launches are not a layer's one a batch."""

import re

from portbench import kernel_spans, spans

WINDOW = re.compile(r"\benc_window_kernel\b")


def read(rec):
    if (rec is None or "window_least_s" not in rec.extra
            or not spans.present(rec, "encoder.window_attention")):
        return None
    _, n = kernel_spans.seconds_in(rec, "encoder.window_attention",
                                   lambda name: WINDOW.search(name) is not None)
    secs = rec.seconds_by_range("encoder.window_attention")
    if n != rec.extra["window_launches"] or secs <= 0:
        return None
    return 100.0 * rec.extra["window_least_s"] / secs
