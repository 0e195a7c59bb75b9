"""Device ms a traced batch launched under the port's
"generate.decode_cache" span: the decode weights, the cross K/V projection
with its int8 quantization, the self cache and the LM head's padded copy.
Silent without a card or without the span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "generate.decode_cache") or not rec.device or not rec.units:
        return None
    return 1e3 * rec.seconds_by_range("generate.decode_cache") / rec.units
