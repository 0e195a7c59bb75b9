"""Device ms a traced batch launched under the port's
"encoder.window_attention" spans: every layer's window attention and
global rows. Silent without a card or without the span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "encoder.window_attention") or not rec.device or not rec.units:
        return None
    return 1e3 * rec.seconds_by_range("encoder.window_attention") / rec.units
