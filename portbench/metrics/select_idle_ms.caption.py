"""Device-idle ms a traced batch inside the port's "beam_search.select"
spans: the window less the union of the device's activities, intersected
with the union of those spans (the host choosing the next beams while the
card waits). Silent without a card or without the span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "beam_search.select") or not rec.device or not rec.units:
        return None
    select = spans.intervals(rec, "beam_search.select")
    return spans.overlap_us(spans.device_idle(rec), select) / 1e3 / rec.units
