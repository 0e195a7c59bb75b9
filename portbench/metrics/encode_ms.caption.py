"""Device ms a traced batch launched under the port's "generate.encode"
span (the fused or layer-by-layer encoder), from the profiler's trace.
Silent without a card or without the span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "generate.encode") or not rec.device or not rec.units:
        return None
    return 1e3 * rec.seconds_by_range("generate.encode") / rec.units
