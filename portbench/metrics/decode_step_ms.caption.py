"""Device ms of one beam step's model: the device time launched under the
port's "beam_search.model" spans (the decoder stack and the LM head) over
the count of those spans. Silent without a card or without the span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "beam_search.model") or not rec.device:
        return None
    return 1e3 * rec.seconds_by_range("beam_search.model") / spans.count(rec, "beam_search.model")
