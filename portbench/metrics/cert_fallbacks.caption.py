"""Beam steps a traced batch whose shortlist or window certificate failed
and fell back to the whole-vocabulary selection: the count of the port's
"beam_search.fallback" spans, over the batches (0 where none failed).
Silent where the program has no "beam_search.model" span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "beam_search.model") or not rec.units:
        return None
    return spans.count(rec, "beam_search.fallback") / rec.units
