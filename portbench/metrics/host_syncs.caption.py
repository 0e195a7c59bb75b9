"""Waits of the host on the stream a traced batch: the count of the port's
"beam_search.sync" spans (the loop's done test, the certificates' tests,
the length penalty's host scalars, the n-gram bans' count in a fallback),
over the batches. A count: the same on every run of a model and its
inputs. Silent where the program has no "beam_search.model" span."""

from portbench import spans


def read(rec):
    if not spans.present(rec, "beam_search.model") or not rec.units:
        return None
    return spans.count(rec, "beam_search.sync") / rec.units
