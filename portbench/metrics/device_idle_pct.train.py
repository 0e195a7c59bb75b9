"""The share of the traced window in which no kernel, copy or fill ran on
the card (torch.profiler's device timeline; portbench/trace.py)."""


def read(rec):
    return None if rec is None else rec.idle_pct()
