"""Device ms a step of the work launched under the training step's
`train_step.backward` range (autograd, recompute under remat included;
launched from autograd's threads while the range is open), from the
profiler's trace."""


def read(rec):
    if rec is None or not rec.device or not rec.units:
        return None
    return 1e3 * rec.seconds_by_range("train_step.backward") / rec.units
