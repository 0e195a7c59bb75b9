"""Device ms a step of the work launched under the training step's
`train_step.forward` range (compute_losses: CLIP, the differentiated
forward, the teacher, the losses), from the profiler's trace."""


def read(rec):
    if rec is None or not rec.device or not rec.units:
        return None
    return 1e3 * rec.seconds_by_range("train_step.forward") / rec.units
