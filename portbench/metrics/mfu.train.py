"""The training step's model FLOPs (portbench/costs.train_step_flops: the
student's forward and backward, the teacher's and CLIP's forwards; remat's
recompute not counted) times the steps of the untraced window, over the
window's seconds times the H100's dense bf16 peak."""


def read(rec):
    return None if rec is None else rec.extra.get("mfu")
