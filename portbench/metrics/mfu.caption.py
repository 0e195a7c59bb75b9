"""The captioning batch's model FLOPs (portbench/costs.caption_flops: the
encoder, the decoder's cross K/V, 49 decoder steps over batch x beams rows
and the LM head over the vocabulary) times the batches of the untraced
window, over the window's seconds times the H100's dense bf16 peak."""


def read(rec):
    return None if rec is None else rec.extra.get("mfu")
