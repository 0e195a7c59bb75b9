"""The weights of VACNIC on LED (configuration vacnic_led), made from the
seed on the device as portbench/weights.py makes VACNIC's: its tree of
leaves with LED's three changes, so that the port (models/fusion.
multimodal_bart_init under VacnicConfig.led_full) takes it as its own and
the plain reference (reference/led.py) reads the same tensors:

* the encoder's position table (and the names stream's, its copy) holds
  sizes["max_encoder_position_embeddings"] rows and the decoder's
  sizes["max_position_embeddings"], each + sizes["position_offset"] (0);
* every encoder layer has `self_attn_global` (q, k and v_proj: LED's
  query_global, key_global, value_global), N(0, 0.02) kernels, zero biases.

weights.py itself is not changed: its plan is built, the three tables'
shapes are set before the draw, and the global projections are added to
the plan's end."""

from __future__ import annotations

import torch

from portbench import weights as W


def make_model(sizes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The LED-VACNIC tree from `seed`, on `device`, in `dtype`."""
    plan = W._Plan()
    tree = W._multimodal(plan, sizes)
    d, off = sizes["d_model"], sizes["position_offset"]
    enc, dec = tree["encoder"], tree["decoder"]
    n_enc = sizes["max_encoder_position_embeddings"] + off
    for leaf, rows in ((enc["embed_positions"]["weight"], n_enc),
                       (enc["embed_positions_ner"]["weight"], n_enc),
                       (dec["embed_positions"]["weight"], sizes["max_position_embeddings"] + off)):
        plan.leaves[leaf] = ((rows, d), plan.leaves[leaf][1])
    enc["layers"] = tuple(dict(p, self_attn_global={n: W._linear(plan, d, d)
                                                     for n in ("q_proj", "k_proj", "v_proj")})
                          for p in enc["layers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    model = W._fill(tree, plan.make(gen, device, dtype))
    W._seed_ner_tables(model, sizes)
    return model
