"""The port's config copy equals the JAX package's, preset by preset and
field by field, and both serialize to the same JSON."""

import dataclasses

import pytest
import torch

from vacnic_tpu.core import config as J
from vacnic_tpu_torch.core import config as T
from vacnic_tpu_torch.core.rng import make_generator

PRESETS = [
    ("full_train", lambda m: m.VacnicConfig.full_train()),
    ("onlyvis_train", lambda m: m.VacnicConfig.onlyvis_train()),
    ("tiny", lambda m: m.VacnicConfig.tiny()),
    ("tiny_only_image", lambda m: m.VacnicConfig.tiny(only_image=True)),
    ("bart_base", lambda m: m.BartConfig.base()),
    ("bart_tiny", lambda m: m.BartConfig.tiny()),
    ("clip_tiny", lambda m: m.ClipVisionConfig.tiny()),
    ("fusion_tiny", lambda m: m.FusionConfig.tiny()),
    ("decode", lambda m: m.DecodeConfig()),
    ("train", lambda m: m.TrainConfig()),
    ("data", lambda m: m.DataConfig()),
]


def without_port_fields(tree: dict) -> dict:
    """`asdict` of a port config less BartConfig's LED fields, which the JAX
    package does not have (T.PORT_ONLY_BART_FIELDS), wherever a BartConfig
    sits in the tree; asserts that each of them holds its BART default."""
    defaults = {f.name: f.default for f in dataclasses.fields(T.BartConfig)}
    if "bart" in tree:
        return {**tree, "bart": without_port_fields(tree["bart"])}
    if "attention_window" not in tree:
        return tree
    for name in T.PORT_ONLY_BART_FIELDS:
        assert tree[name] == defaults[name], (name, tree[name])
    return {k: v for k, v in tree.items() if k not in T.PORT_ONLY_BART_FIELDS}


@pytest.mark.parametrize("name,make", PRESETS, ids=[p[0] for p in PRESETS])
def test_preset_fields_equal(name, make):
    """Every JAX field equal; the port's LED fields at their BART defaults."""
    j, t = make(J), make(T)
    assert type(j).__name__ == type(t).__name__
    assert without_port_fields(dataclasses.asdict(t)) == dataclasses.asdict(j)
    if hasattr(j, "to_json"):
        import json

        assert without_port_fields(json.loads(t.to_json())) == json.loads(j.to_json())
        assert T.VacnicConfig.from_json(j.to_json()) == t


def test_derived_properties_and_dtypes():
    for make in (lambda m: m.BartConfig(), lambda m: m.BartConfig.tiny()):
        j, t = make(J), make(T)
        assert (t.head_dim, t.decoder_head_dim) == (j.head_dim, j.decoder_head_dim)
    assert T.ClipVisionConfig().num_patches == J.ClipVisionConfig().num_patches
    assert T.dtype_of("bfloat16") is torch.bfloat16
    assert T.dtype_of("float32") is torch.float32


def test_generator_is_seeded():
    a = torch.randn(4, generator=make_generator(7))
    b = torch.randn(4, generator=make_generator(7))
    assert torch.equal(a, b)
