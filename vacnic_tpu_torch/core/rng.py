"""Seeds to explicit torch.Generators (the port's counterpart of
vacnic_tpu/core/rng.py). Every random draw in the port takes a generator
argument; nothing reads torch's global RNG."""

from __future__ import annotations

import torch


def make_generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A fresh generator on `device`, seeded with `seed`. CPU and CUDA
    generators give different streams for one seed; tests that compare the
    two packages make their inputs with numpy instead."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
