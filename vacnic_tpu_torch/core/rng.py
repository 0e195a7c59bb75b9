"""Seeds to explicit torch.Generators (the port's counterpart of
vacnic_tpu/core/rng.py). Every random draw in the port takes a generator
argument or an integer seed; nothing reads torch's global RNG.

`set_random_seed` seeds Python's `random`, numpy and torch's global RNG as
the reference does (SURVEY §0.1: everything from --seed, default 684331,
inference seed 42) and returns the root seed. Seeds for the parts of a run
come from it with `models.layers.fold_in` (JAX's `jax.random.fold_in`), and
a generator with `make_generator(fold_in(root, n), device)`.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from vacnic_tpu_torch.models.layers import fold_in

# JAX's PRNG implementations (TrainConfig.prng_impl). They pick how JAX makes
# its random bits; the port's bits come from torch's generators whatever the
# name, so both are accepted and change nothing.
PRNG_IMPLS = ("threefry2x32", "rbg")


def make_generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A fresh generator on `device`, seeded with `seed`. CPU and CUDA
    generators give different streams for one seed; tests that compare the
    two packages make their inputs with numpy instead."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def set_random_seed(seed: int, impl: str | None = None) -> int:
    """Seed python/numpy/torch and return the root seed (an int, the port's
    PRNG key). `impl` is JAX's PRNG implementation name: "threefry2x32" or
    "rbg" are accepted and do nothing here."""
    if impl is not None and impl not in PRNG_IMPLS:
        raise ValueError(f"unknown PRNG implementation {impl!r} (one of {PRNG_IMPLS})")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return int(seed)


def split_like(seed: int, names: tuple[str, ...]) -> dict[str, int]:
    """One independent seed a name: the i-th is fold_in(seed, i), as
    `models.layers.split` makes its two."""
    return {name: fold_in(seed, i) for i, name in enumerate(names)}
