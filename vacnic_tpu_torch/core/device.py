"""Where the port's entry points run: "cuda" unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` or "cuda"; refuses a cuda device when there is no card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless the caller "
                           "passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def as_tensor(x, dev: torch.device):
    """A tensor or numpy array (or None) on `dev`."""
    if x is None:
        return None
    return torch.as_tensor(x).to(dev)
