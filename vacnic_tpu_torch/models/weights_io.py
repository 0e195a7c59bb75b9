"""Parameter conversion into the port (port of the loading half of
vacnic_tpu/models/weights_io.py).

The port keeps the JAX package's tree and its linear layout: a `kernel` is
[in, out] in both packages, so no array is transposed on the way in, and
`models/layers.linear` computes `x @ kernel`. The CUDA GEMM
(kernels/csrc/gemm_bf16.cu) reads its weight operand in the same [K, N]
row-major layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, device: str | torch.device = "cpu",
                    dtype: torch.dtype | None = None) -> Any:
    """JAX parameter pytree whose leaves the caller converted to numpy ->
    the same tree of torch tensors on `device`. Dicts stay dicts and tuples
    stay tuples; floating leaves are cast to `dtype` when one is given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" and arr.dtype != np.float32:
        arr = arr.astype(np.float32)  # numpy has no bfloat16: widen first
    t = torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tree_to(tree: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """Move (and for floating leaves, cast) every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    t = tree.to(device) if device is not None else tree
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t
