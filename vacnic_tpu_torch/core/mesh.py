"""Device meshes and sharding descriptors (port of vacnic_tpu/core/mesh.py).

JAX's single-controller `Mesh` names a grid of devices with axes:

  * ``data``  -- data parallelism: the batch is cut into contiguous row
    shards, one a data row of the mesh, and the parameters are replicated;
  * ``model`` -- tensor parallelism for the big BART products (the rule
    `param_shardings` gives; `core/tensor_parallel` executes it across
    processes, one a device).

Here a `Mesh` is a plain description of that grid of `torch.device`s. One
process drives every device of it: `infer/generate.generate_mm_sharded`
runs one host thread a device of the data axis. Training across processes
is `core/distributed` instead.

Repeated `torch.device("cpu")` entries are virtual devices, the port's
counterpart of JAX's forced host device count: the CPU tests build an
8-way mesh of them. A repeated CUDA device is refused: two workers on one
card would run two streams at once, and the LM-stats arrival counters are
one set a device that overlapping launches must not share
(`kernels/lm_stats.counters`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from vacnic_tpu_torch.core.config import MeshConfig
from vacnic_tpu_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device, shape (dp, mp), with the
    axis names `axis_names`. Compared by identity, as JAX's caches key on
    the mesh object."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def data_devices(self, data_axis: str = "data") -> list[torch.device]:
        """The first device of every row along `data_axis`: where the row
        shards of a batch go (with a model axis wider than 1, the row's
        other devices take no part: the decode and the service are data
        parallel only, as in JAX, and the tensor-parallel step runs in
        processes, `core/tensor_parallel`)."""
        if data_axis not in self.axis_names:
            raise ValueError(f"mesh has no {data_axis!r} axis (axes: {list(self.axis_names)})")
        grid = np.moveaxis(self.devices, self.axis_names.index(data_axis), 0)
        return [row.flat[0] for row in grid]


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A (data, model) mesh over `devices`, with JAX's rule: model_parallel
    devices a data row, data_parallel rows (-1: as many as the devices
    fill), and a ValueError when they do not cover the devices exactly. The
    default is every visible card; without one it raises (no CPU fallback:
    a CPU mesh is asked for by passing its devices)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')] "
                               "* n for a mesh of virtual CPU devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    if any(d.index is None for d in cards):
        raise ValueError("make_mesh: name each CUDA device with its index (cuda:0, cuda:1, ...)")
    if len(set(cards)) != len(cards):
        raise ValueError(f"make_mesh: a CUDA device appears twice in {devices}: one worker a "
                         "card (repeated devices are virtual CPU devices only)")
    if len({d.type for d in devices}) != 1 or devices[0].type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: needs CUDA devices or CPU devices, got {devices}")
    n = len(devices)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, mp), (cfg.data_axis, cfg.model_axis))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which dimension of an array is cut over which mesh axis (None: kept
    whole on every device), the port's PartitionSpec of one axis. Not a
    tuple, so that the tree helpers see one leaf."""
    mesh: Mesh
    dim: int | None = None
    axis: str | None = None


def batch_sharding(mesh: Mesh) -> ShardSpec:
    """The leading batch dimension cut over the mesh's first (data) axis."""
    return ShardSpec(mesh, 0, mesh.axis_names[0])


def replicated(mesh: Mesh) -> ShardSpec:
    return ShardSpec(mesh)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A global array held as contiguous row shards, shard i on the i-th
    device of the mesh's data axis (`Mesh.data_devices`): what a batch put
    with `batch_sharding` is. `infer/generate.generate_mm_sharded` takes its
    shards where they lie."""
    shards: tuple[torch.Tensor, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        rows = sum(s.shape[0] for s in self.shards)
        return (rows, *self.shards[0].shape[1:])

    def map(self, fn) -> "Sharded":
        """fn applied to each shard (row-wise functions only)."""
        return Sharded(tuple(fn(s) for s in self.shards))

    def gather(self, device) -> torch.Tensor:
        """The global array on one device."""
        return torch.cat([s.to(device) for s in self.shards])


# ---------------------------------------------------------------------------
# Parameter sharding rules (tensor parallelism, core/tensor_parallel)
# ---------------------------------------------------------------------------
# The Megatron layout of vacnic_tpu/core/mesh.py: q/k/v and fc1 column-
# parallel (the output dimension cut), out_proj and fc2 row-parallel (the
# input dimension cut); biases, layer norms and embeddings replicated. The
# port's kernels are [in, out] as JAX's, so the dimensions are the same.

_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "up")  # output dim cut
_ROW_PARALLEL = ("out_proj", "fc2", "down")  # input dim cut


def param_dim(path: tuple, leaf) -> int | None:
    """The dimension the rule cuts for a leaf at `path` (None: replicated),
    before the divisibility test: 1 for a column-parallel kernel, 0 for a
    row-parallel one."""
    name = str(path[-1]) if path else ""
    parent = str(path[-2]) if len(path) >= 2 else ""
    if name not in ("kernel", "weight") or getattr(leaf, "ndim", 0) != 2:
        return None
    if any(tag in parent for tag in _COL_PARALLEL):
        return 1
    if any(tag in parent for tag in _ROW_PARALLEL):
        return 0
    return None


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """One ShardSpec a leaf of `params`, the tree's structure kept: the
    split dimension over the mesh's model axis, or replicated where the
    rule names no dimension, the model axis has one device, or the
    dimension does not divide by it. A plain function of paths and shapes;
    `core/tensor_parallel.shard_params` places a tree by the same rule."""
    model_axis = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    msize = mesh.shape.get(model_axis, 1) if model_axis else 1

    def spec_for(path, leaf):
        dim = param_dim(path, leaf) if msize > 1 else None
        if dim is None or leaf.shape[dim] % msize:
            return replicated(mesh)
        return ShardSpec(mesh, dim, model_axis)

    return tree_map(spec_for, params)
