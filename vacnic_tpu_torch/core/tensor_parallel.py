"""Tensor parallelism over a model group of processes (the port of what
vacnic_tpu/core/mesh.param_shardings and XLA's SPMD partitioner do together).

JAX places each parameter with a `NamedSharding` in the Megatron layout
(q/k/v, fc1 and the `*up` projections cut along their output dimension,
out_proj, fc2 and the `*down` projections along their input dimension,
everything else replicated) and XLA inserts the collectives. Here the same
rule (`core/mesh.param_dim`) places the leaves, one process a model rank, and
the layers issue the collectives themselves, Megatron's way:

* `shard_params` keeps this rank's slice of each cut leaf, `gather_params`
  rebuilds the whole tree (for a checkpoint, or the decode after training);
* a column-parallel region reads its input through `copy_to_model_parallel`
  (identity forward, all-reduce of the gradient backward), so the gradients
  of what precedes it are whole on every rank;
* a row-parallel product's f32 partial sums meet in
  `reduce_from_model_parallel` (all-reduce forward, identity backward),
  before the bias, and are rounded once (models/layers.row_linear);
* a column-parallel layer's bias is replicated, as in JAX, and read as a
  slice (`column_slice`), whose backward sums the rank slices' gradients so
  the whole leaf's gradient is the same on every rank.

A model group of one process is no group: `model_shard` returns None and
every layer runs its one-process path. A `ModelShard` without a group (a
rank's place only) skips the collectives, as in one process: the
single-process tests read one rank's partial results with it.

Divergences from JAX, refused rather than resharded: a leaf the rule cuts
whose dimension the group size does not divide (JAX replicates it), and an
attention whose head count it does not divide (GSPMD would reshard the
heads) raise a ValueError naming the leaf or the layer.

Collectives over a gloo group on CUDA tensors (two ranks sharing one card,
which NCCL refuses) are staged through host memory: the product stays on
the card, the sum goes through the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from vacnic_tpu_torch.core.mesh import param_dim
from vacnic_tpu_torch.core.profiling import annotate
from vacnic_tpu_torch.core.tree import leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This process's place in a model group: rank `rank` of `size`, and the
    torch.distributed group (None: the collectives are skipped)."""
    rank: int
    size: int
    group: Any = None


def model_shard(group) -> ModelShard | None:
    """The ModelShard of this process in `group`; None for no group or a
    group of one process (the one-process path)."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return ModelShard(dist.get_rank(group), dist.get_world_size(group), group)


# ---------------------------------------------------------------------------
# Collectives (gloo on CUDA tensors through host memory)
# ---------------------------------------------------------------------------

def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group's ranks, in place; returned. Under the
    profiler range "tensor_parallel.all_reduce", so a trace shows the model
    group's traffic apart from the compute around it."""
    with annotate("tensor_parallel.all_reduce"):
        if _through_host(t, group):
            host = t.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's t (of one shape), in rank order, on t's device (under
    the profiler range "tensor_parallel.all_gather")."""
    with annotate("tensor_parallel.all_gather"):
        src = t.detach().contiguous()
        if _through_host(src, group):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return [p.to(t.device) for p in parts]


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ColumnSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: ModelShard, dim: int):
        n = x.shape[dim] // tp.size
        ctx.tp, ctx.dim, ctx.shape = tp, dim, x.shape
        return x.narrow(dim, tp.rank * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        tp, dim = ctx.tp, ctx.dim
        full = grad.new_zeros(ctx.shape)
        full.narrow(dim, tp.rank * grad.shape[dim], grad.shape[dim]).copy_(grad)
        return all_reduce_(full, tp.group), None, None


def copy_to_model_parallel(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """The entry of a column-parallel region: x itself forward; backward the
    gradient summed over the model group (each rank's columns contribute)."""
    if tp is None or tp.group is None:
        return x
    return _CopyToModelParallel.apply(x, tp.group)


def reduce_from_model_parallel(x: torch.Tensor, tp: ModelShard | None) -> torch.Tensor:
    """The exit of a row-parallel product: the ranks' partial sums summed
    (in x's dtype: the caller passes f32 partials); backward the identity."""
    if tp is None or tp.group is None:
        return x
    return _ReduceFromModelParallel.apply(x, tp.group)


def column_slice(x: torch.Tensor, tp: ModelShard | None, dim: int = -1) -> torch.Tensor:
    """This rank's equal slice of a replicated tensor along `dim` (a
    column-parallel layer's bias); backward the slices' gradients placed in
    the whole and summed over the group, so every rank holds the gradient
    of the whole leaf."""
    if tp is None:
        return x
    dim %= x.dim()
    if tp.group is None:
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n)
    return _ColumnSlice.apply(x, tp, dim)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def cut_dim(path: tuple, leaf, size: int) -> int | None:
    """The dimension of `leaf` cut over `size` ranks (None: replicated), by
    core/mesh's rule; a cut dimension the size does not divide is refused."""
    if size == 1 or not isinstance(leaf, torch.Tensor):
        return None
    dim = param_dim(path, leaf)
    if dim is not None and leaf.shape[dim] % size:
        raise ValueError(f"tensor parallel: model_parallel={size} does not divide dimension "
                         f"{dim} ({leaf.shape[dim]}) of {'/'.join(map(str, path))}; JAX would "
                         "replicate it, the port refuses")
    return dim


def check_heads(params: Any, size: int, heads_of: Callable[[tuple], int]) -> None:
    """Refuse a model group whose size does not divide the head count of an
    attention (a dict holding "q_proj") whose projections the rule cuts:
    heads_of(path of the attention) -> its head count."""
    for path, leaf in leaves_with_path(params):
        if path[-2:] == ("q_proj", "kernel") and cut_dim(path, leaf, size) is not None:
            heads = heads_of(path[:-2])
            if heads % size:
                raise ValueError(f"tensor parallel: model_parallel={size} does not divide the "
                                 f"{heads} heads of {'/'.join(map(str, path[:-2]))}")


def shard_params(params: Any, tp: ModelShard | None) -> Any:
    """A tree of the same structure holding this rank's slice of each leaf
    the rule cuts (a copy with storage of its own, so the whole leaf can be
    freed) and the other leaves as they are."""
    if tp is None:
        return params

    def keep(path, leaf):
        dim = cut_dim(path, leaf, tp.size)
        if dim is None:
            return leaf
        n = leaf.shape[dim] // tp.size
        return leaf.detach().narrow(dim, tp.rank * n, n).clone()

    return tree_map(keep, params)


def shard_shape(path: tuple, shape: tuple, size: int) -> tuple:
    """The shape rank i holds of a leaf of `shape` at `path`."""
    dim = cut_dim(path, torch.empty(shape, device="meta"), size)
    return tuple(s // size if i == dim else s for i, s in enumerate(shape))


def is_cut(path: tuple, leaf) -> bool:
    """Whether a leaf of a sharded tree is a slice (the rule names a
    dimension; shard_params refuses any it could not cut)."""
    return isinstance(leaf, torch.Tensor) and param_dim(path, leaf) is not None


def gather_leaf(path: tuple, leaf, tp: ModelShard | None):
    """The whole leaf at `path` from every rank's slice of it (a leaf of a
    sharded tree, or its gradient; a collective where the leaf is cut), on
    leaf's device; a replicated leaf as it is."""
    if tp is None or not is_cut(path, leaf):
        return leaf
    return torch.cat(all_gather(leaf, tp.group), dim=param_dim(path, leaf))


def gather_params(params: Any, tp: ModelShard | None) -> Any:
    """The whole tree from every rank's shards (a collective: every rank of
    the group calls it), on each rank's device; replicated leaves are kept
    as they are."""
    if tp is None:
        return params
    return tree_map(lambda path, leaf: gather_leaf(path, leaf, tp), params)
