# Frozen copy of msckf_stereo_c_torch/utils/lanes.py at commit 50013dad8c92.
"""The leading lane axis: B independent sequences stepped together.

Every model function of the port works on states and inputs whose tensors
carry a leading lane axis ``B``, the counterpart of ``jax.vmap`` over
sequences in the JAX package.  The one-sequence entry points (``vio_step``,
``filter_step``, ...) add the axis, step, and drop it again.  The helpers
here map over the port's trees (NamedTuples and tuples of tensors, ``None``
kept) and do the per-lane gathers and scatters the models share.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` applied to every tensor of a tree of NamedTuples and tuples."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def stack_lanes(trees) -> Any:
    """One batched tree from the one-lane trees ``trees`` (same structure),
    each tensor stacked along a new leading lane axis."""
    first = trees[0]
    if first is None:
        return None
    if hasattr(first, "_fields"):
        return type(first)(*(stack_lanes(list(xs)) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return tuple(stack_lanes(list(xs)) for xs in zip(*trees))
    return torch.stack(list(trees))


def add_lane_axis(tree: Any) -> Any:
    """One sequence as a batch of one lane (views, no copy)."""
    return map_tree(lambda x: x.unsqueeze(0), tree)


def drop_lane_axis(tree: Any) -> Any:
    """The only lane of a batch of one (views, no copy)."""
    return map_tree(lambda x: x[0], tree)


def lane(tree: Any, b: int) -> Any:
    """Lane ``b`` of a batched tree (views)."""
    return map_tree(lambda x: x[b], tree)


def where_lanes(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per lane, the tree ``a`` where ``mask`` (B,) holds and ``b``
    elsewhere: ``lax.cond`` under ``vmap``."""
    if a is None:
        return None
    if hasattr(a, "_fields"):
        return type(a)(*(where_lanes(mask, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return tuple(where_lanes(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per lane ``x[b, idx[b]]`` along dim 1: ``x`` (B, N, ...), ``idx``
    (B, M) -> (B, M, ...)."""
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.dim() - 2)), dim=1)


def at_slot(x: torch.Tensor, slot: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Per lane the entry ``slot[b]`` (B,) of ``x`` along ``dim``, that axis
    dropped; ``slot`` must lie in range."""
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    idx = slot.reshape(shape).expand(*x.shape[:dim], 1, *x.shape[dim + 1 :])
    return torch.gather(x, dim, idx).squeeze(dim)


def scatter_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Per lane ``x[b].at[idx[b]].set(val[b], mode="drop")`` for ``x``
    (B, N, ...) and indices in [0, N]: index N lands in a dump row that is
    sliced off.  ``val`` is a scalar or broadcasts to (B, M, ...)."""
    B, M = idx.shape
    pad = torch.cat([x, x[:, :1]], dim=1)
    shape = (B, M) + x.shape[2:]
    val = val.to(x.dtype).expand(shape) if torch.is_tensor(val) else x.new_full(shape, val)
    lanes = torch.arange(B, device=x.device)[:, None].expand(B, M)
    return pad.index_put((lanes, idx.long()), val)[:, :-1]


def count_into(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Per lane ``zeros(n).at[idx[b]].add(1, mode="drop")`` for ``idx``
    (B, M) in [0, n]: one flat ``b * (n + 1) + idx`` index."""
    B = idx.shape[0]
    flat = (torch.arange(B, device=idx.device)[:, None] * (n + 1) + idx.long()).reshape(-1)
    out = torch.zeros(B * (n + 1), dtype=torch.int32, device=idx.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.reshape(B, n + 1)[:, :n]


def lane_index(B: int, N: int, device) -> torch.Tensor:
    """int32 (B*N,) lane of each feature when (B, N) features are flattened
    lane-major into one feature axis: ``arange(B).repeat_interleave(N)``."""
    return torch.div(torch.arange(B * N, device=device), N, rounding_mode="floor").to(torch.int32)
