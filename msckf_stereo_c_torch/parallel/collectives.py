"""The ``torch.distributed`` plumbing of the port's sharded solvers: what
``shard_map`` over a ``Mesh`` and ``psum`` give the JAX package.

A solver's rank holds one block of the sharded axis (landmarks, edges) and
the replicated poses; each iteration sums its normal equations over the
group's ranks with one ``all_reduce`` and solves the pose system locally.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def resolve_group(group=None) -> Tuple[object, int, int]:
    """(group, world size, rank).  ``group=None`` names the default group
    when a process group is initialised; with none initialised it is the
    one-process case ``(None, 1, 0)``."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        group = dist.group.WORLD
    return group, dist.get_world_size(group), dist.get_rank(group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """Each tensor summed over the group's ranks, by one ``all_reduce`` of
    their flat concatenation; the tensors themselves when ``group`` is
    None."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def block(n: int, world: int, rank: int) -> Tuple[int, int, int]:
    """(start, stop, block size) of ``rank``'s contiguous block when ``n``
    items are padded to a multiple of ``world``: the rows ``P(axis)`` gives
    one device.  Rows at ``n`` and beyond are padding."""
    size = -(-n // world)
    return rank * size, (rank + 1) * size, size
