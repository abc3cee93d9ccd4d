"""State checkpointing for the port's NamedTuple states (port of
``msckf_stereo_c_tpu/io/checkpoint.py``).

A state (``VioState``, ``FilterState``, a batched state, any tree of
NamedTuples, tuples and tensors) is stored as one ``.npz`` with one array
per leaf.  A leaf's key is the path to it, field names and tuple
indices joined by ``/`` (``filt/imu/q``, ``pyr0_prev/2``), exactly the JAX
package's keys, and ``None`` stores nothing, as in a JAX tree.  So a
checkpoint written by either package loads into the other; ``convert.py``
carries a state across in memory, this module through a file.
"""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch

from ..utils.lanes import map_tree


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, tensor) of every tensor of ``tree``, in its order."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for name, child in zip(tree._fields, tree):
            yield from _leaves(child, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def save_state(path: str, state: Any) -> None:
    """Write every tensor of ``state`` to the ``.npz`` file ``path``."""
    np.savez_compressed(path, **{key: leaf.detach().cpu().numpy() for key, leaf in _leaves(state)})


def load_state(path: str, template: Any) -> Any:
    """The state saved at ``path``, in ``template``'s structure: each leaf
    takes the template leaf's dtype and device; a missing leaf raises
    ``KeyError`` and a shape that differs from the template's ``ValueError``."""
    out = []
    with np.load(path) as data:
        for key, leaf in _leaves(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key!r} shape {arr.shape} != template {tuple(leaf.shape)}")
            out.append(torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype))
    values = iter(out)  # map_tree visits the tensors in _leaves' order
    return map_tree(lambda _: next(values), template)
