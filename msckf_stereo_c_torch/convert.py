"""State carried across between the JAX package and the port.

The port has no learned weights: its parameters are the calibration
constants (``FrontendParams``, ``MsckfParams``), the tracker and filter
state (``VioState``) and the back end's problems (``BAProblem``,
``PoseGraph``).  Both packages use NamedTuples with the same class and
field names, so a state converts field by field: ``vio_state_from_numpy``
takes the JAX package's structures as numpy trees (``jax.device_get`` of
them) and builds the port's, and ``vio_state_to_numpy`` turns the port's
back into numpy trees of the port's classes.  Batched states (every array
with a leading lane axis B) convert the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.frontend import FrameOutput, FrontendParams, TrackerState
from .models.msckf import FrameFeatures, MsckfParams, PoseOutput
from .models.propagation import ImuBatch
from .models.state import CamStates, FilterState, ImuState, TrackMap
from .models.vio import VioState
from .parallel.ba import BAProblem
from .parallel.posegraph import PoseGraph

_CLASSES = {
    cls.__name__: cls
    for cls in (
        VioState, TrackerState, FilterState, ImuState, CamStates, TrackMap,
        FrontendParams, MsckfParams, ImuBatch, FrameFeatures, FrameOutput, PoseOutput,
        BAProblem, PoseGraph,
    )
}


def from_numpy(tree: Any, device=None) -> Any:
    """Numpy tree (NamedTuples matched by class name, tuples, arrays,
    scalars, None) -> the port's NamedTuples of tensors on ``device``."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        name = type(tree).__name__
        if name not in _CLASSES:
            raise TypeError(f"no port counterpart for {name}")
        cls = _CLASSES[name]
        if tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"{name}: fields {tree._fields} differ from the port's {cls._fields}")
        return cls(*(from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same NamedTuples of numpy arrays."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def vio_state_from_numpy(state, fparams=None, mparams=None, device=None):
    """(VioState, FrontendParams, MsckfParams) of the port from the JAX
    package's, given as numpy trees (``None`` stays ``None``).  A batched
    state, a tree whose arrays carry a leading lane axis B (``jax.vmap``'s
    layout), becomes the port's batched state."""
    return from_numpy(state, device), from_numpy(fparams, device), from_numpy(mparams, device)


def vio_state_to_numpy(state: VioState, fparams: FrontendParams = None, mparams: MsckfParams = None):
    """Inverse of ``vio_state_from_numpy``: numpy trees of the port's
    structures (``None`` stays ``None``), a batched state with its leading
    lane axis."""
    return to_numpy(state), to_numpy(fparams), to_numpy(mparams)
