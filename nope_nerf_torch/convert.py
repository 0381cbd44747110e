"""Parameter trees between the JAX package's numpy form and the port's tensors.

Both packages keep the same groups ("nerf", "pose", "focal", "distortion"),
the same names and the same (in, out) weight layout, so a conversion only
changes the array type; values are copied exactly, dtypes kept. A tree is a
nested dict whose leaves are arrays (0-d arrays included, e.g. focal "fx").
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import DeviceLike, resolve_device

GROUPS = ("nerf", "pose", "focal", "distortion")

Tree = Dict[str, Any]


def _check_groups(tree: Tree) -> None:
    unknown = set(tree) - set(GROUPS)
    if unknown:
        raise ValueError(f"unknown parameter groups {sorted(unknown)}; "
                         f"expected a subset of {GROUPS}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """{group: {name: numpy array}} (a JAX state's params on the host) ->
    the same tree of torch tensors on `device`."""
    _check_groups(tree)
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev))


def params_to_numpy(tree: Tree) -> Tree:
    """The port's tensor tree -> numpy arrays (host), the JAX package's form."""
    _check_groups(tree)
    return _map(tree, lambda t: t.detach().cpu().numpy())
