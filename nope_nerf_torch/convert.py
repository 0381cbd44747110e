"""Parameter trees between the JAX package's numpy form and the port's tensors.

Both packages keep the same groups ("nerf", "pose", "focal", "distortion"),
the same names and the same (in, out) weight layout, so a conversion only
changes the array type; values are copied exactly, dtypes kept. A tree is a
nested dict whose leaves are arrays (0-d arrays included, e.g. focal "fx").
`state_from_numpy` and `state_to_numpy` carry a whole train state across, Adam
moments included, so that a run can start from the same state in both
packages and a state trained by the port can be handed back. A single group
outside a train state (the test-time pose parameters of
evaluation/pose_opt.py) goes through `tree_from_numpy` / `tree_to_numpy`.

The frozen networks of scene preparation and evaluation carry across too:
`dpt_params_from_jax` / `dpt_params_to_jax` change the DPT layouts (the JAX
package keeps convs HWIO and linears (in, out), torch OIHW and (out, in)),
and `lpips_params_from_jax` checks an LPIPS tree, OIHW in both packages.
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


def tree_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """A nested dict of numpy arrays -> the same dict of torch tensors on `device`."""
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev))


def tree_to_numpy(tree: Tree) -> Tree:
    """A nested dict of torch tensors -> numpy arrays on the host."""
    return _map(tree, lambda t: t.detach().cpu().numpy())


def params_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """{group: {name: numpy array}} (a JAX state's params on the host) ->
    the same tree of torch tensors on `device`."""
    _check_groups(tree)
    return tree_from_numpy(tree, device)


def params_to_numpy(tree: Tree) -> Tree:
    """The port's tensor tree -> numpy arrays (host), the JAX package's form."""
    _check_groups(tree)
    return tree_to_numpy(tree)


def state_from_numpy(params: Tree, opt_state: Dict[str, Dict[str, Any]], it: int = -1,
                     seed: int = 0, device: DeviceLike = None):
    """A JAX TrainState on the host -> the port's TrainState on `device`.

    `params` is TrainState.params as numpy; `opt_state[group]` holds the
    fields of that group's optax ScaleByAdamState as {"mu": tree, "nu": tree,
    "count": int}. The JAX key does not convert: the port's generator is
    seeded with `seed`."""
    from .training.state import AdamState, TrainState
    dev = resolve_device(device)
    tensors = params_from_numpy(params, dev)
    if set(opt_state) != set(tensors):
        raise ValueError(f"optimizer groups {sorted(opt_state)} do not match the "
                         f"parameter groups {sorted(tensors)}")
    opt = {g: AdamState(mu=tree_from_numpy(o["mu"], dev), nu=tree_from_numpy(o["nu"], dev),
                        count=int(o["count"]))
           for g, o in opt_state.items()}
    return TrainState(params=tensors, opt_state=opt, it=int(it),
                      generator=torch.Generator(device=dev).manual_seed(seed))


def state_to_numpy(state):
    """The port's TrainState -> (params, opt_state, it) on the host, the
    arguments of state_from_numpy: params as numpy, opt_state[group] =
    {"mu": tree, "nu": tree, "count": int}. The generator does not convert."""
    opt = {g: {"mu": tree_to_numpy(o.mu), "nu": tree_to_numpy(o.nu), "count": int(o.count)}
           for g, o in state.opt_state.items()}
    return params_to_numpy(state.params), opt, int(state.it)


def dpt_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DPT params (numpy, convert_torch_state_dict's layouts)
    -> a state dict for models/dpt.py::DPT: 4-d weights HWIO -> OIHW, 2-d
    weights (in, out) -> (out, in), everything else as it is. Values are
    copied exactly."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.endswith(".weight") and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif k.endswith(".weight") and v.ndim == 2:
            v = v.T
        out[k] = torch.from_numpy(np.array(v, order="C"))
    return out


def dpt_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of dpt_params_from_jax: OIHW -> HWIO, (out, in) -> (in, out)."""
    out = {}
    for k, v in state_dict.items():
        v = v.detach().cpu().numpy()
        if k.endswith(".weight") and v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif k.endswith(".weight") and v.ndim == 2:
            v = v.T
        out[k] = np.ascontiguousarray(v)
    return out


def lpips_params_from_jax(params: Dict[str, Any], device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params (VGG16 `features.<i>` OIHW convs and
    `lin<k>.weight` heads, the layout of both packages) -> float32 tensors on
    `device`, after evaluation/lpips.py's key and size checks."""
    from .evaluation.lpips import _validate
    dev = resolve_device(device)
    out = {k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in params.items()}
    _validate(out)
    return out
