"""Checkpoint save/load: one file for the whole TrainState and the host's
scheduler scalars, in the JAX package's file format.

Port of nope_nerf_tpu/training/checkpoints.py. A checkpoint is one pickle of
{"params", "opt_state", "it", "rng", "scalars", "format_version"} with numpy
leaves. The port writes "opt_state" as {group: {"mu", "nu", "count"}} (Adam's
moments) and "rng" as the bytes of its torch.Generator's state.

Between the packages: `nope_nerf_tpu` reads a port checkpoint with
load_model_only=True (it restores the params only). The port reads the params
of any JAX checkpoint, and its Adam moments too: "opt_state" there pickles
optax classes, which the loader stubs instead of importing (as every class of
optax, jax, jaxlib and chex; classes of modules it does not know are refused),
and a stubbed ScaleByAdamState still holds (count, mu, nu). The JAX key does
not convert: the state keeps its own generator then. In a multi-process run
save_checkpoint writes on process 0 only, as the JAX package's does.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..convert import params_from_numpy, params_to_numpy, state_to_numpy, tree_from_numpy
from ..parallel.multihost import process_index
from .state import AdamState, TrainState

FORMAT_VERSION = 1
_STUBBED = ("optax", "jax", "jaxlib", "chex")
_ALLOWED = ("numpy", "collections", "copyreg", "_codecs")
_ALLOWED_BUILTINS = {"set", "frozenset", "slice", "range", "complex", "bytearray",
                     "list", "dict", "tuple", "int", "float", "bool", "str", "bytes"}


class _Stub:
    """Stand-in for a class of a module the port does not import (optax
    optimizer states and the like): takes any constructor arguments and
    state, and keeps the arguments."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _ParamsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _STUBBED:
            return type(name, (_Stub,), {})   # named, so the loader can find Adam's state
        if root in _ALLOWED or (module == "builtins" and name in _ALLOWED_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, "
                                     "which the loader does not accept")


def _write(out_dir: str, filename: str, payload: Dict[str, Any]) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def _read(out_dir: str, filename: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(out_dir, filename)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return _ParamsUnpickler(f).load()


def save_params(out_dir: str, filename: str, params: Dict[str, Any],
                scalars: Optional[Dict[str, Any]] = None, it: int = 0) -> str:
    """Atomically write `params` ({group: {name: tensor}}) alone, without an
    optimizer state: enough for the render and eval entry points of either
    package. Returns the path."""
    return _write(out_dir, filename, {
        "params": params_to_numpy(params), "opt_state": {}, "it": int(it),
        "rng": np.zeros((2,), np.uint32), "scalars": scalars or {},
        "format_version": FORMAT_VERSION})


def load_params(out_dir: str, filename: str, device: DeviceLike = None
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(params on `device`, scalars) from a checkpoint of either package, or
    None when the file does not exist."""
    payload = _read(out_dir, filename)
    if payload is None:
        return None
    return params_from_numpy(payload["params"], device), payload.get("scalars", {})


def save_checkpoint(out_dir: str, filename: str, state: TrainState,
                    scalars: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write the whole state (params, Adam moments and counts, the
    iteration counter, the generator's state) and the scalars. Returns the path.
    In a multi-process run only process 0 writes (the state is replicated);
    every process gets the path, and a caller that restores it waits for the
    write first (torch.distributed.barrier)."""
    if process_index() != 0:
        return os.path.join(out_dir, filename)
    params, opt_state, it = state_to_numpy(state)
    return _write(out_dir, filename, {
        "params": params, "opt_state": opt_state, "it": it,
        "rng": state.generator.get_state().numpy(), "scalars": scalars or {},
        "format_version": FORMAT_VERSION})


def _adam_fields(saved) -> Optional[Dict[str, Any]]:
    """{"mu", "nu", "count"} of one group's saved optimizer state: the port's
    own dict, or the stubbed ScaleByAdamState inside a JAX checkpoint's chain."""
    if isinstance(saved, dict) and {"mu", "nu", "count"} <= set(saved):
        return saved
    if isinstance(saved, (tuple, list)):
        for item in saved:
            if (isinstance(item, _Stub) and type(item).__name__ == "ScaleByAdamState"
                    and len(item.args) == 3):
                count, mu, nu = item.args
                return {"mu": mu, "nu": nu, "count": count}
    return None


PER_CAMERA_GROUPS = ("pose", "distortion")   # tables with one row per camera


def _restore_group(template: Dict[str, torch.Tensor], saved: Dict[str, Any], dev, group: str,
                   what: str = "params"):
    """The saved arrays of one group as tensors shaped and typed like
    `template`. A per-camera table may hold another number of cameras than the
    template's (the eval CLI builds its template from the train split of the
    scene the checkpoint was trained on whole); every other shape must match."""
    if set(saved) != set(template):
        raise ValueError(f"checkpoint {group} {what} hold {sorted(saved)}, the state "
                         f"{sorted(template)}")
    out = {}
    for k, t in template.items():
        a = np.asarray(saved[k])
        free = 1 if group in PER_CAMERA_GROUPS and t.ndim else 0
        if a.ndim != t.ndim or tuple(a.shape[free:]) != tuple(t.shape[free:]):
            raise ValueError(f"checkpoint {group}/{k} has shape {a.shape}, the state "
                             f"{tuple(t.shape)}")
        out[k] = tree_from_numpy(a, dev).to(t.dtype)
    return out


def load_checkpoint(out_dir: str, filename: str, state: TrainState,
                    load_model_only: bool = False, device: DeviceLike = None
                    ) -> Optional[Tuple[TrainState, Dict[str, Any]]]:
    """Restore into the structure of `state` (groups, names and shapes must
    match) on `device` (default: where the state's params lie). Returns
    (state, scalars), or None when no checkpoint exists (a fresh start).

    load_model_only=True restores the params and keeps the optimizer state,
    the counter and the generator of `state`, with no scalars, as the JAX
    package does. Otherwise everything is restored; a checkpoint without Adam
    moments (save_params) raises then."""
    payload = _read(out_dir, filename)
    if payload is None:
        return None
    some = next(iter(next(iter(state.params.values())).values()))
    dev = some.device if device is None else resolve_device(device)
    saved = payload["params"]
    if set(saved) != set(state.params):
        raise ValueError(f"checkpoint holds the groups {sorted(saved)}, the state "
                         f"{sorted(state.params)}")
    params = {g: _restore_group(state.params[g], saved[g], dev, g) for g in state.params}
    if load_model_only:
        return TrainState(params=params, opt_state=state.opt_state, it=state.it,
                          generator=state.generator), {}

    opt_state = {}
    for g in state.params:
        fields = _adam_fields(payload.get("opt_state", {}).get(g))
        if fields is None:
            raise ValueError(f"checkpoint {filename} holds no Adam moments for group {g!r}: "
                             "it can be loaded with load_model_only=True only")
        opt_state[g] = AdamState(mu=_restore_group(state.params[g], fields["mu"], dev, g, "mu"),
                                 nu=_restore_group(state.params[g], fields["nu"], dev, g, "nu"),
                                 count=int(fields["count"]))
    generator = state.generator
    rng = np.asarray(payload["rng"])
    if rng.dtype == np.uint8:   # the port's generator state; a JAX key does not convert
        generator = torch.Generator(device=dev)
        try:
            generator.set_state(torch.from_numpy(rng.copy()))
        except RuntimeError as e:
            raise ValueError(f"checkpoint {filename} holds the random state of another device "
                             f"type than {dev.type}: resume on the device it was written on") from e
    return (TrainState(params=params, opt_state=opt_state, it=int(payload["it"]),
                       generator=generator), payload.get("scalars", {}))
