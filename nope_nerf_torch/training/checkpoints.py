"""Checkpoint save/load in the JAX package's file format.

Port of nope_nerf_tpu/training/checkpoints.py. A checkpoint is one pickle of
{"params", "opt_state", "it", "rng", "scalars", "format_version"} with numpy
leaves. The port writes the params only (its Adam state is carried between
the packages by convert.state_from_numpy; saving it comes with the train
CLI's resume) and reads the params of any checkpoint, including those
written by `nope_nerf_tpu`, whose "opt_state" pickles optax classes: the
loader stubs every class of optax, jax, jaxlib and chex instead of importing
them, and refuses classes from any module it does not know.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import DeviceLike
from ..convert import params_from_numpy, params_to_numpy

FORMAT_VERSION = 1
_STUBBED = ("optax", "jax", "jaxlib", "chex")
_ALLOWED = ("numpy", "collections", "copyreg", "_codecs")
_ALLOWED_BUILTINS = {"set", "frozenset", "slice", "range", "complex", "bytearray",
                     "list", "dict", "tuple", "int", "float", "bool", "str", "bytes"}


class _Stub:
    """Stand-in for a class of a module the port does not import (optax
    optimizer states and the like): takes any constructor arguments and state."""

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
            return _Stub
        if root in _ALLOWED or (module == "builtins" and name in _ALLOWED_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, "
                                     "which the loader does not accept")


def save_checkpoint(out_dir: str, filename: str, params: Dict[str, Any],
                    scalars: Optional[Dict[str, Any]] = None, it: int = 0) -> str:
    """Atomically write `params` ({group: {name: tensor}}) in the JAX
    package's payload format (no optimizer state). Returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {
        "params": params_to_numpy(params),
        "opt_state": {},
        "it": int(it),
        "rng": np.zeros((2,), np.uint32),
        "scalars": scalars or {},
        "format_version": FORMAT_VERSION,
    }
    path = os.path.join(out_dir, filename)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def load_checkpoint(out_dir: str, filename: str, device: DeviceLike = None
                    ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(params on `device`, scalars) from a checkpoint of either package, or
    None when the file does not exist (a fresh start)."""
    path = os.path.join(out_dir, filename)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    return params_from_numpy(payload["params"], device), payload.get("scalars", {})
