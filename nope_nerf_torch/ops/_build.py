"""Builds the port's CUDA sources (`nope_nerf_torch/csrc/*.cu`) at first use.

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, which the wrapper loads with ctypes (no PyTorch headers, so
a build takes seconds). Libraries go to `build/torch_kernels/` at the root of
the checkout, named by a hash of the source and the flags, so an unchanged
source is built once.

Nothing here runs on import: the CPU tests import every module of the package
and have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA home PyTorch's extension builder finds."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


class CudaLibrary:
    """One CUDA source file -> one shared library, built and loaded once.

    `setup(lib)` declares the ctypes signatures after loading. `launches` is
    the kernel wrappers' launch count: each wrapper adds one where it launches
    its kernel, and nowhere else. `build_log` is nvcc's output (ptxas usage)."""

    def __init__(self, source: str, setup):
        self.source = CSRC_DIR / source
        self._setup = setup
        self._lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.build_log = ""

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._lib is not None:
            return self._lib
        nvcc = find_nvcc()
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
        target = BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"
        log = target.with_suffix(".log")
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build under a per-process name, then rename: concurrent test
            # processes never load a half-written library
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n{proc.stdout}")
            log.write_text(proc.stdout)
            os.replace(tmp, target)
        self.build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(target))
        self._setup(lib)
        self._lib = lib
        return lib
