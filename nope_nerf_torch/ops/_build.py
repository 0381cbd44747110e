"""Builds the port's CUDA sources (`nope_nerf_torch/csrc/*.cu`) at first use.

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, which the wrapper loads with ctypes (no PyTorch headers, so
a build takes seconds, half a minute for the train kernel). Libraries go to `build/torch_kernels/` at the root of
the checkout, named by a hash of the source, the headers and the flags, so an
unchanged source is built once.

Nothing here runs on import: the CPU tests import every module of the package
and have no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


_PLAIN_VERSIONS = False

# Every CudaLibrary of the package, in the order the ops modules create them: a
# captured CUDA graph reads their launch counts (training/graphs.py).
LIBRARIES: List["CudaLibrary"] = []


@contextlib.contextmanager
def plain_versions():
    """Within the block every kernel wrapper runs its kernel's plain PyTorch
    version, whatever device its tensors lie on, and launches nothing. It
    exists for checks that hold a path through the kernels against the same
    path through their plain versions. A wrapper reads the switch when it is
    called, so a backward pass follows the route its forward took, also after
    the block has ended."""
    global _PLAIN_VERSIONS
    previous, _PLAIN_VERSIONS = _PLAIN_VERSIONS, True
    try:
        yield
    finally:
        _PLAIN_VERSIONS = previous


def runs_plain(t) -> bool:
    """Whether a wrapper given tensor `t` runs its plain version: `t` lies on
    the CPU, or the call is inside plain_versions()."""
    return t.device.type == "cpu" or _PLAIN_VERSIONS


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
    its kernel, and nowhere else; a replayed CUDA graph adds the launches its
    capture recorded (training/graphs.py). `build_log` is nvcc's output
    (ptxas usage)."""

    def __init__(self, source: str, setup):
        self.source = CSRC_DIR / source    # an absolute path stands as it is
        self._setup = setup
        self._lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.build_log = ""
        LIBRARIES.append(self)

    def _target(self, nvcc: str) -> Path:
        """The library's path, named by a hash of the source, of every header
        beside it (a source may include any of them) and of the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc if the library is not built yet; `lib()` waits for it."""
        nvcc = find_nvcc()
        target = self._target(nvcc)
        if self._lib is not None or target.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a per-process name, then rename: concurrent test
        # processes never load a half-written library
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        return subprocess.Popen([nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp),
                                 str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def lib(self, build: Optional[subprocess.Popen] = None) -> ctypes.CDLL:
        """The loaded library, built first if needed (`build`: a build already
        started by start_build)."""
        if self._lib is not None:
            return self._lib
        target = self._target(find_nvcc())
        log = target.with_suffix(".log")
        proc = build if build is not None else self.start_build()
        if proc is not None:
            out, _ = proc.communicate()
            tmp = Path(proc.args[-2])
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
            log.write_text(out)
            os.replace(tmp, target)
        self.build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(target))
        self._setup(lib)
        self._lib = lib
        return lib


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build and load several libraries, their nvcc runs side by side (each
    uses one core; the largest source takes about half a minute). A failed
    build raises here, after the other runs have been stopped."""
    builds = [(library, library.start_build()) for library in libraries]
    try:
        for library, proc in builds:
            library.lib(proc)
    finally:
        for _, proc in builds:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
