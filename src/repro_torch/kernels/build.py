"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher that takes device
pointers and PyTorch's current stream as ``void*`` and returns the launch's
``cudaError_t``. It compiles into ``build/kernels/lib<name>-<hash>.so`` at
the repository root — the hash covers the source, the local headers it
includes (``csrc/bitplane_gemm.cuh``) and the flags, so an edited source or
header rebuilds — at the kernel's first use, or ahead of time through
:func:`build` (``chip_smoke.py`` starts one ``nvcc`` per source at once).
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
LOGS: dict[str, str] = {}  # compiler output per kernel built by this process


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    for cand in (os.environ.get("CUDA_HOME"), None, "/usr/local/cuda"):
        path = shutil.which("nvcc") if cand is None \
            else os.path.join(cand, "bin", "nvcc")
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes (``#include
    "..."`` found under ``csrc/``), recursively, each once, in the order
    first reached."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """``build/kernels/lib<name>-<hash>.so``: the hash covers the source,
    the local headers it includes and the flags, so editing any of them
    rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per kernel built (0.0
    for one already built); raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, lib)
    seconds = dict.fromkeys(names, 0.0)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        LOGS[name] = log.decode()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{LOGS[name]}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


class CudaKernel:
    """One hand-written kernel's C launcher, loaded at first use, and its
    launch count (bumped by the wrapper right after each launch)."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self.launches = 0
        self._lib = self._fn = self._err = None

    def _load(self):
        if self._fn is None:
            build([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C launcher on PyTorch's current stream; raise if the
        launch was refused."""
        fn = self._load()
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            msg = self._err(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({err})")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_operand(t: torch.Tensor, name: str, dtype, ndim: int, dev) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``dev`` — what a C launcher reading raw pointers needs."""
    if t.device != dev or t.dtype != dtype or t.ndim != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {dev}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
