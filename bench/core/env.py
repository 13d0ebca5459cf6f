"""Where a run keeps its caches, and what it must not have loaded.

Every build and kernel cache lives at a fixed path inside the checkout
(``build/``, which git ignores): the port builds its CUDA kernels into
``build/kernels`` by itself, and the variables below send any other
toolchain cache there too, so only a cell's first run in a checkout builds
and compiles, and two checkouts share nothing.
"""

from __future__ import annotations

import os
import sys

from bench.core.spec import ROOT

# top-level module names that the process printing a result may not hold:
# the JAX package, JAX itself, and the JAX package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def prepare() -> None:
    """Point the toolchains' caches into the checkout and put the port's
    package on the path. Libraries that would load JAX by themselves are
    told not to."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has imported), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))
