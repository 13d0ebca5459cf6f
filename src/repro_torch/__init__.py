"""PyTorch/CUDA port of the RAELLA reproduction (``src/repro`` is the JAX
reference it is held against).

The package mirrors the reference layout (``configs core quant kernels
models serve launch``), imports ``torch`` and numpy only, and runs its entry
points on the CUDA card unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA where there is none raises — the port never
    carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA card by "
            "default; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev
