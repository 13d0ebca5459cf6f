"""Gradient compression for a slow reduction axis: int8 + error feedback.

Port of ``repro.train.compression``. Gradients are compressed to int8
with one float32 scale per ``CHUNK`` values before they cross the axis,
and the quantization residual is kept in an *error-feedback* buffer added
to the next step's gradient (the 1-bit Adam / EF21 family), so the
compression does not bias the sum over steps.

``compressed_psum`` reduces over one mesh axis's process group
(``DeviceMesh.get_group(axis)``): the int8 codes cross it as an int32 sum
and the scales as a float32 sum divided by the group's size (gloo has no
``AVG``); the mean is dequantized from ``q_sum / n`` in float32, as the
reference's ``jnp`` divides an int32 sum by an int. The arithmetic is the
reference's cast for cast, so ``quantize_int8`` and ``compress_decompress``
equal it bit for bit. The reference's train loop does not call
``compressed_psum`` and its config has no switch for it; neither has the
port's.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.train import _tree

CHUNK = 1024  # scale granularity (per-chunk absmax)


def _on(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 scalar tensor on ``like``'s device. CUDA divides
    by a host scalar through its reciprocal, which rounds differently from
    the true division of the CPU and of the reference; by a device tensor
    it divides truly. (A fill, not a host-to-device copy.)"""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes (n_chunks, CHUNK), float32 scales
    (n_chunks, 1)): absmax / 127 per chunk floored at 1e-12, codes rounded
    half to even and clipped to +-127; the tail chunk is zero-padded."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % CHUNK))
    chunks = flat.reshape(-1, CHUNK).to(torch.float32)
    scale = torch.amax(torch.abs(chunks), dim=1, keepdim=True) / _on(127, x)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """Codes times their chunk's scale in float32, cut to ``shape`` and
    cast to ``dtype``."""
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compress_decompress(x: torch.Tensor, err: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One EF round locally: returns (decompressed, new_error).

    decompressed = Q(x + err); new_error = (x + err) - decompressed.
    """
    target = x if err is None else x + err.to(x.dtype)
    q, s = quantize_int8(target)
    deq = dequantize_int8(q, s, x.shape, x.dtype)
    return deq, (target.to(torch.float32)
                 - deq.to(torch.float32)).to(x.dtype)


def _one(g: torch.Tensor, e: torch.Tensor, group, n: int):
    import torch.distributed as dist
    target = g + e.to(g.dtype)
    q, s = quantize_int8(target)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, dist.ReduceOp.SUM, group=group)
    s_sum = s.clone()
    dist.all_reduce(s_sum, dist.ReduceOp.SUM, group=group)
    # shared scale approximation: the members' mean scale
    n_ = _on(n, g)
    deq = dequantize_int8(q_sum / n_, s_sum / n_, g.shape, g.dtype)
    new_e = (target.to(torch.float32)
             - dequantize_int8(q, s, g.shape, g.dtype).to(torch.float32)
             ).to(g.dtype)
    return deq, new_e


def compressed_psum(tree: Any, mesh, axis: str,
                    err_tree: Any | None = None) -> tuple[Any, Any]:
    """Mean-reduce a tree of this rank's tensors across mesh axis ``axis``
    with int8+EF compression; every rank of the mesh calls it.

    Each leaf is quantized (with its error-feedback carry), the int8 codes
    and scales are what cross the axis, and the dequantized mean is
    returned along with the updated error buffers.
    """
    if err_tree is None:
        err_tree = _tree.tree_map(torch.zeros_like, tree)
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]
    group = mesh.get_group(axis)
    out = [_one(g, e, group, n) for g, e in zip(
        _tree.leaves(tree), _tree.leaves(err_tree), strict=True)]
    return (_tree.unflatten(tree, [m for m, _ in out]),
            _tree.unflatten(tree, [e for _, e in out]))
