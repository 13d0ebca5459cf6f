"""8b per-channel linear quantization (paper §2.1, [82]-style).

Port of ``repro.quant.quantize``. Every formula keeps the reference's
float32 operation order, and ``torch.round`` rounds half to even as
``jnp.round`` does, so codes and scales match the reference bit for bit on
identical float inputs.

Weight convention on-crossbar: unsigned 8b domain w_u = w_q + 128 (the +128
folds into the digital center term — see core.center_offset). Signed inputs
are processed as two unsigned passes max(x,0) / max(-x,0) per the paper.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """All quantization parameters of one linear layer y = x @ w + b."""
    w_scale: torch.Tensor          # (cols,) fp32 — per-output-channel
    x_scale: torch.Tensor          # scalar fp32
    x_zero_point: int              # 0 for both calibrate_layer branches
    x_signed: bool
    out_scale: torch.Tensor        # scalar fp32 — 8b output requant scale
    out_zero_point: int
    bias: torch.Tensor | None      # (cols,) fp32 or None


def quantize_weights_per_channel(
        w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (rows, cols) fp -> (w_q int8 symmetric per-col, scale (cols,))."""
    absmax = w.abs().amax(dim=0)
    scale = absmax.clamp_min(1e-12) / 127.0
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return w_q, scale.to(torch.float32)


def quantize_weights_centered(
        w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Center+Offset quantization in the float domain (paper Eq. 1).

    Per output channel: center = midpoint of [min, max], scale = half-range
    / 127. w (rows, cols) fp -> (w_off int8, centers int32 (cols,),
    scale (cols,)). Reconstruction: w ~= scale * (w_off + centers).
    """
    w_min = w.amin(dim=0)
    w_max = w.amax(dim=0)
    mid = 0.5 * (w_max + w_min)
    half = (0.5 * (w_max - w_min)).clamp_min(1e-12)
    scale = half / 127.0
    centers = torch.round(mid / scale).to(torch.int32)
    w_off = (torch.round(w / scale) - centers).clamp(-127, 127).to(torch.int8)
    return w_off, centers, scale.to(torch.float32)


def dequantize(y_int: torch.Tensor, lq: LayerQuant,
               w_col_sum: torch.Tensor | None = None) -> torch.Tensor:
    """int32 accumulator (x_q @ w_q algebra) -> float psum.

      y = s_w * s_x * (y_int - zp_x * w_col_sum)

    ``w_col_sum`` (cols,) — the per-column sum of the int8 weights — is
    needed only for a non-zero input zero point; with zp 0 the reference's
    correction subtracts an exact 0.0, so skipping it changes no bit.
    """
    corrected = y_int.to(torch.float32)
    if lq.x_zero_point:
        corrected = corrected - float(lq.x_zero_point) \
            * w_col_sum.to(torch.float32)
    y = lq.w_scale[None, :] * lq.x_scale * corrected
    if lq.bias is not None:
        y = y + lq.bias[None, :]
    return y


def requantize_outputs(y: torch.Tensor, lq: LayerQuant,
                       relu: bool = False) -> torch.Tensor:
    """float psum -> 8b output codes (activation folded in, paper [82])."""
    if relu:
        y = y.clamp_min(0.0)
    q = torch.round(y / lq.out_scale) + lq.out_zero_point
    lo, hi = (0, 255) if relu else (-128, 127)
    return q.clamp(lo, hi).to(torch.int32)


def calibrate_layer(w: torch.Tensor, x_cal: torch.Tensor, *,
                    signed_inputs: bool | None = None,
                    bias: torch.Tensor | None = None,
                    relu_out: bool = False) -> tuple[LayerQuant, torch.Tensor]:
    """Build LayerQuant from float weights + calibration activations.

    Returns (LayerQuant, w_q int8). The output scale is calibrated from the
    float reference output range on the calibration batch.
    """
    w_q, w_scale = quantize_weights_per_channel(w)
    if signed_inputs is None:
        signed_inputs = bool((x_cal < 0).any())
    if signed_inputs:
        x_scale = x_cal.abs().amax() / 127.0
    else:
        x_scale = x_cal.amax() / 255.0
    x_scale = x_scale.clamp_min(1e-12).to(torch.float32)
    y_ref = x_cal @ w
    if bias is not None:
        y_ref = y_ref + bias
    if relu_out:
        y_ref = y_ref.clamp_min(0.0)
        out_scale = y_ref.amax().clamp_min(1e-12) / 255.0
    else:
        out_scale = y_ref.abs().amax().clamp_min(1e-12) / 127.0
    lq = LayerQuant(
        w_scale=w_scale, x_scale=x_scale, x_zero_point=0,
        x_signed=bool(signed_inputs), out_scale=out_scale.to(torch.float32),
        out_zero_point=0, bias=bias)
    return lq, w_q
