"""RaellaLinear: a linear layer executed with RAELLA's arithmetic.

Port of ``repro.core.pim_linear``. Modes:

  exact — bit-exact simulation of the accelerator datapath (Center+Offset,
          sliced 512-row crossbars, the ADC): with speculation and
          recovery (kernel K2), or with static input slicing when the plan
          has speculation off (kernel K1). Signed inputs run as two
          unsigned passes (paper §5.1).
  int8  — ``forward_int_reference``: the ideal 8b-quantized layer that
          ``exact`` equals bit for bit at a non-saturating ADC.
  fast  — the centered int8 matmul plus the rank-1 center term (Eq. 1 —
          kernel K3).

A plan with a nonideal device, or a nonzero ADC noise level, raises
``NotImplementedError``: neither is ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.core import center_offset as co
from repro_torch.core import crossbar as xbar
from repro_torch.core import slicing as sl
from repro_torch.core import speculation as spec
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import _int_matmul
from repro_torch.quant import quantize as q


@dataclasses.dataclass
class PimPlan:
    """Compile-time artifact for one layer (the programmed crossbar state)."""
    enc: co.EncodedWeights | None   # Center+Offset encoded weight slices
    lq: q.LayerQuant                # quantization parameters
    w_q: torch.Tensor               # int8 weights (rows, cols)
    adc: adc_lib.ADCConfig
    speculation: bool
    spec_slicing: tuple[int, ...] = spec.SPEC_SLICING
    # None: per-site compiled plans (enc carries the shifts)
    weight_slicing: tuple[int, ...] | None = None
    encode_mode: str = "center"     # "center" | "zero" (differential baseline)
    # analog array model: only the ideal integer read (None / IdealSim)
    device: bk.CrossbarBackend | None = None
    fast_w_off: torch.Tensor | None = None    # int8 offsets (rows, cols)
    fast_centers: torch.Tensor | None = None  # int32 per-column centers
    fast_scale: torch.Tensor | None = None    # fp32 per-column scale


def prepare(w: torch.Tensor, x_cal: torch.Tensor, *,
            weight_slicing: Sequence[int] = (4, 2, 2),
            adc: adc_lib.ADCConfig = adc_lib.RAELLA_ADC,
            speculation: bool = True,
            encode_mode: str = "center",
            bias: torch.Tensor | None = None,
            relu_out: bool = False,
            signed_inputs: bool | None = None) -> PimPlan:
    """Quantize + Center+Offset encode + slice a layer's weights."""
    lq, w_q = q.calibrate_layer(w, x_cal, bias=bias, relu_out=relu_out,
                                signed_inputs=signed_inputs)
    enc = co.encode(w_q.to(torch.int64) + 128, weight_slicing,
                    mode=encode_mode)
    w_off, centers, fscale = q.quantize_weights_centered(w)
    return PimPlan(enc=enc, lq=lq, w_q=w_q, adc=adc, speculation=speculation,
                   weight_slicing=tuple(weight_slicing),
                   encode_mode=encode_mode, fast_w_off=w_off,
                   fast_centers=centers, fast_scale=fscale)


def _unsigned_passes(x_q: torch.Tensor,
                     signed: bool) -> list[tuple[int, torch.Tensor]]:
    """Signed inputs -> (sign, unsigned codes) passes; unsigned -> one."""
    if not signed:
        return [(1, x_q)]
    return [(1, x_q.clamp_min(0)), (-1, (-x_q).clamp_min(0))]


def _accumulate_int(x_q: torch.Tensor, plan: PimPlan, *,
                    input_slicing: Sequence[int] | None = None,
                    backend: str | None = None
                    ) -> tuple[torch.Tensor, list]:
    """x_q (B, rows) int codes -> x_q @ w_q int32 via the crossbar: the
    speculation pass (K2) or, with speculation off, the static-slicing
    pass (K1) at ``input_slicing`` (default 1b slices)."""
    if plan.device is not None and not isinstance(plan.device, bk.IdealSim):
        raise NotImplementedError(
            "nonideal crossbar devices are not ported yet (ROADMAP)")
    stats = []
    acc = torch.zeros((x_q.shape[0], plan.enc.cols), dtype=torch.int32,
                      device=x_q.device)
    in_sl = (1,) * sl.INPUT_BITS if input_slicing is None else input_slicing
    for sign, xp in _unsigned_passes(x_q, plan.lq.x_signed):
        if plan.speculation:
            psum, st = spec.forward(xp, plan.enc, plan.spec_slicing,
                                    plan.adc, backend=backend)
        else:
            psum, st = xbar.forward(xp, plan.enc, in_sl, plan.adc,
                                    backend=backend, device=plan.device)
        acc = acc + sign * psum
        stats.append(st)
    # unsigned-weight-domain -> signed int8 weight domain: w_q = w_u - 128
    x_sum = x_q.to(torch.int64).sum(dim=-1, keepdim=True).to(torch.int32)
    return acc - 128 * x_sum, stats


def quantize_inputs(x: torch.Tensor, plan: PimPlan) -> torch.Tensor:
    """Float inputs -> int32 codes at the layer's calibrated scale."""
    lo, hi = (-127, 127) if plan.lq.x_signed else (0, 255)
    return torch.round(x / plan.lq.x_scale).clamp(lo, hi).to(torch.int32)


def forward_exact(x: torch.Tensor, plan: PimPlan, *,
                  input_slicing: Sequence[int] | None = None,
                  noise_level: float = 0.0,
                  backend: str | None = None,
                  return_stats: bool = False):
    """Float-in / float-out exact accelerator simulation. ``input_slicing``
    applies with speculation off (default 1b slices)."""
    if noise_level:
        raise NotImplementedError(
            "ADC noise is not ported yet (ROADMAP); noise_level must be 0")
    y_int, stats = _accumulate_int(quantize_inputs(x, plan), plan,
                                   input_slicing=input_slicing,
                                   backend=backend)
    y = q.dequantize(y_int, plan.lq)
    if return_stats:
        return y, stats
    return y


def forward_int_reference(x: torch.Tensor, plan: PimPlan) -> torch.Tensor:
    """Ideal 8b-quantized layer (no fidelity loss) — the paper's
    'expected'. An exact float64 product: CUDA has no integer matmul."""
    y_int = _int_matmul(quantize_inputs(x, plan), plan.w_q).to(torch.int32)
    return q.dequantize(y_int, plan.lq)


def forward_fast(x: torch.Tensor, plan: PimPlan) -> torch.Tensor:
    """Centered-int8 path (no ADC model — deployment arithmetic):

        y = s_x * s_w ⊙ ( x_q @ W_off  +  sum(x_q) ⊗ phi )
    """
    if plan.lq.x_signed:
        x_q = torch.round(x / plan.lq.x_scale).clamp(-127, 127).to(torch.int8)
        shift = 0
    else:
        # shift unsigned codes to the signed domain: u - 128 in [-128, 127]
        x_q = (torch.round(x / plan.lq.x_scale).clamp(0, 255) - 128).to(
            torch.int8)
        shift = 128
    y_int = kops.centered_int8_matmul(x_q, plan.fast_w_off, plan.fast_centers)
    if shift:
        # undo the input shift: u @ W = (u-128) @ W + 128 * colsum(W_off + phi)
        w_col = (plan.fast_w_off.to(torch.int64).sum(dim=0)
                 + plan.fast_w_off.shape[0]
                 * plan.fast_centers.to(torch.int64))
        y_int = y_int + shift * w_col.to(torch.int32)[None, :]
    y = plan.fast_scale[None, :] * plan.lq.x_scale * y_int.to(torch.float32)
    if plan.lq.bias is not None:
        y = y + plan.lq.bias[None, :]
    return y


def output_codes(y: torch.Tensor, plan: PimPlan,
                 relu: bool = False) -> torch.Tensor:
    """8b requantized output codes (what flows between PIM tiles)."""
    return q.requantize_outputs(y, plan.lq, relu=relu)
