"""ADC model (paper §3, §4.3, §7.2), noiseless.

RAELLA's ADC captures the 7 least-significant bits of a signed column sum
with a step size of one sliced-product LSB: in-range sums are converted with
perfect fidelity; out-of-range sums saturate at [-64, 63]. Saturation at
either bound is detectable (the speculation-failure signal). Port of
``repro.core.adc`` without the analog noise model.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    bits: int = 7
    signed: bool = True
    # Offset of the conversion window. The crossbar padding contract —
    # zero-padded rows / slice planes are numerically inert — requires a
    # window containing 0 (``check_zero_preserving``).
    zero_point: int = 0

    @property
    def lo(self) -> int:
        base = -(1 << (self.bits - 1)) if self.signed else 0
        return base + self.zero_point

    @property
    def hi(self) -> int:
        base = (1 << (self.bits - 1)) - 1 if self.signed \
            else (1 << self.bits) - 1
        return base + self.zero_point

    @property
    def zero_preserving(self) -> bool:
        """Does this ADC map an analog 0 to digital 0?"""
        return self.lo <= 0 <= self.hi


RAELLA_ADC = ADCConfig(bits=7, signed=True)      # [-64, 63]


def check_zero_preserving(cfg: ADCConfig) -> None:
    """Refuse an ADC whose window excludes 0: zero-padded crossbar rows and
    slice planes would then convert to a non-zero code."""
    if not cfg.zero_preserving:
        raise ValueError(
            f"ADC window [{cfg.lo}, {cfg.hi}] (bits={cfg.bits}, "
            f"signed={cfg.signed}, zero_point={cfg.zero_point}) does not "
            "contain 0: zero-padded crossbar rows/planes would convert to "
            f"{min(max(0, cfg.lo), cfg.hi)}, breaking the padding contract")


def convert(col_sum: torch.Tensor,
            cfg: ADCConfig = RAELLA_ADC) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert integer column sums to digital codes. Returns (value,
    saturated): int32 clipped to [cfg.lo, cfg.hi], and whether the output
    sits on either bound (the paper's detection rule)."""
    check_zero_preserving(cfg)
    out = col_sum.to(torch.int32).clamp(cfg.lo, cfg.hi)
    saturated = (out == cfg.lo) | (out == cfg.hi)
    return out, saturated
