"""ADC model (paper §3, §4.3, §7.2).

RAELLA's ADC captures the 7 least-significant bits of a signed column sum
with a step size of one sliced-product LSB: in-range sums are converted with
perfect fidelity; out-of-range sums saturate at [-64, 63]. Saturation at
either bound is detectable (the speculation-failure signal). Port of
``repro.core.adc``.

The analog noise model for the Fig. 15 ablation follows the paper: the
column sum is N(mu, sigma^2) with mu = N+ - N- (ideal signed sum) and
sigma = E * sqrt(N+ + N-), where N+/N- are the positive / negative
sliced-product sums and E is the noise level. Its draws come from a key
(``core.rng``).
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
    def levels(self) -> int:
        return 1 << self.bits

    @property
    def zero_preserving(self) -> bool:
        """Does this ADC map an analog 0 to digital 0?"""
        return self.lo <= 0 <= self.hi


RAELLA_ADC = ADCConfig(bits=7, signed=True)      # [-64, 63]
ISAAC_ADC = ADCConfig(bits=8, signed=False)      # ISAAC: unsigned arithmetic


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
            cfg: ADCConfig = RAELLA_ADC,
            *,
            noise_level: float = 0.0,
            pos_sum: torch.Tensor | None = None,
            neg_sum: torch.Tensor | None = None,
            key=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert analog column sums to digital. Returns (value, saturated):
    int32 rounded half to even and clipped to [cfg.lo, cfg.hi], and whether
    the output sits on either bound (the paper's detection rule).

    ``col_sum`` may be an integer sum (the ideal array) or a float32 analog
    read (a ``NonidealSim`` die); either converts through float32, as the
    reference does. With ``noise_level`` E > 0 one normal draw of ``key``
    per conversion adds ``E * sqrt(pos_sum + neg_sum)``; noise without a
    key, or without the two sums, raises.
    """
    check_zero_preserving(cfg)
    x = col_sum.to(torch.float32)
    if noise_level:
        if key is None:
            raise ValueError(
                f"noise_level={noise_level} requires a key: pass key= "
                "(silently converting noiseless would drop the noise)")
        if pos_sum is None or neg_sum is None:
            raise ValueError("noise model needs pos/neg sliced-product sums")
        sigma = noise_level * torch.sqrt((pos_sum + neg_sum).to(torch.float32))
        x = x + sigma * key.normal(x.shape, x.device)
    out = torch.round(x).to(torch.int32).clamp(cfg.lo, cfg.hi)
    saturated = (out == cfg.lo) | (out == cfg.hi)
    return out, saturated


def required_bits(col_sum: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Resolution (bits) needed to represent each column sum exactly."""
    mag = col_sum.abs().to(torch.int32)
    bits = torch.ceil(torch.log2(mag.clamp_min(1).to(torch.float32) + 1.0))
    return bits.to(torch.int32) + (1 if signed else 0)
