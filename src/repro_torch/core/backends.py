"""Crossbar backends: the analog array model behind ``crossbar.forward``.

Port of ``repro.core.backends``. A ``CrossbarBackend`` programs signed
slice planes once (``program``) and reads column sums many times
(``read``):

  ``IdealSim``     the exact integer 2T2R model: signed slice planes as
                   (G+, G-) integer conductances, exact column sums.
                   ``crossbar.forward`` routes its noiseless runs on it
                   through the fused kernel (K1).

  ``NonidealSim``  a ReRAM die. ``program`` perturbs the conductances
                   with the four dominant eNVM nonidealities, composed
                   in physical order:

                     1. conductance program error — per-device
                        multiplicative lognormal, ``G * exp(sigma * n)``;
                     2. retention drift — ``G * (t / t0)^(-nu)`` with
                        ``t0 = 1 s``;
                     3. stuck-at faults — per-device Bernoulli maps,
                        stuck-at-G_on or stuck-at-G_off;
                     4. IR drop — first-order attenuation of each row's
                        contribution by its distance along the bitline.

                   ``read`` is two float32 contractions per plane.

All draws come from the die's key (``core.rng``), never from a per-call
generator: the same die reads the same way every forward pass. A
``rng.Key`` die is a pure function of (corner, seed, device type); its
CPU and CUDA draws differ, and neither equals the reference's
``jax.random`` die (the parity tests pass the reference's draws in).

Zero-corner contract: a ``NonidealSim`` whose corner magnitudes are all
zero is bit-exact with ``IdealSim`` and with the fused kernel. Every
perturbation is a multiply by a factor that is exactly 1.0
(``exp(+-0.0)``, ``1 - 0*x``) or a ``where`` on an all-False mask at zero
magnitude, and the float32 column sums are exact whatever the summation
order, because every partial sum is an integer below 2^24 (|slice| <=
127, inputs <= 255, <= 512 rows: at most 16.6M). ``read`` therefore
needs IEEE float32 products: TF32 (``torch.backends.cuda.matmul.
allow_tf32``) would round the conductances to 10 bits.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.kernels.ref import _int_matmul


@dataclasses.dataclass(frozen=True)
class DeviceCorner:
    """One die's nonideality magnitudes. All-zero (the default) is the
    nominal corner, bit-exact with the ideal sim. Fields are Python floats
    or 0-d float32 tensors (``stack_corners`` stacks them)."""
    program_sigma: float = 0.0   # lognormal conductance write error (rel.)
    drift_nu: float = 0.0        # retention drift exponent
    drift_time: float = 0.0      # seconds since programming (t0 = 1 s)
    stuck_rate: float = 0.0      # per-device stuck-at fault probability
    stuck_on_frac: float = 0.5   # of stuck devices, fraction at G_on
    ir_drop_alpha: float = 0.0   # bitline attenuation at the far row


# Named corners for the accuracy sweeps and `serve --device-corner`.
# 1sigma ~ a typical production die (write-verify to ~3% conductance,
# ~1e-3 fault density, day-scale retention); 3sigma ~ a tail die.
NOMINAL = DeviceCorner()
SIGMA1 = DeviceCorner(program_sigma=0.03, drift_nu=0.01, drift_time=1e5,
                      stuck_rate=1e-3, ir_drop_alpha=0.02)
SIGMA3 = DeviceCorner(program_sigma=0.09, drift_nu=0.03, drift_time=1e5,
                      stuck_rate=5e-3, ir_drop_alpha=0.06)
CORNERS: dict[str, DeviceCorner] = {
    "nominal": NOMINAL, "1sigma": SIGMA1, "3sigma": SIGMA3,
}


def corner(name: str) -> DeviceCorner:
    """Look up a named corner (``'nominal'`` / ``'1sigma'`` / ``'3sigma'``)."""
    if name not in CORNERS:
        raise ValueError(f"unknown device corner {name!r}; "
                         f"have {sorted(CORNERS)}")
    return CORNERS[name]


def stack_corners(corners_: list[DeviceCorner] | tuple[DeviceCorner, ...]
                  ) -> DeviceCorner:
    """Stack corners field by field into one DeviceCorner of float32
    vectors; ``DeviceCorner(**{f: v[i]})`` is corner ``i`` again."""
    return DeviceCorner(**{
        f.name: torch.stack([torch.as_tensor(getattr(c, f.name),
                                             dtype=torch.float32)
                             for c in corners_])
        for f in dataclasses.fields(DeviceCorner)})


class ProgrammedPlanes(NamedTuple):
    """The programmed array: per-plane (G+, G-) conductances plus the
    stuck-at fault maps (None for the ideal sim). ``gp``/``gn`` are
    (n_slices, n_seg, rows_per_xbar, cols); fault maps add a leading
    device axis of 2 (positive / negative ReRAM of each 2T2R pair)."""
    gp: torch.Tensor
    gn: torch.Tensor
    stuck_on: torch.Tensor | None = None
    stuck_off: torch.Tensor | None = None


class CrossbarBackend(abc.ABC):
    """Abstract analog array: write-once (``program``), read-many
    (``read``). Implementations hold no state beyond their own fields."""

    name: str = "abstract"

    @abc.abstractmethod
    def program(self, planes: torch.Tensor, *,
                rows: int | None = None) -> ProgrammedPlanes:
        """Program signed slice planes (n_slices, n_seg, R, C) into
        (G+, G-) conductance arrays. ``rows`` is the true (unpadded)
        input length: padding rows beyond it hold no physical devices, so
        nonidealities never touch them."""

    @abc.abstractmethod
    def read(self, prog: ProgrammedPlanes, x_slice: torch.Tensor,
             j: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Column sums of one input slice against plane ``j``.
        x_slice: (B, n_seg, R) unsigned slice values. Returns (pos, neg)
        of shape (B, n_seg, C); their difference is what the ADC
        converts."""


class IdealSim(CrossbarBackend):
    """The exact integer 2T2R model. ``crossbar.forward`` treats it as
    fused-kernel eligible."""

    name = "ideal"

    def program(self, planes: torch.Tensor, *,
                rows: int | None = None) -> ProgrammedPlanes:
        p = planes.to(torch.int32)
        return ProgrammedPlanes(gp=p.clamp_min(0), gn=(-p).clamp_min(0))

    def read(self, prog: ProgrammedPlanes, x_slice: torch.Tensor,
             j: int) -> tuple[torch.Tensor, torch.Tensor]:
        xs = x_slice.transpose(0, 1)  # (n_seg, B, R)
        pos = _int_matmul(xs, prog.gp[j]).transpose(0, 1)
        neg = _int_matmul(xs, prog.gn[j]).transpose(0, 1)
        return pos.to(torch.int32), neg.to(torch.int32)


IDEAL = IdealSim()


def _factor(v):
    """A float32 scalar as the elementwise ops take it: a host value as a
    Python float (exactly its float32 value, so no host-to-device copy),
    a device tensor as it is."""
    v = torch.as_tensor(v, dtype=torch.float32)
    return v.item() if v.device.type == "cpu" else v


@dataclasses.dataclass(frozen=True)
class NonidealSim(CrossbarBackend):
    """One ReRAM die: a ``DeviceCorner`` plus the die key that seeds its
    fault maps and write-error draws. Deterministic: the same (corner,
    key) pair programs the identical die every time on one device type.
    ``key`` is an ``rng.Key`` or anything with its methods."""

    corner: DeviceCorner = NOMINAL
    key: object = None

    name = "nonideal"

    def _key(self):
        return self.key if self.key is not None else rng.Key(0)

    def program(self, planes: torch.Tensor, *,
                rows: int | None = None) -> ProgrammedPlanes:
        _, n_seg, R, _ = planes.shape
        shape, dev = tuple(planes.shape), planes.device
        p = planes.to(torch.float32)
        # G_on is approximated by the largest programmed magnitude in the
        # plane: an all-zero (padding) plane has G_on = 0, so the
        # slice-padding contract survives faults
        g_on = p.abs().amax(dim=(1, 2, 3), keepdim=True)
        gp, gn = p.clamp_min(0.0), (-p).clamp_min(0.0)
        del p
        c = self.corner
        kp, kn, kfp, kfn, kop, kon = self._key().split(6)

        # 1. conductance program error: per-device lognormal. sigma = 0
        #    multiplies by exp(+-0.0) == 1.0 exactly.
        sigma = _factor(c.program_sigma)
        gp.mul_(kp.normal(shape, dev).mul_(sigma).exp_())
        gn.mul_(kn.normal(shape, dev).mul_(sigma).exp_())

        # 2. retention drift: G(t) = G0 * (t/t0)^(-nu), t0 = 1 s, clamped
        #    to t >= t0. nu = 0 gives exp(-0.0 * log) == 1.0 exactly.
        nu = torch.as_tensor(c.drift_nu, dtype=torch.float32)
        t = torch.as_tensor(c.drift_time, dtype=torch.float32).clamp_min(1.0)
        drift = _factor(torch.exp(-nu * torch.log(t)))
        gp.mul_(drift)
        gn.mul_(drift)

        # 3. stuck-at fault maps: Bernoulli per physical device, keyed by
        #    the die; rows beyond `rows` (segment zero-padding) hold no
        #    devices.
        if rows is None:
            rows = n_seg * R
        live = (torch.arange(n_seg * R, device=dev).reshape(n_seg, R)
                < rows)[None, :, :, None]
        rate = _factor(c.stuck_rate)
        onf = _factor(c.stuck_on_frac)

        def stuck(g, kf, ko):
            s = (kf.uniform(shape, dev) < rate) & live
            on = ko.uniform(shape, dev) < onf
            s_on, s_off = s & on, s & ~on
            del s, on
            g = torch.where(s_on, g_on, g)
            return g.masked_fill_(s_off, 0.0), s_on, s_off

        gp, on_p, off_p = stuck(gp, kfp, kop)
        gn, on_n, off_n = stuck(gn, kfn, kon)

        # 4. IR drop: rows far from the sense amp lose drive along the
        #    bitline; first-order linear attenuation, alpha = fractional
        #    loss at the far end. alpha = 0 scales by exactly 1.0.
        alpha = _factor(c.ir_drop_alpha)
        att = 1.0 - alpha * (torch.arange(R, dtype=torch.float32, device=dev)
                             / max(R - 1, 1))
        gp.mul_(att[None, None, :, None])
        gn.mul_(att[None, None, :, None])
        return ProgrammedPlanes(
            gp=gp, gn=gn,
            stuck_on=torch.stack([on_p, on_n]),
            stuck_off=torch.stack([off_p, off_n]))

    def read(self, prog: ProgrammedPlanes, x_slice: torch.Tensor,
             j: int) -> tuple[torch.Tensor, torch.Tensor]:
        # float32 is exact at the zero corner: every partial sum is an
        # integer below 2^24 (see the module docstring)
        x = x_slice.to(torch.float32).transpose(0, 1)  # (n_seg, B, R)
        pos = torch.bmm(x, prog.gp[j]).transpose(0, 1)
        neg = torch.bmm(x, prog.gn[j]).transpose(0, 1)
        return pos, neg


BACKENDS = ("ideal", "nonideal")


def make(name: str, corner_: DeviceCorner | str = "nominal", *,
         seed: int = 0) -> CrossbarBackend:
    """Build a backend from ``ArchConfig``'s strings
    (``pim_crossbar_backend`` / ``pim_device_corner`` /
    ``pim_device_seed``); a nonideal die's key is ``rng.Key(seed)``."""
    if name == "ideal":
        return IDEAL
    if name == "nonideal":
        c = corner_ if isinstance(corner_, DeviceCorner) else corner(corner_)
        return NonidealSim(corner=c, key=rng.Key(seed))
    raise ValueError(f"unknown crossbar backend {name!r}; have {BACKENDS}")
