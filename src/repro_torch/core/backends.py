"""Crossbar backends: the analog array model behind ``crossbar.forward``.

Port of ``repro.core.backends`` without the ReRAM nonidealities. A
``CrossbarBackend`` programs signed slice planes once (``program``) and
reads column sums many times (``read``):

  ``IdealSim``     the exact integer 2T2R model: signed slice planes as
                   (G+, G-) integer conductances, exact column sums.
                   ``crossbar.forward`` routes its noiseless runs on it
                   through the fused kernel (K1).

  ``NonidealSim``  a ReRAM die (program noise, drift, stuck-at faults,
                   IR drop). Its draws come from ``jax.random`` in the
                   reference, so it has no bit-for-bit oracle here; it is
                   not ported yet (ROADMAP) and raises.
"""

from __future__ import annotations

import abc
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import _int_matmul


class ProgrammedPlanes(NamedTuple):
    """The programmed array: per-plane (G+, G-) conductances, each
    (n_slices, n_seg, rows_per_xbar, cols). The reference's stuck-at fault
    maps arrive with the nonideal device."""
    gp: torch.Tensor
    gn: torch.Tensor


class CrossbarBackend(abc.ABC):
    """Abstract analog array: write-once (``program``), read-many
    (``read``)."""

    name: str = "abstract"

    @abc.abstractmethod
    def program(self, planes: torch.Tensor, *,
                rows: int | None = None) -> ProgrammedPlanes:
        """Program signed slice planes (n_slices, n_seg, R, C) into
        (G+, G-) conductance arrays. ``rows`` is the true (unpadded)
        input length."""

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


class NonidealSim(CrossbarBackend):
    """A ReRAM die. Not ported yet: constructing one raises."""

    name = "nonideal"

    def __new__(cls, *args, **kwargs):
        raise NotImplementedError(
            "nonideal crossbar devices are not ported yet (ROADMAP)")


BACKENDS = ("ideal", "nonideal")


def make(name: str, corner_: str = "nominal", *,
         seed: int = 0) -> CrossbarBackend:
    """Build a backend from ``ArchConfig``'s strings
    (``pim_crossbar_backend`` / ``pim_device_corner`` /
    ``pim_device_seed``)."""
    if name == "ideal":
        return IDEAL
    if name == "nonideal":
        return NonidealSim(corner_, seed=seed)
    raise ValueError(f"unknown crossbar backend {name!r}; have {BACKENDS}")
