"""Keys for the port's random draws: the die's fault maps and write errors,
and the ADC's noise.

The datapath takes a key object and calls four methods on it, at the
places and in the order the reference calls ``jax.random`` on its key:

  ``split(n)``      ``n`` independent child keys, a list;
  ``fold_in(i)``    one child key derived from the integer ``i``;
  ``normal(shape, device)``   float32 standard normal draws;
  ``uniform(shape, device)``  float32 draws in [0, 1).

The paper artifacts (``repro_torch.paper``) also draw integers, with
``randint(low, high, shape, device)`` (int64 in [low, high)).

``Key(seed)`` is the port's own implementation. A child's seed is a
deterministic function of the parent's and of the derivation (splitmix64
over Python ints), and every draw comes from a fresh ``torch.Generator``
seeded with its key's seed: the same key draws the same numbers every
time on one device type, which makes a die a pure function of (corner,
seed, device type). Torch's CPU and CUDA generators produce different
streams, so a die of one seed reads one way on the CPU and another on the
card, and neither equals the reference's ``jax.random`` die. Anything with
these four methods may stand in for a ``Key``; the parity tests pass one
that returns the reference's own ``jax.random`` draws.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1
_SPLIT, _FOLD = 1, 2  # domain tags: split(n)[i] never equals fold_in(i)


def _mix(z: int) -> int:
    """splitmix64: one step of the generator's state, then its finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class Key:
    """A seed for the datapath's random draws (see the module docstring)."""

    __slots__ = ("state",)

    def __init__(self, seed: int):
        self.state = _mix(int(seed) & _MASK)

    def _child(self, *words: int) -> Key:
        s = self.state
        for w in words:
            s = _mix(s ^ (w & _MASK))
        child = object.__new__(Key)
        child.state = s
        return child

    def split(self, n: int) -> list[Key]:
        return [self._child(_SPLIT, n, i) for i in range(n)]

    def fold_in(self, i: int) -> Key:
        return self._child(_FOLD, i)

    def _generator(self, device) -> torch.Generator:
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(self.state)
        return g

    def normal(self, shape, device="cpu") -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._generator(device),
                           dtype=torch.float32, device=device)

    def uniform(self, shape, device="cpu") -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(device),
                          dtype=torch.float32, device=device)

    def randint(self, low: int, high: int, shape, device="cpu"
                ) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self._generator(device),
                             dtype=torch.int64, device=device)

    def __eq__(self, other) -> bool:
        return isinstance(other, Key) and other.state == self.state

    def __hash__(self) -> int:
        return hash(self.state)

    def __repr__(self) -> str:
        return f"Key(state={self.state:#018x})"
