"""Explicit random keys (the port's counterpart of the reference's
``jax.random`` keys).

A :class:`Key` is a value: splitting it or drawing from it never
changes it or any shared state, so the same key gives the same draws
and the same children every time.  Functions that draw take a key and
split it where the reference splits its key, so the two packages make
their draws at the same places.  The draws themselves differ (PyTorch's
generators are not threefry; ROADMAP C6), and a key's draws on the card
differ from its draws on the CPU.

``fold_in(i)`` is the per-device key of a sharded render: each rank
folds its linear index into the frame's key, as the reference folds in
``jax.random.fold_in(key, axis_index)``.

Anything with the same four methods (``split``, ``fold_in``,
``uniform``, ``normal``) can stand in for a key.
"""

from __future__ import annotations

import torch

__all__ = ["Key"]

_MASK = (1 << 64) - 1
# Folds mix their index with this constant, so fold_in(i) never equals
# a child of split() (those mix i + 1, a small number).
_FOLD = 0xF01D_1A7E_5EED_0000


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class Key:
    """A functional random key on one device."""

    __slots__ = ("state", "device")

    def __init__(self, state: int, device):
        self.state = int(state) & _MASK
        self.device = torch.device(device)

    @staticmethod
    def seed(seed: int, device="cuda") -> "Key":
        return Key(_mix(int(seed) & _MASK), device)

    def split(self, n: int = 2) -> list:
        """``n`` child keys, each independent of the others and of this
        key's own draws."""
        return [Key(_mix(self.state ^ _mix(i + 1)), self.device)
                for i in range(n)]

    def fold_in(self, i: int) -> "Key":
        """The child key of ``(this key, i)``: the same ``i`` gives the
        same key every time, different ``i`` independent keys."""
        return Key(_mix(self.state ^ _mix(_FOLD ^ (int(i) & _MASK))),
                   self.device)

    def _generator(self) -> torch.Generator:
        g = torch.Generator(self.device)
        g.manual_seed(self.state)
        return g

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Uniform draws in [0, 1)."""
        return torch.rand(tuple(shape), generator=self._generator(),
                          dtype=dtype, device=self.device)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Standard normal draws."""
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=dtype, device=self.device)
