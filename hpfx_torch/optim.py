"""First-order optimizers for the design loops of :mod:`hpfx_torch.optimize`.

The JAX package takes its optimizer from optax (``optax.adam`` by
default); the port carries its own with optax's gradient-transform
protocol, over NamedTuples of tensors (``LineParams``, ``FilterParams``):

- ``init(params) -> state``;
- ``update(grads, state, params=None) -> (updates, state)``, the caller
  then adding ``updates`` to ``params``.

Any object with those two methods can stand in for it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    """Adam's step count and its first and second moments, each shaped
    like the parameters."""
    count: int
    mu: tuple
    nu: tuple


class Adam(NamedTuple):
    """Adam (Kingma & Ba 2015) as ``optax.adam(learning_rate, b1, b2, eps,
    eps_root)`` computes it, with optax's argument order and defaults: the
    moments' moving averages, their bias corrections 1 − β^t (taken in
    float64, then applied in the parameters' dtype), the step
    m̂ / (sqrt(v̂ + eps_root) + eps), scaled by −learning_rate."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params) -> AdamState:
        zeros = type(params)(*(torch.zeros_like(p) for p in params))
        return AdamState(count=0, mu=zeros, nu=zeros)

    def update(self, grads, state: AdamState, params=None):
        del params
        b1, b2 = self.b1, self.b2
        mu = type(grads)(*((1 - b1) * g + b1 * m
                           for g, m in zip(grads, state.mu)))
        nu = type(grads)(*((1 - b2) * (g * g) + b2 * v
                           for g, v in zip(grads, state.nu)))
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = type(grads)(*(
            (-self.learning_rate)
            * ((m / c1) / (torch.sqrt(v / c2 + self.eps_root) + self.eps))
            for m, v in zip(mu, nu)))
        return updates, AdamState(count=count, mu=mu, nu=nu)

