"""Synthetic network generation for scale testing (``hpfx.generators``).

A net1-style ring feeder with chords, series R/X per line and nonlinear
devices at the tail buses.  The random draws are those of the JAX
package, in the same order from the same ``np.random.default_rng(seed)``,
so both packages build the same feeder from the same seed.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .config import Settings
from .network import NONLINEAR, PQ, SLACK, Network, network_from_arrays


def synthetic_feeder(n_buses: int, n_nonlinear: int, settings: Settings,
                     components: Sequence[str] = ("SMPS",),
                     n_chords: int = 3, seed: int = 0,
                     impedance_scale: float = None,
                     device=None) -> Network:
    """A net1-style ring feeder with ``n_chords`` extra cross-ties, on
    ``device``, the CUDA card by default
    (``hpfx.generators.synthetic_feeder``).

    Bus 0 is the slack; the last ``n_nonlinear`` buses carry nonlinear
    devices cycling through ``components``; the rest are PQ loads.  Line
    R is drawn from {0.5, 1} Ohm, X from {0.5, 1, 4} Ohm and loads from
    {0, 100, 150, 250} W.  ``impedance_scale`` multiplies R and X; the
    default ``min(1, 20/n_buses)`` keeps the ring's voltage drop in the
    net1 class as the feeder grows."""
    if n_nonlinear >= n_buses:
        raise ValueError("need at least one linear (slack) bus")
    if impedance_scale is None:
        impedance_scale = min(1.0, 20.0 / n_buses)
    rng = np.random.default_rng(seed)
    n_lin = n_buses - n_nonlinear

    types = [SLACK] + [PQ] * (n_lin - 1) + [NONLINEAR] * n_nonlinear
    comps = (["generator"] + [f"lin_load_{i}" for i in range(1, n_lin)] +
             [components[i % len(components)] for i in range(n_nonlinear)])
    P = np.concatenate([[0.0], rng.choice([0, 100, 150, 250], n_buses - 1)])
    Q = np.where(P > 0, 100.0, 0.0)
    X_sh = np.zeros(n_buses)
    X_sh[0] = 0.005

    line_from = list(range(n_buses))
    line_to = [(i + 1) % n_buses for i in range(n_buses)]
    for _ in range(n_chords):
        a, b = rng.choice(n_buses, 2, replace=False)
        line_from.append(int(a))
        line_to.append(int(b))
    L = len(line_from)
    R = rng.choice([0.5, 1.0], L) * impedance_scale
    X = rng.choice([0.5, 1.0, 4.0], L) * impedance_scale

    return network_from_arrays(
        bus_types=types, components=comps, P=P, Q=Q, X_sh=X_sh,
        line_from=line_from, line_to=line_to, R=R, X=X,
        settings=settings, per_unit=False, device=device)
