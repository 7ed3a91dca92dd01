"""Background (upstream) harmonic distortion at the grid connection: the
port of :mod:`hpfx.background`.

A background Thevenin voltage V_bg(h) behind the grid impedance that the
bus shunt reactance X_sh models is, by source transformation, a constant
Norton current I_bg(h) = V_bg(h)·Y_sh(h), Y_sh(h) = 1/(j·X_sh·h), at the
connection bus.  Constant injections enter the harmonic current balance
as an additive term and leave the Jacobian as it is.  Pass the (H, n)
split-complex tensor as ``I_bg=`` to :func:`hpfx_torch.hpf` /
``hpf_single``, or a (B, H, n) batch to :func:`background_sweep` and the
sweeps.

Conventions: the fundamental row stays zero (the fundamental belongs to
the slack equations); positive ``I_bg`` injects current INTO the bus, as
the device currents I_N do; magnitudes are per-unit on the network's
base.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network


def current_source(settings: Settings, n: int, i_bg: Cx,
                   bus: int = 0) -> Cx:
    """Embed a per-harmonic current spectrum ``i_bg`` (H,) (fundamental
    entry zero) at one bus: the (H, n) injection tensor, on ``i_bg``'s
    device."""
    H, rd = settings.n_harmonics, settings.real_dtype
    if tuple(i_bg.shape) != (H,):
        raise ValueError(f"i_bg must have shape ({H},), got "
                         f"{tuple(i_bg.shape)}")
    if float(i_bg.re[0]) != 0.0 or float(i_bg.im[0]) != 0.0:
        raise ValueError("background injection at the fundamental is not "
                         "supported: the fundamental boundary condition "
                         "belongs to the slack equations (set row 0 to 0)")
    out = cx.zeros((H, n), rd, i_bg.device)
    return out.at_add((slice(None), bus), i_bg.to(rd))


def shunt_admittance(net: Network, settings: Settings, bus: int = 0) -> Cx:
    """The grid shunt admittance spectrum Y_sh(h) = 1/(j·X_sh·h) at
    ``bus`` (fundamental entry zero); raises if the bus has no shunt."""
    x_sh = float(net.bus_Xsh[bus])
    if x_sh == 0.0:
        raise ValueError(f"bus {bus} has X_sh = 0: no grid impedance to "
                         "transform a Thevenin background source through "
                         "(use current_source with a measured spectrum)")
    rd = settings.real_dtype
    h = torch.tensor(settings.harmonics, dtype=rd, device=net.device)
    im = -1.0 / (x_sh * h)                            # 1/(jX) = -j/X
    im[0] = 0.0
    return Cx(torch.zeros_like(im), im)


def grid_source(net: Network, settings: Settings, v_bg_m, v_bg_a,
                bus: int = 0) -> Cx:
    """A Thevenin background voltage (H,) magnitudes ``v_bg_m`` and angles
    ``v_bg_a`` (per-unit; fundamental magnitude zero) behind the grid
    impedance, as the (H, n) injection tensor with
    I_bg[h, bus] = V_bg(h) / (j·X_sh(bus)·h)."""
    rd = settings.real_dtype
    t = lambda a: torch.as_tensor(a, dtype=rd, device=net.device)
    i_bg = cx.polar(t(v_bg_m), t(v_bg_a)) * shunt_admittance(net, settings,
                                                            bus)
    return current_source(settings, net.n, i_bg, bus)


def background_from_harmonics(net: Network, settings: Settings,
                              spectrum: Dict[int, Tuple[float, float]],
                              bus: int = 0,
                              as_current: bool = False) -> Cx:
    """A background source from ``{order: (magnitude, angle)}``: voltages
    behind the grid impedance, or injected currents with
    ``as_current=True``.  Order 1 and orders outside
    ``settings.harmonics`` raise."""
    H = settings.n_harmonics
    orders = [int(h) for h in settings.harmonics]
    mag, ang = np.zeros(H), np.zeros(H)
    for h, (m_h, a_h) in spectrum.items():
        if int(h) == 1:
            raise ValueError("order 1 is the fundamental — background "
                             "sources are harmonic-only")
        if int(h) not in orders:
            raise ValueError(f"order {h} is not in settings.harmonics "
                             f"(max {orders[-1]})")
        k = orders.index(int(h))
        mag[k], ang[k] = float(m_h), float(a_h)
    if as_current:
        rd = settings.real_dtype
        t = lambda a: torch.as_tensor(a, dtype=rd, device=net.device)
        return current_source(settings, net.n, cx.polar(t(mag), t(ang)), bus)
    return grid_source(net, settings, mag, ang, bus)


def background_sweep(net: Network, devices, settings: Settings, I_bg: Cx,
                     scenarios=None, phase_iters: int = 16,
                     rescue: bool = True, warm: str = "cold",
                     schedule: str = "auto"):
    """Batched background-distortion study with the adaptive schedule and
    the deterministic straggler rescue (``hpfx.background.
    background_sweep``).  ``I_bg``: per-scenario (B, H, n) injections
    (fundamental rows zero); ``scenarios``: optional load and injection
    scales on the same batch axis (default all ones, on ``I_bg``'s
    device).  Every phase and rescue pass, float64 included, takes the
    matching ``I_bg`` rows.

    ``schedule``: "device" runs :func:`hpfx_torch.solve.hpf_sweep_device`
    (the background rides the (H, n, B) lane layout and, with
    ``warm="linear"``, the seed's right-hand side); "host" runs
    :func:`hpfx_torch.solve.hpf_sweep_adaptive`, which takes ``warm=``
    too (where the JAX package drops it), so ``warm="linear"`` there
    raises its ``ValueError``; "auto" takes "device" where the lane-major
    path applies (``settings.layout != "vmap"`` and
    :func:`hpfx_torch.lanes.supports_lanes`), on either device."""
    from .lanes import supports_lanes
    from .solve import Scenarios, hpf_sweep_adaptive, hpf_sweep_device
    if scenarios is None:
        scenarios = Scenarios.uniform(I_bg.re.shape[0], settings.real_dtype,
                                      device=I_bg.re.device)
    use_device = schedule == "device" or (
        schedule == "auto" and settings.layout != "vmap"
        and supports_lanes(devices, settings, net))
    if use_device:
        return hpf_sweep_device(net, devices, settings, scenarios,
                                phase_iters=phase_iters, rescue=rescue,
                                warm=warm, I_bg=I_bg)
    return hpf_sweep_adaptive(net, devices, settings, scenarios,
                              phase_iters=phase_iters, rescue=rescue,
                              warm=warm, I_bg=I_bg)
