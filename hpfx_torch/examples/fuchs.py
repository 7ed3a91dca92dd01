"""Fuchs textbook 4-bus harmonic power flow (ch. 7.3/7.4; the port of
:mod:`hpfx.examples.fuchs`).

The 4-bus system of the reference's ``example_hpf_fuchs.py`` /
``hcne_based_on_fuchs.py`` with one analytic nonlinear device and
harmonics {1, 5}:

- the device is an :class:`hpfx_torch.devices.AnalyticDeviceSet` with the
  textbook injection (hcne_based_on_fuchs.py:168-173, 197-216)
      I_1 = conj(S / V_1)
      I_5 = 0.3·V1m^3·e^{3j·a1} + 0.3·V5m^2·e^{3j·a5};
- its Jacobian blocks come from ``torch.func.jacfwd``.

``validation/V_log.json`` and ``I_log.json`` record the reference's
per-iteration voltages and injections.
"""
from __future__ import annotations

import torch

from .. import cx
from ..config import Settings
from ..devices import AnalyticDeviceSet
from ..harmonic import HPFResult, hpf
from ..network import NONLINEAR, PQ, SLACK, network_from_arrays

#: per-unit system of the example (hcne_based_on_fuchs.py:13)
PU_FACTOR = 1000.0


def fuchs_settings() -> Settings:
    """Harmonics {1, 5}, float64, and the hpfx thresholds (tighter than
    the reference's, converging to the same fixed point)."""
    return Settings(harmonics=(1, 5), coupled=True,
                    base_power=PU_FACTOR, thresh_h=1e-6, dtype="float64")


def fuchs_network(settings: Settings, device=None):
    """The 4-bus example grid (hcne_based_on_fuchs.py:44-53) on ``device``
    (default: the CUDA card): line impedances in per-unit, powers in W /
    PU_FACTOR, the slack's X_shunt = 0.0001 in the harmonic Ybus only."""
    return network_from_arrays(
        bus_types=(SLACK, PQ, PQ, NONLINEAR),
        components=("swing", "lin_load_1", "bus3", "fuchs_smps"),
        P=[0.0, 0.1, 0.0, 0.25], Q=[0.0, 0.1, 0.0, 0.1],
        X_sh=[0.0001, 0.0, 0.0, 0.0],
        line_from=[0, 1, 2, 3], line_to=[1, 2, 3, 0],
        R=[0.01, 0.02, 0.01, 0.01], X=[0.01, 0.08, 0.02, 0.02],
        settings=settings, device=device)


def _fuchs_inject(params, V_m, V_a):
    """Textbook device injection; see the module docstring."""
    S = params                       # Cx scalar, the device's P + jQ
    v1 = cx.polar(V_m[0], V_a[0])
    i1 = (S / v1).conj()
    i5 = cx.expj(3.0 * V_a[0]) * (0.3 * V_m[0] ** 3) + \
        cx.expj(3.0 * V_a[1]) * (0.3 * V_m[1] ** 2)
    return cx.Cx(torch.stack([i1.re, i5.re]), torch.stack([i1.im, i5.im]))


def fuchs_device_set(settings: Settings, device=None) -> AnalyticDeviceSet:
    """The example's one analytic device on ``device`` (default: the
    CUDA card)."""
    from .._device import resolve_device
    rd, dv = settings.real_dtype, resolve_device(device)
    S = cx.Cx(torch.tensor([0.25], dtype=rd, device=dv),
              torch.tensor([0.1], dtype=rd, device=dv))
    return AnalyticDeviceSet(params=S, inject=_fuchs_inject, n_nl=1)


def solve_fuchs(settings: Settings = None, device=None) -> HPFResult:
    """The example solved with :func:`hpfx_torch.harmonic.hpf`."""
    settings = settings or fuchs_settings()
    net = fuchs_network(settings, device)
    devices = fuchs_device_set(settings, device)
    return hpf(net, devices, settings)
