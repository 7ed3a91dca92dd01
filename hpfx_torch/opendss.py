"""OpenDSS case export, the port of :mod:`hpfx.opendss`:
:func:`export_opendss_case` writes the network, loads, bus shunts and
device spectra as a runnable single-phase ``.dss`` script (harmonics-mode
solve included), the same text as the JAX package's for the same inputs;
:func:`device_spectra_at_nominal` evaluates the devices at nominal
voltage (exact for Y_N = 0, the fixed-spectrum linearization
otherwise).  Host I/O: the tensors are read back to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Settings
from .devices import DeviceSet
from .network import Network, SLACK

__all__ = ["export_opendss_case", "device_spectra_at_nominal"]


def _np(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_spectra_at_nominal(devices, settings: Settings) -> np.ndarray:
    """(n_nl, H) complex injection spectra at nominal voltage 1∠0 —
    exact for uncoupled devices with Y_N = 0 (converters); the standard
    fixed-spectrum linearization otherwise."""
    H = len(settings.harmonics)
    I_N = _np(devices.I_N.re) + 1j * _np(devices.I_N.im)
    Y_N = _np(devices.Y_N.re) + 1j * _np(devices.Y_N.im)
    V1 = np.zeros(H, complex)
    V1[0] = 1.0
    if devices.coupled:
        return I_N - np.einsum("dhp,p->dh", Y_N, V1)
    return I_N - Y_N * V1[None, :]


def export_opendss_case(net: Network, devices: DeviceSet,
                        settings: Settings, path: str, *,
                        circuit_name: str = "hpfx") -> int:
    """Write the network + devices as a runnable OpenDSS ``.dss`` script
    (harmonics-mode solve included).  Returns the number of element
    definitions written.  Quantities convert from the pu system via the
    settings' bases (ohms, nF, kW/kvar, kV line-to-neutral)."""
    s = settings
    kv = s.base_voltage / 1e3
    zb = s.base_impedance
    f0 = s.net_freq
    hs = [float(h) for h in s.harmonics]
    n_def = 0
    out = []
    w = out.append

    w(f"! hpfx export: {net.n} buses, {net.n_lines} branches, "
      f"{net.n_nonlinear} harmonic device(s)")
    w(f"! pu bases: {s.base_power} W, {s.base_voltage} V, {f0} Hz")
    w("Clear")

    slack = int(np.nonzero(np.asarray(net.bus_types) == SLACK)[0][0])
    xsh_slack = float(_np(net.bus_Xsh)[slack]) * zb
    w(f"New Circuit.{circuit_name} basekv={kv:.6g} pu=1.0 phases=1 "
      f"bus1=bus{slack} Z1=[0, {xsh_slack:.8g}] Z0=[0, {xsh_slack:.8g}]")
    n_def += 1

    R = _np(net.line_R) * zb
    X = _np(net.line_X) * zb
    B = _np(net.line_B) * s.base_admittance
    tau = _np(net.line_tau)
    shift = np.degrees(_np(net.line_shift))
    f_idx = _np(net.line_from)
    t_idx = _np(net.line_to)
    for k in range(net.n_lines):
        if abs(tau[k] - 1.0) < 1e-12 and abs(shift[k]) < 1e-12:
            c_nf = B[k] / (2.0 * np.pi * f0) * 1e9
            w(f"New Line.line{k} bus1=bus{f_idx[k]} bus2=bus{t_idx[k]} "
              f"phases=1 R1={R[k]:.8g} X1={X[k]:.8g} C1={c_nf:.8g} "
              f"R0={R[k]:.8g} X0={X[k]:.8g} C0={c_nf:.8g} units=none")
        else:
            # tap/shift branch -> two-winding transformer, tap on w1
            kva = s.base_power / 1e3
            xpu = float(_np(net.line_X)[k]) * 100.0
            rpu = float(_np(net.line_R)[k]) * 50.0   # split across windings
            w(f"New Transformer.trafo{k} phases=1 windings=2 "
              f"buses=(bus{f_idx[k]}, bus{t_idx[k]}) "
              f"kvs=({kv:.6g}, {kv:.6g}) kvas=({kva:.6g}, {kva:.6g}) "
              f"xhl={xpu:.8g} %rs=({rpu:.8g}, {rpu:.8g}) "
              f"taps=({tau[k]:.8g}, 1.0)"
              + (f"  ! phase shift {shift[k]:.4g} deg NOT representable "
                 f"in a 1-phase transformer" if abs(shift[k]) > 1e-12
                 else ""))
        n_def += 1

    # harmonic-only bus shunt reactances (divergence note in module doc)
    xsh = _np(net.bus_Xsh)
    for i in range(net.n):
        if i != slack and xsh[i] != 0.0:
            w(f"New Reactor.sh{i} bus1=bus{i} phases=1 R=0 "
              f"X={xsh[i] * zb:.8g}  ! hpfx applies this at h>1 only")
            n_def += 1

    # linear loads (P/Q at non-slack, non-device buses)
    P = _np(net.bus_P) * s.base_power / 1e3
    Q = _np(net.bus_Q) * s.base_power / 1e3
    for i in range(net.n):
        if i == slack or i >= net.m:
            continue
        if P[i] != 0.0 or Q[i] != 0.0:
            w(f"New Load.load{i} bus1=bus{i} phases=1 kv={kv:.6g} "
              f"kw={P[i]:.8g} kvar={Q[i]:.8g} model=1")
            n_def += 1

    # harmonic devices: Spectrum + spectrum-tagged Load
    spec = device_spectra_at_nominal(devices, settings)
    harm_str = ", ".join(f"{h:g}" for h in hs)
    for d in range(net.n_nonlinear):
        bus = net.m + d
        I = spec[d]
        base = abs(I[0]) if abs(I[0]) > 0 else 1.0
        mags = ", ".join(f"{100.0 * abs(v) / base:.6g}" for v in I)
        angs = ", ".join(f"{np.degrees(np.angle(v)):.6g}" for v in I)
        tag = "exact (Y_N=0)" if not devices.coupled and \
            float(np.abs(_np(devices.Y_N.re)[d]).max()
                  + np.abs(_np(devices.Y_N.im)[d]).max()) == 0.0 \
            else "linearized at nominal voltage"
        w(f"! device at bus{bus}: spectrum {tag}")
        w(f"New Spectrum.dev{d} numharm={len(hs)} harmonic=({harm_str}) "
          f"%mag=({mags}) angle=({angs})")
        kw_d = max(float(P[bus]), 1e-6 * s.base_power / 1e3)
        w(f"New Load.nl{bus} bus1=bus{bus} phases=1 kv={kv:.6g} "
          f"kw={kw_d:.8g} kvar={Q[bus]:.8g} model=1 spectrum=dev{d}")
        n_def += 2

    w(f"Set voltagebases=[{kv:.6g}]")
    w("CalcVoltageBases")
    w("Solve")
    w("Solve mode=harmonics")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return n_def
