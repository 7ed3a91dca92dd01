"""Frequency-dependent linear-load models, harmonic damping (the port of
:mod:`hpfx.loadmodel`).

The reference treats linear loads as constant-PQ at the fundamental and
open circuits at the harmonic orders.  This module builds the (H, n)
per-bus load admittance Y_load(h) for h > 1 from the loads the network
already carries, for ``hpf``'s ``Y_diag`` or the ``(Y, lineY, lineY_f)``
triple of :func:`damped_structures`:

- ``"resistive"``: Y(h) = P;
- ``"parallel_rl"`` (default): Y(h) = P / r_h − j·Q / h with
  r_h = 1 − skin + skin·h;
- ``"motor"``: Y(h) = P − j·Q / (h·x_lr_ratio).

The fundamental row is always zero, so the h = 1 solve stays the
constant-PQ power flow.  The tables are built in float64 numpy, as the
JAX package builds them, then made tensors on the network's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Settings
from .cx import Cx
from .network import Network

MODELS = ("resistive", "parallel_rl", "motor")


def damped_structures(net: Network, settings: Settings, Y_diag: Cx):
    """``(Y, lineY, lineY_f)`` with ``Y_diag`` folded into both the dense
    tensor and the stable mismatch's line structure (the triple of
    :func:`hpfx_torch.ybus.resolve_ybus`), as ``hpf``'s own ``Y_diag``."""
    from .ybus import build_ybus, fold_ydiag, line_ybus_pair
    Y = fold_ydiag(build_ybus(net, settings), Y_diag)
    lineY, lineY_f = line_ybus_pair(net, settings)
    if lineY is not None:
        lineY = lineY._replace(d=lineY.d + Y_diag)
        lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    return Y, lineY, lineY_f


def linear_load_admittance(net: Network, settings: Settings, *,
                           model: str = "parallel_rl",
                           skin: float = 0.1,
                           x_lr_ratio: float = 0.2,
                           buses: Optional[Sequence[int]] = None) -> Cx:
    """(H, n) per-bus load admittances, on the network's device.

    ``buses`` defaults to the linear loaded buses (P > 0, index <
    ``net.m``); pass a list to include nonlinear buses' linear share."""
    if model not in MODELS:
        raise ValueError(f"unknown load model {model!r} (use one of "
                         f"{MODELS})")
    P = net.bus_P.detach().cpu().numpy()
    Q = net.bus_Q.detach().cpu().numpy()
    n, H = net.n, settings.n_harmonics
    if buses is None:
        sel = np.flatnonzero((np.arange(n) < net.m) & (P > 0.0))
    else:
        sel = np.asarray([int(b) for b in buses])
        if sel.size and (sel.min() < 0 or sel.max() >= n):
            raise ValueError(f"bus indices out of range (0..{n - 1})")
    mask = np.zeros(n)
    mask[sel] = 1.0

    h = np.asarray(settings.harmonics, float)[:, None]       # (H, 1)
    Pm = (P * mask)[None, :]                                 # (1, n)
    Qm = (Q * mask)[None, :]
    if model == "resistive":
        g = np.broadcast_to(Pm, (H, n)).copy()
        b = np.zeros((H, n))
    elif model == "parallel_rl":
        g = Pm / (1.0 - skin + skin * h)
        b = -Qm / h
    else:                                                    # "motor"
        g = np.broadcast_to(Pm, (H, n)).copy()
        b = -Qm / (h * x_lr_ratio)
    g[0] = 0.0                                               # fundamental
    b[0] = 0.0                                               # stays PQ
    t = lambda a: torch.as_tensor(a, dtype=settings.real_dtype,
                                  device=net.device)
    return Cx(t(g), t(b))
