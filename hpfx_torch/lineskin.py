"""Frequency-dependent series line resistance, skin and proximity effect
(the port of :mod:`hpfx.lineskin`).

Builds a per-harmonic, per-line resistance table ``Rh`` (H, L) from the
standard conductor models and threads it through
:func:`hpfx_torch.ybus.build_ybus` and the stable mismatch's line
structure as a ``(Y, lineY, lineY_f)`` triple:

- ``"exponent"``: R(h) = R · h**alpha (alpha = 0.5 default);
- ``"cigre_oh"``: R(h) = R · (1 + 0.646·h² / (192 + 0.518·h²));
- ``"cigre_cable"``: R(h) = R · (0.187 + 0.532·√h).

Row 0 (the fundamental) is always exactly ``R``.  The tables are built in
float64 numpy, as the JAX package builds them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Settings
from .cx import Cx
from .network import Network
from .ybus import build_ybus, fold_ydiag, line_ybus_pair

MODELS = ("exponent", "cigre_oh", "cigre_cable")


def skin_ratio(h, model: str = "cigre_oh", *, alpha: float = 0.5):
    """R(h)/R(1) of ``model`` at harmonic order(s) ``h``, as published
    (not pinned at h = 1), in numpy."""
    if model not in MODELS:
        raise ValueError(f"unknown skin model {model!r} (use one of "
                         f"{MODELS})")
    h = np.asarray(h, float)
    if model == "exponent":
        return h ** alpha
    if model == "cigre_oh":
        return 1.0 + 0.646 * h * h / (192.0 + 0.518 * h * h)
    return 0.187 + 0.532 * np.sqrt(h)


def line_resistance(net: Network, settings: Settings, *,
                    model: str = "cigre_oh",
                    alpha: float = 0.5,
                    lines: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(H, L) per-harmonic series resistance for ``build_ybus(Rh=)`` on
    the network's device.  ``lines`` restricts the correction to a subset;
    the others keep their frequency-flat ``R``."""
    R1 = net.line_R.detach().cpu().numpy().astype(float)        # (L,)
    L = R1.shape[0]
    ratio = skin_ratio(np.asarray(settings.harmonics, float),
                       model, alpha=alpha)[:, None]               # (H, 1)
    Rh = R1[None, :] * ratio                                      # (H, L)
    if lines is not None:
        sel = np.asarray([int(i) for i in lines])
        if sel.size and (sel.min() < 0 or sel.max() >= L):
            raise ValueError(f"line indices out of range (0..{L - 1})")
        mask = np.zeros(L, bool)
        mask[sel] = True
        Rh = np.where(mask[None, :], Rh, R1[None, :])
    Rh[0] = R1                                  # fundamental stays exact
    return torch.as_tensor(Rh, dtype=settings.real_dtype, device=net.device)


def skin_structures(net: Network, settings: Settings, Rh=None, *,
                    model: str = "cigre_oh", alpha: float = 0.5,
                    lines: Optional[Sequence[int]] = None,
                    Y_diag: Optional[Cx] = None):
    """``(Y, lineY, lineY_f)`` with the skin-corrected series resistances
    (``Rh``, default :func:`line_resistance`) and optionally a
    :mod:`hpfx_torch.loadmodel` ``Y_diag`` folded into both forms, for the
    ``Y`` argument of ``hpf``, ``hpf_sweep`` or ``hpf_sweep_adaptive``."""
    if Rh is None:
        Rh = line_resistance(net, settings, model=model, alpha=alpha,
                             lines=lines)
    Y = build_ybus(net, settings, Rh=Rh)
    lineY, lineY_f = line_ybus_pair(net, settings, Rh=Rh)
    if Y_diag is not None:
        Y = fold_ydiag(Y, Y_diag)
        if lineY is not None:
            lineY = lineY._replace(d=lineY.d + Y_diag)
            lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    return Y, lineY, lineY_f
