"""Solver configuration: the PyTorch counterpart of :mod:`hpfx.config`.

``Settings`` has the fields and defaults of ``hpfx.config.Settings``, so
one is built from the other with ``Settings(**dataclasses.asdict(s))``,
and one field more, ``step_stop``.  The dtype rule differs: ``dtype`` is
a string and ``None`` means float32 (the card's working type), where the
JAX package follows its global x64 switch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def default_harmonics(h_max: int) -> Tuple[int, ...]:
    """Odd harmonic orders 1, 3, ..., h_max (reference: hcne_generalized.py:584)."""
    return tuple(range(1, h_max + 1, 2))


@dataclasses.dataclass(frozen=True)
class Settings:
    """Frozen solver configuration; see ``hpfx.config.Settings`` for the
    meaning of every field but ``step_stop``."""

    harmonics: Tuple[int, ...] = default_harmonics(51)
    coupled: bool = False

    base_power: float = 1000.0      # W
    base_voltage: float = 400.0     # V
    net_freq: float = 50.0          # Hz

    thresh_f: float = 1e-6
    max_iter_f: int = 30
    thresh_h: float = 1e-4
    max_iter_h: int = 50

    v_init_f: float = 1.0
    a_init_f: float = 0.0
    v_init_h: float = 0.1
    a_init_h: float = 0.0

    dtype: Optional[str] = None
    solver: str = "dense"
    compat_shunt_bug: bool = False
    stable_mismatch: bool = False
    layout: str = "auto"
    big_solve: str = "panel"
    big_solve_warmup: int = 12
    floor_kappa: float = 4.0
    # the largest phasor step (pu) of the Newton trip after which a
    # scenario whose threshold the floor lifted above thresh_h may stop
    # (hpfx_torch.harmonic.long_step_err): Newton's quadratic convergence
    # leaves it ~C·step² from the root, C under 10 on the IEEE 33-bus
    # feeder's float32 trips, and no net1 or net2 trip that met its
    # threshold stepped past 4e-3
    step_stop: float = 1e-2

    # ---- derived quantities -------------------------------------------------
    @property
    def n_harmonics(self) -> int:
        return len(self.harmonics)

    @property
    def harmonics_freq(self) -> Tuple[float, ...]:
        return tuple(self.net_freq * h for h in self.harmonics)

    @property
    def base_current(self) -> float:
        return self.base_power / self.base_voltage

    @property
    def base_admittance(self) -> float:
        return self.base_current / self.base_voltage

    @property
    def base_impedance(self) -> float:
        return 1.0 / self.base_admittance

    @property
    def real_dtype(self) -> torch.dtype:
        if self.dtype is None:
            return torch.float32
        return getattr(torch, self.dtype)

    def with_(self, **kwargs) -> "Settings":
        return dataclasses.replace(self, **kwargs)


def settings_for_hmax(h_max: int, **kwargs) -> Settings:
    return Settings(harmonics=default_harmonics(h_max), **kwargs)
