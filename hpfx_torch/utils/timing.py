"""Phase timing, the structured counterpart of the reference's
perf_counter instrumentation (``hpfx.utils.timing``, copied: the port
imports nothing of the JAX package)."""
from __future__ import annotations

import time
from typing import Dict


class PhaseTimer:
    """Collects wall-clock durations per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("init"): ...
    >>> t.report()   # {'init': ..., 'total': ...}

    The durations are host time: a phase that launches work on the card
    ends before the card does unless it synchronises."""

    def __init__(self):
        self.durations: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self_inner):
                self_inner.start = time.perf_counter()
                return self_inner

            def __exit__(self_inner, *exc):
                timer.durations[name] = timer.durations.get(name, 0.0) + \
                    time.perf_counter() - self_inner.start
                return False

        return _Ctx()

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> Dict[str, float]:
        out = dict(self.durations)
        out["total"] = self.total
        return out
