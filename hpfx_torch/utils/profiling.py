"""Profiling hooks (``hpfx.utils.profiling``): a ``torch.profiler`` trace
in place of ``jax.profiler``'s, the program's own spans in it, and a NaN
check on every operation in place of ``jax_debug_nans``.

The sweep path opens a span (:func:`span`) around each entry call
(``hpfx.sweep``), each phase of a sweep (``hpfx.phase.<name>``, the
names of :class:`PhaseLog`), each fundamental and
harmonic Newton trip (``hpfx.fund_trip``, ``hpfx.trip``), each stage of
a harmonic trip (``hpfx.trip.mismatch``, ``.blocks``, ``.block_solve``,
``.capacitance`` and inside it the system's assembly ``.assemble``,
``.backsub``, ``.update``, ``.read``), each batched
solve (``hpfx.solve``) and each collective of a mesh (``hpfx.gather``).
A span is a ``record_function`` on the profiler's clock, the clock of
its device records, so a trace puts every kernel and every idle gap of
the card down to the span whose host code launched or waited for it.
With no profiler recording, a span costs a flag read and a branch.

:class:`PhaseLog` (``log=`` on the sweep entries) counts, beside the
spans, each phase's host-clock seconds, Newton trips and host reads; the
sweeps reach it through :func:`_phase`, :func:`_trip`, :func:`_read`,
:func:`_clock` and :func:`_harmonic_trip`, which do nothing but the
span without a log."""
from __future__ import annotations

import contextlib
import functools
import math
import os
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: the context a span is when no profiler records: shared, it does nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``hpfx.<name>`` while a
    ``torch.profiler`` records (the flag its ``profile`` sets on entry and
    clears on exit), else a shared context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("hpfx." + name)


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# the phase log: wall time, Newton trips and host reads per phase
# ---------------------------------------------------------------------------

#: the key of :attr:`PhaseLog.reads` for reads made while no phase is open
OUTSIDE = "outside"


class PhaseLog:
    """Wall time, Newton trips and host reads of each phase of a sweep.

    Pass one as ``log=`` to ``hpfx_torch.lanes.hpf_sweep_adaptive_lanes``,
    ``hpfx_torch.solve.hpf_sweep_device``, ``hpfx_torch.solve.
    hpf_sweep_adaptive`` or the sharded entries of
    ``hpfx_torch.parallel``.  A phase synchronises the device at its start
    and end, so its time includes all the work it queued; that is one
    synchronisation per phase boundary, on top of the one per trip the
    loops already make.  A phase opened inside another (the host rescue's
    passes) counts its own time and the enclosing one's as well; the
    counts below go to the innermost phase alone.

    ``trips`` counts Newton loop trips (fundamental and harmonic) run
    inside the phase; ``harmonic_trips`` the harmonic ones, and
    ``harmonic_trip_seconds`` their host-clock time, each from the return
    of the previous convergence read to the return of its own: the read
    waits for the trip's device work, so this adds no synchronisation.
    ``reads`` counts the sweep's device-to-host reads (:func:`_read`: the
    loops' convergence tests, the straggler counts and bucket indices), by
    the phase open at each (:data:`OUTSIDE` where none is); the phases'
    own synchronisations are not reads.  ``stragglers`` sums, over the
    calls, the gathered lanes of ``hpf_sweep_adaptive_lanes`` still
    unconverged after phase 1 (those a rank holds, under a mesh): the
    calls where it grows are those whose rescue passes ran."""

    def __init__(self):
        self.seconds = {}
        self.trips = {}
        self.reads = {}
        self.harmonic_trips = {}
        self.harmonic_trip_seconds = {}
        self.stragglers = 0
        self._current = None

    @contextlib.contextmanager
    def phase(self, name: str, device):
        _sync(device)
        t0 = time.perf_counter()
        prev, self._current = self._current, name
        for counts in (self.trips, self.reads, self.harmonic_trips):
            counts.setdefault(name, 0)
        self.harmonic_trip_seconds.setdefault(name, 0.0)
        try:
            with span("phase." + name):
                yield
        finally:
            _sync(device)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self._current = prev

    def trip(self):
        if self._current is not None:
            self.trips[self._current] += 1

    def read(self):
        key = OUTSIDE if self._current is None else self._current
        self.reads[key] = self.reads.get(key, 0) + 1

    def harmonic_trip(self, t_prev: float) -> float:
        now = time.perf_counter()
        if self._current is not None:
            self.harmonic_trips[self._current] += 1
            self.harmonic_trip_seconds[self._current] += now - t_prev
        return now


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _phase(log: Optional[PhaseLog], name: str, device):
    """Phase ``name`` of ``log``, or without one the phase's span alone."""
    if log is not None:
        return log.phase(name, device)
    return span("phase." + name)


def _trip(log: Optional[PhaseLog]):
    if log is not None:
        log.trip()


def _read(log: Optional[PhaseLog], fn, *args):
    """``fn(*args)``, a call that brings a value from the device to the
    host (``bool(t.any())``, ``torch.nonzero``), counted in ``log``."""
    if log is not None:
        log.read()
    return fn(*args)


def _clock(log: Optional[PhaseLog]):
    """The host clock where ``log`` times trips."""
    return None if log is None else time.perf_counter()


def _harmonic_trip(log: Optional[PhaseLog], t_prev):
    """Count a harmonic trip whose convergence read has just returned;
    returns the clock for the next."""
    return None if log is None else log.harmonic_trip(t_prev)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA's
    when a card is present) and write it as a Chrome trace
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto),
    with the program's ``hpfx.*`` spans (:func:`span`).  Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _has_nan(x) -> bool:
    if isinstance(x, float):
        return math.isnan(x)
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and bool(torch.isnan(x).any()))


class _NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation with a NaN in
    a floating-point output and none in its inputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(_has_nan(o) for o in tree_leaves(out)) and not any(
                _has_nan(a) for a in tree_leaves((args, kwargs))):
            raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` naming the first operation inside the
    block that makes a NaN: a NaN in a floating-point output from inputs
    (tensors and numbers) that hold none (the counterpart of
    ``jax_debug_nans``; the closest analogue of a sanitizer here).  The
    solvers' deliberate NaN padding (``err_hist``) is made by a fill with
    a NaN value, and passes on through operations whose inputs hold it,
    so a clean solve stays silent.  Each operation then syncs with the
    host, so use it to find a NaN, not in a timed run.  The port's
    ctypes kernels run outside the dispatcher: a NaN they make shows at
    the first operation that reads it.  With ``enable=False`` it does
    nothing."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield
