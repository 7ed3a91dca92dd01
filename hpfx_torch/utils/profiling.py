"""Profiling hooks (``hpfx.utils.profiling``): a ``torch.profiler`` trace
in place of ``jax.profiler``'s, the program's own spans in it, and a NaN
check on every operation in place of ``jax_debug_nans``.

The sweep path opens a span (:func:`span`) around each entry call
(``hpfx.sweep``), each phase of a sweep (``hpfx.phase.<name>``, the
names of :class:`hpfx_torch.lanes.PhaseLog`), each fundamental and
harmonic Newton trip (``hpfx.fund_trip``, ``hpfx.trip``), each stage of
a harmonic trip (``hpfx.trip.mismatch``, ``.blocks``, ``.block_solve``,
``.capacitance``, ``.backsub``, ``.update``, ``.read``), each batched
solve (``hpfx.solve``) and each collective of a mesh (``hpfx.gather``).
A span is a ``record_function`` on the profiler's clock, the clock of
its device records, so a trace puts every kernel and every idle gap of
the card down to the span whose host code launched or waited for it.
With no profiler recording, a span costs a flag read and a branch."""
from __future__ import annotations

import contextlib
import functools
import math
import os

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
