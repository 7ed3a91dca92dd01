"""Utilities of the port (``hpfx.utils`` without ``backend_guard`` and the
compilation cache, which are workarounds for the TPU's runtime)."""
from .precision import highest_precision
from .profiling import debug_nans, profile_trace
from .timing import PhaseTimer

__all__ = [
    "highest_precision",
    "PhaseTimer",
    "debug_nans",
    "profile_trace",
]
