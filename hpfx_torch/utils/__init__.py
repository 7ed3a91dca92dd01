"""Utilities of the port (``hpfx.utils`` without ``backend_guard`` and the
compilation cache, which are workarounds for the TPU's runtime, and
without ``PhaseTimer``, whose place ``PhaseLog`` takes, beside the spans
in :mod:`.profiling`)."""
from .precision import highest_precision
from .profiling import debug_nans, profile_trace

__all__ = [
    "highest_precision",
    "debug_nans",
    "profile_trace",
]
