"""Matmul-precision control (``hpfx.utils.precision``).

On Hopper a float32 matmul may run in TF32, which keeps ~3 decimal
digits: Newton-Raphson then stalls at a residual floor above the
harmonic threshold.  Importing ``hpfx_torch`` already turns TF32 off;
:func:`highest_precision` holds a call to full precision whatever the
caller set in between."""
from __future__ import annotations

import functools

import torch


def highest_precision(fn):
    """Decorator: run ``fn`` with ``torch.set_float32_matmul_precision(
    "highest")`` (no TF32 in float32 matmuls) and cuDNN's TF32 off,
    restoring both afterwards.  The matmul setting goes through the
    precision API alone: in this torch, setting the legacy
    ``cuda.matmul.allow_tf32`` flag beside it makes reading the precision
    raise."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = (torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32)
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.allow_tf32 = prev[1]
            torch.set_float32_matmul_precision(prev[0])

    return wrapped
