"""Solver-state checkpointing and warm starts (the port of
:mod:`hpfx.checkpoint`): :func:`save_result` / :func:`load_result` write
and read an ``HPFResult`` as a ``.npz`` archive with the JAX package's
keys, so an archive written by either package loads in the other, and
:func:`warm_start` turns a result into a ``V0`` start."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._device import resolve_device
from .harmonic import HPFResult

_KEYS = ("V_m", "V_a", "err", "n_iter", "err_hist", "converged")


def save_result(path: str, result: HPFResult) -> None:
    """Write the result's voltages, residuals and convergence data."""
    np.savez(path, **{k: getattr(result, k).detach().cpu().numpy()
                      for k in _KEYS})


def load_result(path: str, device=None) -> HPFResult:
    """Read an archive of :func:`save_result` (or of the JAX package's)
    onto ``device`` (default: the CUDA card); ``fund`` is None."""
    dv = resolve_device(device)
    d = np.load(path)
    return HPFResult(*(torch.as_tensor(d[k], device=dv) for k in _KEYS),
                     fund=None)


def warm_start(result: HPFResult) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V_m, V_a) warm start from a previous solution."""
    return result.V_m, result.V_a
