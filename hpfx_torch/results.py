"""Post-processing: distortion metrics and structured results (the port
of :mod:`hpfx.results`; reference get_THD, hcne_generalized.py:563-572)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class THD(NamedTuple):
    THD_F: torch.Tensor  # relative to fundamental
    THD_R: torch.Tensor  # relative to RMS


def get_thd(V_m: torch.Tensor) -> THD:
    """Total harmonic distortion per bus from the (H, ...) magnitude
    tensor: THD_F = sqrt(sum_{h>=3} V²)/V(h=1), THD_R = sqrt(sum_{h>=3}
    V²)/sqrt(sum_all V²)."""
    harm = torch.sqrt(torch.sum(V_m[1:] ** 2, dim=0))
    total = torch.sqrt(torch.sum(V_m ** 2, dim=0))
    return THD(THD_F=harm / V_m[0], THD_R=harm / total)


def voltage_phasors(V_m, V_a) -> np.ndarray:
    """Complex phasors V_m·e^{j·V_a} on the host (numpy complex); device
    code stays split-complex."""
    V_m = V_m.cpu().numpy() if isinstance(V_m, torch.Tensor) else V_m
    V_a = V_a.cpu().numpy() if isinstance(V_a, torch.Tensor) else V_a
    return np.asarray(V_m) * np.exp(1j * np.asarray(V_a))


def waveform(V_m, V_a, harmonics, n_samples: int = 1024):
    """One period of the time signal of an (H, ...) polar spectrum,
    ``(theta, v)`` with v(θ) = √2·Σ_h V_h·cos(hθ + φ_h) (pu magnitudes are
    RMS phasors) and v of shape (n_samples, ...): two (T, H)·(H, ...)
    contractions of cos(hθ+φ) expanded."""
    rd, dv = V_m.dtype, V_m.device
    h = torch.as_tensor(harmonics, dtype=rd, device=dv)
    theta = torch.arange(n_samples, dtype=rd, device=dv) \
        * (2.0 * math.pi / n_samples)
    c, s = torch.cos(torch.outer(theta, h)), torch.sin(torch.outer(theta, h))
    v = math.sqrt(2.0) * (torch.tensordot(c, V_m * torch.cos(V_a), dims=1)
                          - torch.tensordot(s, V_m * torch.sin(V_a), dims=1))
    return theta, v


class WaveformMetrics(NamedTuple):
    """``rms`` (true, all harmonics), ``peak`` (max |v| over the period),
    ``crest`` = peak/rms (√2 for a clean sine), ``form`` = rms/mean|v|
    (π/(2√2) ≈ 1.111 for a sine)."""
    rms: torch.Tensor
    peak: torch.Tensor
    crest: torch.Tensor
    form: torch.Tensor


def waveform_metrics(V_m, V_a, harmonics,
                     n_samples: int = 2048) -> WaveformMetrics:
    """Crest and form factors and true RMS per bus of (H, ...) spectra:
    RMS from Parseval, peak and mean |v| from :func:`waveform`."""
    rms = torch.sqrt(torch.sum(V_m * V_m, dim=0))
    _, v = waveform(V_m, V_a, harmonics, n_samples)
    peak = v.abs().amax(dim=0)
    mean_abs = v.abs().mean(dim=0)
    tiny = torch.finfo(rms.dtype).tiny
    return WaveformMetrics(rms=rms, peak=peak,
                           crest=peak / torch.clamp_min(rms, tiny),
                           form=rms / torch.clamp_min(mean_abs, tiny))


class HPFReport(NamedTuple):
    """A single case's results as data: voltages, THD, iteration counts,
    residuals and the residual history."""
    harmonics: tuple
    V_m: torch.Tensor
    V_a: torch.Tensor
    thd: THD
    n_iter_fund: int
    n_iter_harm: int
    err_fund: float
    err_harm: float
    converged: bool
    residual_history: torch.Tensor  # (max_iter_h,), NaN-padded


def report(result, settings) -> HPFReport:
    """Summarize a single-case ``HPFResult``."""
    fund = result.fund
    return HPFReport(
        harmonics=tuple(settings.harmonics),
        V_m=result.V_m, V_a=result.V_a, thd=get_thd(result.V_m),
        n_iter_fund=int(fund.n_iter) if fund is not None else -1,
        n_iter_harm=int(result.n_iter),
        err_fund=float(fund.err) if fund is not None else float("nan"),
        err_harm=float(result.err),
        converged=bool(result.converged),
        residual_history=result.err_hist)
