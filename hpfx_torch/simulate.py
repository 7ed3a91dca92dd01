"""Time-domain rectifier simulation: the device-characterization front end
(the port of :mod:`hpfx.simulate`).

Simulates a single-phase diode-bridge rectifier under a fundamental +
single-harmonic voltage source, FFTs one steady-state window, and
assembles the measurement sweep that the Norton-equivalent fits consume
(:mod:`hpfx_torch.ne_pipeline`): circuit → NE table → harmonic power flow
in one package.  The circuit, its split-exponential substep and the
measurement protocol are the JAX package's (see :mod:`hpfx.simulate` for
their derivation from the reference's Simulink models and sim_FFT.m):

    v_s --- R1 --- L1 ---+--- diode bridge ---+---+
                         |                    |   |
                       C_emi               C_dc  R_eq
                         |                    |   |
    ---------------------+--------------------+---+

The time loop runs in float64 and the supply in float32, as the JAX
package computes them (see :class:`SineSource`).  On the card the loop is
one CUDA kernel (``ops/csrc/rectifier.cu``, one thread a simulation, the
state in registers; the JAX package's ``lax.scan``), which evaluates the
supply itself, so the supply is given as parameters, :class:`SineSource`,
not as a Python function.  On the CPU the plain version runs: the same
substep over all simulations at once, in a Python time loop.  The FFT
stays on the host in numpy, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .ne_pipeline import MeasurementSet


@dataclasses.dataclass(frozen=True)
class RectifierParams:
    """Single-phase diode-bridge rectifier elements [SI units].

    ``v_drop``/``R_on`` default to the reference Simulink diode pair:
    every conduction path crosses two powerlib Diodes with Ron = 0.001 Ohm
    and Vf = 0.8 V, i.e. 0.002 Ohm and 1.6 V per bridge arm.
    """

    R1: float       # series resistance [Ohm]
    L1: float       # series inductance [H]
    C_emi: float    # EMI filter capacitance at the bridge input [F]
    C_dc: float     # DC-link capacitance [F]
    R_eq: float     # equivalent DC load [Ohm]
    v_drop: float = 1.6    # bridge forward drop, 2 x diode Vf [V]
    R_on: float = 0.002    # bridge on-resistance, 2 x diode Ron [Ohm]


def smps_params() -> RectifierParams:
    """The reference's SMPS circuit as actually simulated: SMPS.mdl's
    hardcoded branch values (L1 = 0.006e-6 H), which reproduce the
    shipped smps.mat measurement sweep to ~1e-3
    (``hpfx.simulate.smps_params``)."""
    return RectifierParams(R1=0.0179, L1=0.006e-6, C_emi=35.26e-6,
                           C_dc=0.0399, R_eq=15.11)


_EV_TABLE = {
    # model: (p_rated [kW], v_dc, X_C_dc_pu, X_C_emi_pu, X_L1_pu, R1_pu)
    "EV_1": (0.11, 315.0, 0.0258, 9.198, 3.17e-6, 0.0049),
    "EV_2": (0.12, 310.0, 0.0834, 12.58, 6.83e-5, 0.0028),
    "EV_4": (2.19, 300.0, 0.0796, 90.26, 6.01e-4, 0.0179),
    # EV_5 is the 3-phase car charger (sim_FFT.m:67-88): p_rated = 2.18 kW
    # per phase x 3; characterized per phase (see ev_protocol)
    "EV_5": (2.18 * 3, 305.0, 0.447, 601.0, 7.72e-4, 0.0356),
}

#: models whose reference characterization is three-phase: the
#: fundamental supply is divided by sqrt(3) (sim_FFT.m:82)
_EV_THREE_PHASE = frozenset({"EV_5"})


def ev_params(model: str, net_freq: float = 50.0) -> RectifierParams:
    """EV charger circuits from the Collin 2011/2014 per-unit tables
    (sim_FFT.m:37-88, per-unit conversion :91-139, R_eq from eq. 5.3)
    (``hpfx.simulate.ev_params``)."""
    if model not in _EV_TABLE:
        raise ValueError(f"unknown EV model {model!r}; have {list(_EV_TABLE)}")
    p_rated, v_dc, xcdc, xcemi, xl1, r1 = _EV_TABLE[model]
    v_base = 230.0
    p_base = p_rated * 1000.0
    i_base = p_base / v_base
    r_base = v_base / i_base
    omega = 2 * np.pi * net_freq
    return RectifierParams(
        R1=r1 * r_base,
        L1=xl1 * r_base / omega,
        C_dc=1.0 / (xcdc * r_base) / omega,
        C_emi=1.0 / (xcemi * r_base) / omega,
        R_eq=(0.006 * v_dc - 0.01) * r_base)


@dataclasses.dataclass(frozen=True)
class SweepProtocol:
    """The sim_FFT.m measurement protocol (:14-22, 141-152); the fields
    and defaults of ``hpfx.simulate.SweepProtocol``."""

    net_freq: float = 50.0
    fund_mags: Tuple[float, float] = (230.0 * np.sqrt(2),
                                      0.8 * 230.0 * np.sqrt(2))
    fund_phases_deg: Tuple[float, float] = (0.0, 10.0)
    #: odd harmonics 3..101 (sim_FFT.m:20-22, h_max = 5050)
    harm_freqs: Tuple[float, ...] = tuple(50.0 * h for h in range(3, 102, 2))
    harm_mags: Tuple[float, float] = (1.15 * np.sqrt(2), 2.3 * np.sqrt(2))
    harm_phase_deg: float = 20.0
    t_start: float = 0.06
    cycles: int = 1
    dt: float = 1e-6
    substeps: int = 4
    h_max: float = 5050.0
    #: fundamental (magnitude, phase) applied during the harmonic sims;
    #: None = measurement 1's values, which is what the NE math assumes
    harm_fund_mag: float = None
    harm_fund_phase_deg: float = None


def ev_protocol(model: str, **overrides) -> SweepProtocol:
    """Measurement protocol for an EV model: the default sweep, with the
    fundamental supply divided by sqrt(3) for the 3-phase EV_5."""
    proto = SweepProtocol(**overrides)
    if model in _EV_THREE_PHASE:
        proto = dataclasses.replace(
            proto, fund_mags=tuple(v / np.sqrt(3.0) for v in proto.fund_mags))
    return proto


#: glibc's ``sinf`` (sysdeps/ieee754/flt-32/s_sinf.c), which is what the
#: JAX package's float32 ``sin`` computes on the CPU, the platform its
#: shipped EV tables were made on: 2/pi scaled by 2^24, pi/2 split in two
#: parts whose products with a quadrant count are exact, pi/2^63, the
#: polynomials' coefficients and the bits of 4/pi
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI_HI = float.fromhex("0x1.921fb54p+0")
_HPI_LO = float.fromhex("0x1.10b46p-30")
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
_SINF_C = tuple(float.fromhex(c) for c in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SINF_S = tuple(float.fromhex(c) for c in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
#: the top 12 bits of |y| (exponent and 3 mantissa bits) below which
#: sinf takes its small, fast and large paths: pi/4, 2^-12 and 120
_TOP_PIO4, _TOP_TINY, _TOP_120 = 0x3f4, 0x398, 0x42f


def _sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``sinf`` of a float32 tensor, bit for bit: the
    argument reduced in float64 (directly below 120, through the bits of
    4/pi above), then an odd or even polynomial in float64, rounded to
    float32.  The reduction ``x - n·pi/2`` is glibc's fused multiply-add,
    done exactly by splitting pi/2; ``rectifier.cu`` computes the same."""
    where = torch.where
    x = y.double()
    bits = y.view(torch.int32).to(torch.int64) & 0xffffffff
    top = (bits >> 20) & 0x7ff
    small, fast = top < _TOP_PIO4, top < _TOP_120
    # below 120: the nearest quadrant of x, from x·(2/pi)·2^24
    xc = where(fast, x, 0.0)
    n_f = ((xc * _HPI_INV).to(torch.int32).to(torch.int64) + 0x800000) >> 24
    x_f = (xc - n_f.double() * _HPI_HI) - n_f.double() * _HPI_LO
    # above: the 62 bits of x·4/pi after its integer part, in integers
    inv = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (bits >> 26) & 15
    m = (((bits & 0xffffff) | 0x800000) << ((bits >> 23) & 7))
    r0 = (m * inv[idx]) & 0xffffffff
    r0 = (((m * inv[idx + 8]) >> 32) & 0xffffffff) | (r0 << 32)
    r0 = r0 + m * inv[idx + 4]
    n_l = ((r0 + (1 << 61)) >> 62) & 3
    x_l = (r0 - (n_l << 62)).double() * _PI63
    n = where(small, 0, where(fast, n_f, n_l))
    q = where(fast, n, n + (bits >> 31))     # the quadrant, with the sign
    xr = where(small, x, where(fast, x_f, x_l))
    # glibc's sign table {1, -1, -1, 1}, and its second table's cos
    # coefficients negated in quadrants 2 and 3
    xs = xr * (1.0 - 2.0 * (((q + 1) >> 1) & 1).double())
    flip = 1.0 - 2.0 * ((q >> 1) & 1).double()
    x2 = xr * xr
    S1, S2, S3 = _SINF_S
    C0, C1, C2, C3, C4 = (flip * c for c in _SINF_C)
    x3 = xs * x2
    sin_p = (xs + x3 * S1) + (x3 * x2) * (S2 + x2 * S3)
    x4 = x2 * x2
    cos_p = ((C0 + x2 * C1) + x4 * C2) + (x4 * x2) * (C3 + x2 * C4)
    out = where((n & 1) == 0, sin_p, cos_p).float()
    return where(top < _TOP_TINY, y, out)


#: 2π rounded to float32, as the JAX package's sweep multiplies it
_TWO_PI_F32 = float(np.float32(2 * np.pi))


def _fmaf(a, b, c):
    """The float32 fused multiply-add of float32 values, through float64
    (the product is exact there)."""
    return (a.double() * b.double() + c.double()).float()


class SineSource(NamedTuple):
    """The supply of S simulations, v(t) = a1·sin(w1·t + p1) +
    a2·sin(2π·f2·t + p2): six (S,) float64 tensors on the device the
    simulations run on (amplitudes in V, ``w1`` in rad/s, ``f2`` in Hz,
    phases in rad), every one but ``w1`` a float32 value.  Build it with
    :meth:`from_degrees` or :func:`sweep_source`.

    It is evaluated as the JAX package's measurement sweep evaluates it
    (``hpfx.simulate.characterize_rectifier``, vmapped over the sweep's
    simulations, on the CPU), in float32: there the sweep parameters are
    float32 and the time axis is weakly typed, so ``f32(w1·t) + p1`` is
    float32; XLA turns ``(2π·f2)·t`` into ``f2·(2π·t)`` with ``2π·t`` a
    float32 product shared by the batch; ``sin`` is glibc's ``sinf``; and
    the harmonic's phase and the sum ``a1·sin(.) + a2·sin(.)`` are fused
    multiply-adds."""
    a1: torch.Tensor
    w1: torch.Tensor
    p1: torch.Tensor
    a2: torch.Tensor
    f2: torch.Tensor
    p2: torch.Tensor

    @classmethod
    def from_degrees(cls, a1, ph1_deg, a2, f2, ph2_deg, net_freq=50.0,
                     device=None) -> "SineSource":
        """The supply of simulations given as the JAX package's sweep
        passes them: amplitudes, phases in degrees and the harmonic's
        frequency, one value a simulation, rounded to float32 (the phases
        converted in float32, the fundamental's 2π·f in float64)."""
        a1, ph1, a2, f2, ph2 = (np.atleast_1d(np.asarray(x, np.float32))
                                for x in (a1, ph1_deg, a2, f2, ph2_deg))
        d2r = np.float32(np.pi / 180)
        cols = (a1, np.full(a1.shape, 2 * np.pi * net_freq), ph1 * d2r,
                a2, f2, ph2 * d2r)
        dv = resolve_device(device)
        return cls(*(torch.as_tensor(c.astype(np.float64), device=dv)
                     for c in cols))

    def __call__(self, t):
        """v at the float64 times ``t`` (a tensor of any shape), float32,
        of shape (S,) + t.shape."""
        t = torch.as_tensor(t, dtype=torch.float64, device=self.a1.device)
        a1, w1, p1, a2, f2, p2 = (x.reshape(x.shape + (1,) * t.ndim)
                                  for x in self)
        arg1 = (w1 * t).float() + p1.float()
        arg2 = _fmaf(f2, _TWO_PI_F32 * t.float(), p2)
        return _fmaf(a1, _sinf(arg1), a2.float() * _sinf(arg2))


def bridge_current(params: RectifierParams, state):
    """Instantaneous bridge (rectifier-input) current, the signal the
    reference's current scope measures (``hpfx.simulate.bridge_current``);
    ``state`` = (i_l, v_e, v_dc) tensors."""
    i_l, v_e, v_dc = state
    over = torch.abs(v_e) - v_dc - params.v_drop
    return torch.sign(v_e) * torch.clamp_min(over, 0.0) / params.R_on


def _rectifier_step(params: RectifierParams, dt: float):
    """One split-exponential substep of the rectifier circuit ODE
    (``hpfx.simulate._rectifier_step``, operation for operation): every
    subsystem advances by its exact linear solution under frozen
    couplings, so the stiff bridge clamp (R_on·C_emi of 1.3-70 ns) is
    stable at any substep."""
    tau = params.R_on * params.C_emi
    e_dc = math.exp(-dt / (params.R_eq * params.C_dc))
    el = math.exp(-dt * params.R1 / params.L1)
    where = torch.where

    def step(state, v_s0, v_s1):
        i_l, v_e, v_dc = state
        thr = v_dc + params.v_drop
        one, zero = torch.ones_like(v_e), torch.zeros_like(v_e)

        # EMI node: blocking drift (sign-free; v_e may cross zero)
        v_drift = v_e + dt * i_l / params.C_emi
        # conduction polarity at substep start, else after a drift crossing
        s0 = where(v_e >= thr, one, where(v_e <= -thr, -one, zero))
        s_x = where(v_drift > thr, one, where(v_drift < -thr, -one, zero))
        started = s0 != 0.0
        s_eff = where(started, s0, s_x)
        conducting = s_eff != 0.0
        s = where(conducting, s_eff, one)
        # turn-on event: fraction of the substep spent blocking
        db = v_drift - v_e
        db_safe = where(torch.abs(db) > 1e-30, db, 1e-30 * one)
        theta = where(started, zero,
                      torch.clamp((s * thr - v_e) / db_safe, 0.0, 1.0))
        h_c = where(conducting, (1.0 - theta) * dt, zero)
        # exact clamp exponential in u = s·v_e coordinates
        u0 = where(started, s * v_e, thr)
        u_star = thr + params.R_on * s * i_l
        u_end = u_star + (u0 - u_star) * torch.exp(-h_c / tau)
        v_e_new = where(conducting, s * u_end, v_drift)
        # conducted charge, exactly, from C_emi flux balance over [theta, 1]
        q_c = where(conducting,
                    s * i_l * h_c - params.C_emi * (u_end - u0), zero)
        q_c = torch.clamp_min(q_c, 0.0)   # O(dt) turn-off inside the substep
        # DC link: exact leak + impulse charge
        v_dc_new = v_dc * e_dc + q_c / params.C_dc
        # series branch: exact R1/L1 exponential toward the average drive
        # (the supply's average in float32, as the JAX package forms it)
        drive = (0.5 * (v_s0 + v_s1) - 0.5 * (v_e + v_e_new)) / params.R1
        i_l_new = i_l * el + (1.0 - el) * drive
        return i_l_new, v_e_new, v_dc_new

    return step


#: steps whose supply the plain version evaluates at once
_REF_BLOCK = 256


def _simulate_ref(params: RectifierParams, source: SineSource, n1: int,
                  dt: float, substeps: int):
    """The plain version of ``rectifier_kernel``: the substep over all S
    simulations at once, in a Python time loop of ``n1`` steps, the supply
    of _REF_BLOCK steps evaluated at a time.  Returns (i, v), each (S, n1)
    float64."""
    h = dt / substeps
    step = _rectifier_step(params, h)
    dev = source.a1.device
    state = (torch.zeros_like(source.a1),) * 3
    i_out = torch.empty((source.a1.shape[0], n1), dtype=torch.float64,
                        device=dev)
    v_out = torch.empty_like(i_out)
    kh = torch.arange(substeps, dtype=torch.float64, device=dev) * h
    for b0 in range(0, n1, _REF_BLOCK):
        t0 = torch.arange(b0, min(b0 + _REF_BLOCK, n1), dtype=torch.float64,
                          device=dev) * dt
        tk = t0[:, None] + kh                 # the substeps' start times
        v_s0, v_s1 = source(tk), source(tk + h)
        v_out[:, b0:b0 + len(t0)] = source(t0)
        for j in range(len(t0)):
            i = b0 + j
            i_out[:, i] = bridge_current(params, state)
            if i + 1 == n1:
                break                    # the last step's state is unused
            for k in range(substeps):
                state = step(state, v_s0[:, j, k], v_s1[:, j, k])
    return i_out, v_out


def _launch_rectifier(params: RectifierParams, source: SineSource, n1: int,
                      dt: float, substeps: int):
    """``rectifier_kernel`` on the current stream: raises if the build or
    the launch fails."""
    from .ops import batched_solve as bs
    from .ops._build import load_library
    src = torch.stack(list(source)).contiguous()              # (6, S)
    S = src.shape[1]
    i_out = torch.empty((S, n1), dtype=torch.float64, device=src.device)
    v_out = torch.empty_like(i_out)
    h = dt / substeps
    lib = load_library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = lib.hpfx_rectifier(
            ctypes.c_void_p(src.data_ptr()),
            ctypes.c_void_p(i_out.data_ptr()),
            ctypes.c_void_p(v_out.data_ptr()), S, n1, substeps,
            params.v_drop, params.R_on, params.C_emi, params.C_dc,
            params.R1, params.R_on * params.C_emi,
            math.exp(-h * params.R1 / params.L1),
            math.exp(-h / (params.R_eq * params.C_dc)), h, dt,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"rectifier kernel launch failed (cudaError {err}: "
            f"{lib.hpfx_error_string(err).decode()}) at S={S}, n={n1}")
    bs._count_launch("rectifier_kernel", (S, n1, substeps))
    return i_out, v_out


def simulate_rectifier(params: RectifierParams, source: SineSource,
                       t_end: float, dt: float = 1e-6, substeps: int = 4):
    """Integrate the rectifier circuit for every simulation of ``source``
    (``hpfx.simulate.simulate_rectifier``, whose ``source_fn(t)`` is here
    a :class:`SineSource`); returns (i_inj, v_source), each (S, n + 1)
    float64 sampled at ``dt`` (n = round(t_end / dt)), ``i_inj`` the
    bridge current.  A CUDA source launches ``rectifier_kernel``; a CPU
    one runs the plain version."""
    source = SineSource(*(torch.atleast_1d(torch.as_tensor(
        x, dtype=torch.float64)) for x in source))
    n1 = int(round(t_end / dt)) + 1
    if source.a1.is_cuda:
        return _launch_rectifier(params, source, n1, dt, substeps)
    return _simulate_ref(params, source, n1, dt, substeps)


def _fft_window(signal: np.ndarray, n_keep: int):
    """Reference FFT post-processing (sim_FFT.m:174-191): single-sided
    magnitude with interior doubling, +pi/2 phase, truncated spectrum."""
    L = len(signal)
    ft = np.fft.fft(np.asarray(signal))
    mag = np.abs(ft / L)[: L // 2 + 1]
    mag[1:-1] *= 2.0
    phase = np.angle(ft[: L // 2 + 1]) + np.pi / 2
    return mag[:n_keep], phase[:n_keep]


def sweep_source(protocol: SweepProtocol, device=None) -> SineSource:
    """The supply of every simulation of the measurement sweep: two
    fundamental-only sims, then the (harmonic frequency x magnitude) grid
    (``hpfx.simulate.characterize_rectifier``'s order)."""
    p = protocol
    sims = []
    for k in range(2):
        sims.append((p.fund_mags[k], p.fund_phases_deg[k], 0.0, 0.0, 0.0))
    hf_mag = p.fund_mags[0] if p.harm_fund_mag is None else p.harm_fund_mag
    hf_ph = (p.fund_phases_deg[0] if p.harm_fund_phase_deg is None
             else p.harm_fund_phase_deg)
    for fh in p.harm_freqs:
        for vh in p.harm_mags:
            sims.append((hf_mag, hf_ph, vh, fh, p.harm_phase_deg))
    return SineSource.from_degrees(*zip(*sims), net_freq=p.net_freq,
                                   device=device)


def characterize_rectifier(params: RectifierParams,
                           protocol: SweepProtocol = SweepProtocol(),
                           device=None) -> MeasurementSet:
    """Run the full measurement sweep and assemble a MeasurementSet
    (``hpfx.simulate.characterize_rectifier``).  Every simulation of the
    sweep runs in one call of :func:`simulate_rectifier`, on ``device``
    (default: the CUDA card, one kernel launch)."""
    p = protocol
    f = p.net_freq
    t_win = p.cycles / f
    t_end = p.t_start + t_win
    L = int(round(t_win / p.dt))
    n_keep = int(round(p.cycles * p.h_max / f)) + 1
    i0 = int(round(p.t_start / p.dt))

    i_all, _ = simulate_rectifier(params, sweep_source(p, device), t_end,
                                  p.dt, p.substeps)
    i_all = i_all.cpu().numpy()

    # FFT bin frequencies: f/cycles spacing (sim_FFT.m:147 H = (0:L/2)/L/T)
    spectrum = np.arange(n_keep) / (L * p.dt)

    def inj(idx):
        mag, ph = _fft_window(i_all[idx, i0:i0 + L], n_keep)
        return mag * np.exp(1j * ph)

    n_f = len(p.harm_freqs)
    n_m = len(p.harm_mags)
    fund_V = np.array([
        p.fund_mags[k] * np.exp(1j * np.deg2rad(p.fund_phases_deg[k]))
        for k in range(2)])
    fund_I = np.stack([inj(k) for k in range(2)])
    harm_V = np.array([[vm * np.exp(1j * np.deg2rad(p.harm_phase_deg))
                        for vm in p.harm_mags]] * n_f)
    harm_I = np.stack([
        [inj(2 + i * n_m + j) for j in range(n_m)] for i in range(n_f)])
    return MeasurementSet(
        spectrum=spectrum, fund_V=fund_V, fund_I=fund_I,
        harm_freqs=np.asarray(p.harm_freqs, float),
        harm_V=harm_V, harm_I=harm_I,
        net_freq=f, cycles=p.cycles)
