"""Single cases and batched scenario sweeps: the port of the entry points
of :mod:`hpfx.solve`.

:func:`hpf_single` solves one case.  :func:`hpf_sweep` solves a batch in
one of two layouts: lane-major (``hpfx_torch.lanes``, the arrow solver)
or batch-major, the JAX package's ``vmap`` layout
(:func:`_hpf_sweep_vmap`), which takes every configuration.
:func:`hpf_sweep_device` is the net2 main path: the adaptive lane-major
sweep (:func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes`) followed, only
when lanes remain unconverged, by the deterministic host-driven rescue
(:func:`_rescue_sweep`), whose last pass re-solves the remaining
stragglers in float64 on the same device (:func:`_f64_resolve`).
:func:`hpf_sweep_stream` runs it over a stream of batches.
:func:`hpf_sweep_adaptive` is the host-driven two-phase schedule of the
net1-class sweeps, ending in the same rescue; :func:`hpf_sweep_continuation`
runs it (or :func:`hpf_sweep`) in key-sorted warm-started stages, and
:func:`hpf_sweep_kron` sweeps with the passive buses Kron-reduced out.

Every sweep takes a Norton :class:`DeviceSet`, an
:class:`AnalyticDeviceSet`, or a :class:`DeviceLibrary` with
``Scenarios.device_mix``; ``Y`` overrides the admittances and ``I_bg``
adds per-scenario background injections wherever the JAX package's
counterpart takes them.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings
from .cx import Cx
from .devices import DeviceLibrary, check_devices
from .fundamental import FundResult, solve_fundamental
from .harmonic import HPFResult, solve_harmonic
from .lanes import (hpf_sweep_adaptive_lanes, hpf_sweep_lanes,
                    supports_lanes)
from .network import Network
from .results import get_thd
from .utils.profiling import PhaseLog, _phase, _read, _sync, _trip, spanned
from .ybus import build_ybus, line_ybus_pair, resolve_ybus


class Scenarios(NamedTuple):
    """Per-scenario multipliers over a batch of B cases: ``p_scale`` /
    ``q_scale`` (B,) or (B, n) bus load scaling, ``injection_scale`` (B,)
    or (B, n_nl) device scaling (per scenario or per device), and
    ``device_mix`` (B, n_nl, T), per-bus blend weights over the T types
    of a :class:`DeviceLibrary` passed as the sweep's devices (mixed
    first, then scaled)."""
    p_scale: torch.Tensor
    q_scale: Optional[torch.Tensor] = None
    injection_scale: Optional[torch.Tensor] = None
    device_mix: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.p_scale.shape[0]

    def to(self, *args, **kwargs) -> "Scenarios":
        """Every given field through ``Tensor.to(*args, **kwargs)``."""
        return Scenarios(*(None if x is None else x.to(*args, **kwargs)
                           for x in self))

    @staticmethod
    def uniform(b: int, dtype=torch.float32, device=None) -> "Scenarios":
        """All-ones scales on ``device`` (default: the CUDA card,
        :func:`hpfx_torch._device.resolve_device`)."""
        one = torch.ones((b,), dtype=dtype, device=resolve_device(device))
        return Scenarios(one, one, one)


def _check_mix(devices, scenarios) -> None:
    check_devices(devices, library=True)
    if (scenarios.device_mix is not None) != isinstance(devices,
                                                         DeviceLibrary):
        raise ValueError(
            "Scenarios.device_mix requires passing a DeviceLibrary as "
            "devices (and a DeviceLibrary requires a device_mix to assign "
            "types to buses)")


def hpf_single(net: Network, devices, settings: Settings,
               I_bg=None) -> HPFResult:
    """Single-case harmonic power flow (``hpfx.solve.hpf_single``): the
    admittances and, with ``settings.stable_mismatch``, their line
    structure, then the fundamental and the harmonic Newton solves.
    ``I_bg``: optional (H, n) background injections
    (``hpfx_torch.background``)."""
    Y = build_ybus(net, settings)
    lineY, lineY_f = line_ybus_pair(net, settings)
    fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net, devices, settings, lineY=lineY,
                          I_bg=I_bg)


def hpf_sweep(net: Network, devices, settings: Settings,
              scenarios: Scenarios, V0=None, Y=None, I_bg=None,
              log: Optional[PhaseLog] = None) -> HPFResult:
    """Solve B independent HPF cases; returns a batch-major
    :class:`HPFResult`.

    ``devices``: a DeviceSet or AnalyticDeviceSet, or a DeviceLibrary
    when ``scenarios.device_mix`` assigns types to buses (either without
    the other raises ``ValueError``).  ``V0``: optional batch-major
    (V_m, V_a) warm starts.  ``Y``: an admittance override, a dense Cx
    (the stable mismatch then off) or a (Y, lineY, lineY_f) triple.
    ``I_bg``: optional per-scenario (B, H, n) background injections.

    ``settings.layout`` picks the layout, on either device as the JAX
    package picks it on its TPU: "vmap" the batch-major loop
    (:func:`_hpf_sweep_vmap`); "lanes" and "auto" the lane-major path
    where it applies (:func:`hpfx_torch.lanes.supports_lanes`: the arrow
    solver with devices), the batch-major loop otherwise.  ``log`` counts
    the Newton loop trips (fundamental and harmonic) in its current
    phase."""
    _check_mix(devices, scenarios)
    if settings.layout != "vmap" and supports_lanes(devices, settings, net):
        return hpf_sweep_lanes(net, devices, settings, scenarios, V0=V0,
                               Y=Y, I_bg=I_bg, log=log)
    res = _hpf_sweep_vmap(net, devices, settings, scenarios, V0=V0, Y=Y,
                          I_bg=I_bg)
    if log is not None:
        # the batch-major loops run as many trips as their longest scenario
        for _ in range(int(res.fund.n_iter.max()) + int(res.n_iter.max())):
            _trip(log)
    return res


def _hpf_sweep_vmap(net: Network, devices, settings: Settings,
                    scenarios: Scenarios, V0=None, Y=None,
                    I_bg=None) -> HPFResult:
    """The JAX package's ``vmap`` layout (``hpfx.solve._solve_scenario``
    under ``vmap``) as a batch-major loop: the single-case solvers run on
    (B, ...) tensors, and each scenario stops updating when its own test
    fails, as JAX's while-loop batching rule does; ``n_iter`` and
    ``err_hist`` are per scenario.  The Newton solves see the whole batch
    on every iteration, converged scenarios included."""
    Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    # batch-major (B, n) loads and the devices mixed and scaled per scenario
    p = scenarios.p_scale
    q = scenarios.q_scale if scenarios.q_scale is not None else p
    inj = scenarios.injection_scale
    if inj is None:
        inj = torch.ones_like(p)
    col = lambda x: (x[:, None] if x.dim() == 1 else x).to(net.bus_P.dtype)
    net_s = dataclasses.replace(net, bus_P=net.bus_P * col(p),
                                bus_Q=net.bus_Q * col(q))
    if scenarios.device_mix is not None:
        devices = devices.mixed(scenarios.device_mix)
    dev_s = devices.scale(col(inj))
    fund = solve_fundamental(Y[..., 0, :, :], net_s, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net_s, dev_s, settings, V0=V0,
                          lineY=lineY, I_bg=I_bg)


def _take_scen(scenarios: Scenarios, idx) -> Scenarios:
    return Scenarios(*(None if x is None else x[idx] for x in scenarios))


def _take_bg(I_bg, idx):
    return None if I_bg is None else Cx(I_bg.re[idx], I_bg.im[idx])


def _cast_result(r: HPFResult, dtype) -> HPFResult:
    """Cast every floating tensor of a result (fund included) to dtype."""
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    fund = None if r.fund is None else FundResult(*map(cast, r.fund))
    traj = None if r.trajectory is None else cast(r.trajectory)
    return HPFResult(*map(cast, r[:6]), fund=fund, trajectory=traj)


def _to64(x):
    """``x`` with every floating tensor in float64: a Cx, a (Y, lineY,
    lineY_f) triple, or None."""
    f64 = torch.float64
    if x is None or isinstance(x, Cx):
        return None if x is None else x.to(f64)

    def line(L):
        return None if L is None else L._replace(
            Ys=L.Ys.to(f64), a_ff=L.a_ff.to(f64), inv_tau=L.inv_tau.to(f64),
            shift=L.shift.to(f64), d=L.d.to(f64))

    Yd, lineY, lineY_f = x
    return Yd.to(f64), line(lineY), line(lineY_f)


def _f64_resolve(net: Network, devices, settings: Settings,
                 sub: Scenarios, Y=None, I_bg=None,
                 log: Optional[PhaseLog] = None) -> HPFResult:
    """Re-solve a (small) scenario subset cold in float64 on the same
    device.  The knife-edge f32 class converges in f64 on the same draws,
    so the last rescue resort is more precision.  ``converged`` reflects
    the f64 criterion; the result is cast back to the caller's dtype.
    ``Y`` and ``I_bg`` (the subset's rows) are re-solved in float64 too."""
    f64 = torch.float64
    r = hpf_sweep(net.to(dtype=f64), devices.to(dtype=f64),
                  settings.with_(dtype="float64"), sub.to(f64),
                  Y=_to64(Y), I_bg=_to64(I_bg), log=log)
    return _cast_result(r, settings.real_dtype)


def _put(full, idx, val):
    out = full.clone()
    out[idx] = val
    return out


def _bucket_pending(converged, B: int, log: Optional[PhaseLog] = None):
    """Indices of unconverged scenarios padded, with repeats of the first,
    to the next power of two (at most B); None when all converged.  One
    host read, counted in ``log``."""
    pend = _read(log, torch.nonzero, ~converged).flatten()
    if pend.numel() == 0:
        return None
    bucket = min(1 << (pend.numel() - 1).bit_length(), B)
    return torch.cat([pend, pend[:1].expand(bucket - pend.numel())])


def _rescue_sweep(settings: Settings, scenarios: Scenarios, out: HPFResult,
                  run, run64=None, take=None,
                  log: Optional[PhaseLog] = None) -> HPFResult:
    """Deterministic straggler rescue (``hpfx.solve._rescue_sweep``):
    re-solve unconverged scenarios with a fresh budget, first warm from
    their own final state (flat where it went non-finite), then from the
    cold flat start; ``run64`` re-solves what survives both in float64.
    ``take(idx)`` selects the batch carrier's rows (default: the
    scenarios'); ``run(take(idx), V0)`` and ``run64(take(idx))`` return
    batch-major results.  Each pass that finds lanes pending is a phase
    of ``log``: "rescue_self", "rescue_cold", "rescue_float64"."""
    if take is None:
        take = lambda idx: _take_scen(scenarios, idx)  # noqa: E731

    def merge(out, idx, res_r):
        return out._replace(
            V_m=_put(out.V_m, idx, res_r.V_m),
            V_a=_put(out.V_a, idx, res_r.V_a),
            err=_put(out.err, idx, res_r.err),
            n_iter=_put(out.n_iter, idx, out.n_iter[idx] + res_r.n_iter),
            err_hist=_put(out.err_hist, idx, res_r.err_hist),
            converged=_put(out.converged, idx, res_r.converged))

    B, dv = out.V_m.shape[0], out.V_m.device
    flat_m = torch.full(out.V_m.shape[1:], settings.v_init_h,
                        dtype=out.V_m.dtype, device=dv)
    flat_m[0] = settings.v_init_f
    flat_a = torch.full_like(flat_m, settings.a_init_h)
    flat_a[0] = settings.a_init_f
    for use_self in (True, False):
        idx = _bucket_pending(out.converged, B, log)
        if idx is None:
            return out
        with _phase(log, "rescue_self" if use_self else "rescue_cold", dv):
            if use_self:
                Vm0, Va0 = out.V_m[idx], out.V_a[idx]
                finite = (torch.isfinite(Vm0).flatten(1).all(dim=1)
                          & torch.isfinite(Va0).flatten(1).all(dim=1))
                Vm0 = torch.where(finite[:, None, None], Vm0, flat_m)
                Va0 = torch.where(finite[:, None, None], Va0, flat_a)
            else:
                Vm0 = flat_m.expand((idx.numel(),) + flat_m.shape)
                Va0 = flat_a.expand((idx.numel(),) + flat_a.shape)
            out = merge(out, idx, run(take(idx), (Vm0, Va0)))
    if run64 is not None and settings.real_dtype != torch.float64:
        idx = _bucket_pending(out.converged, B, log)
        if idx is not None:
            with _phase(log, "rescue_float64", dv):
                out = merge(out, idx, run64(take(idx)))
    return out


def _host_rescue(net: Network, devices, settings: Settings,
                 scenarios: Scenarios, out: HPFResult, Y=None, I_bg=None,
                 log: Optional[PhaseLog] = None) -> HPFResult:
    """:func:`_rescue_sweep` through :func:`hpf_sweep` and
    :func:`_f64_resolve`, every pass taking the matching ``I_bg`` rows."""
    take = lambda idx: (_take_scen(scenarios, idx), _take_bg(I_bg, idx))
    return _rescue_sweep(
        settings, scenarios, out,
        lambda sub, V0_: hpf_sweep(net, devices, settings, sub[0], V0=V0_,
                                   Y=Y, I_bg=sub[1], log=log),
        run64=lambda sub: _f64_resolve(net, devices, settings, sub[0], Y=Y,
                                       I_bg=sub[1], log=log),
        take=take, log=log)


def _device_program(settings: Settings, phase_iters: int, warm: str,
                    rescue_width, program, caller: str, log=None):
    """The device-side adaptive program: ``program`` if given (a callable
    ``(net, devices, scenarios=...)``, which then takes precedence over
    ``warm``), else :func:`hpf_sweep_adaptive_lanes` bound to the
    settings."""
    if program is None:
        if isinstance(rescue_width, list):
            rescue_width = tuple(rescue_width)
        return functools.partial(hpf_sweep_adaptive_lanes, settings=settings,
                                 phase_iters=phase_iters, warm=warm,
                                 rescue_width=rescue_width, log=log)
    if warm != "cold":
        warnings.warn(
            f"{caller}: `warm` is bound into the program — a "
            f"caller-supplied `program` takes precedence and this "
            f"warm={warm!r} is ignored; bind warm= into the program",
            stacklevel=3)
    return program


@spanned("sweep")
def hpf_sweep_device(net: Network, devices, settings: Settings,
                     scenarios: Scenarios, phase_iters: int = 16,
                     program=None, rescue: bool = True, warm: str = "cold",
                     rescue_width=None, I_bg=None,
                     log: Optional[PhaseLog] = None) -> HPFResult:
    """The device-side adaptive sweep plus the host straggler rescue
    (``hpfx.solve.hpf_sweep_device``).

    Runs :func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes` (phase-capped
    trip, gathered warm re-solve, cold restart), then — only when lanes
    remain unconverged — :func:`_rescue_sweep`, ending in the float64
    re-solve.  ``warm="linear"`` starts phase 1 from the exact-linear
    Norton seed.  ``rescue_width``: an int, or a tuple of bucketed widths.
    ``program``: optional callable ``(net, devices, scenarios=...)`` in
    place of the adaptive sweep (the JAX package's ``jitted``); it also
    gets ``I_bg=`` when one is given.  ``I_bg``: optional (B, H, n)
    background injections, threaded through every rescue pass.
    ``log``: optional :class:`hpfx_torch.utils.profiling.PhaseLog` that records
    each phase's time, Newton trips and host reads (of the default
    program), the host rescue's passes as phases inside "host_rescue"."""
    program = _device_program(settings, phase_iters, warm, rescue_width,
                              program, "hpf_sweep_device", log)
    kw = {} if I_bg is None else dict(I_bg=I_bg)
    out = program(net, devices, scenarios=scenarios, **kw)
    if rescue and not _read(log, bool, out.converged.all()):
        with _phase(log, "host_rescue", net.device):
            out = _host_rescue(net, devices, settings, scenarios, out,
                               I_bg=I_bg, log=log)
    return out


def hpf_sweep_stream(net: Network, devices, settings: Settings,
                     scenario_batches, phase_iters: int = 16,
                     depth: int = 2, rescue: bool = True, program=None,
                     warm: str = "cold"):
    """Sweep executor over a stream of scenario batches
    (``hpfx.solve.hpf_sweep_stream``): a generator that yields one
    result per batch, in input order, each equal to
    :func:`hpf_sweep_device` on that batch.

    ``depth`` sweeps are started before the oldest is finished: its host
    rescue runs when it is dequeued, and ``_finish`` ends with a device
    synchronisation, so a consumer's clock measures completed work.  The
    eager Newton trips synchronise the host once a trip, so a started
    sweep has in fact run to its end before the next batch is pulled:
    what overlaps is the caller's iterator (building and uploading the
    next batch) with the queued tail of the previous one.  ``program``
    and ``warm`` as in :func:`hpf_sweep_device`."""
    program = _device_program(settings, phase_iters, warm, None, program,
                              "hpf_sweep_stream")
    depth = max(1, int(depth))

    def finish(sc, out):
        if rescue and not _read(None, bool, out.converged.all()):
            out = _host_rescue(net, devices, settings, sc, out)
        _sync(net.device)
        return out

    inflight = collections.deque()
    for sc in scenario_batches:
        inflight.append((sc, program(net, devices, scenarios=sc)))
        if len(inflight) > depth:
            yield finish(*inflight.popleft())
    while inflight:
        yield finish(*inflight.popleft())


@spanned("sweep")
def hpf_sweep_adaptive(net: Network, devices, settings: Settings,
                       scenarios: Scenarios, phase_iters: int = 16,
                       phase2_settings: Optional[Settings] = None,
                       V0=None, rescue: bool = True, Y=None,
                       warm: str = "cold", I_bg=None,
                       log: Optional[PhaseLog] = None) -> HPFResult:
    """Host-driven two-phase sweep (``hpfx.solve.hpf_sweep_adaptive``).

    Phase 1 caps the Newton trip at ``phase_iters``; phase 2 re-solves the
    unconverged scenarios, bucketed to a power of two, warm from their
    phase-1 states with ``phase2_settings`` (default ``settings``) and
    the remaining budget.  ``err_hist`` is NaN-padded to ``max_iter_h``,
    with the phase-2 history spliced in at the phase-1 offset, and
    ``n_iter`` sums both phases.  ``rescue`` runs :func:`_rescue_sweep`
    on what is still unconverged (self-warm, cold, then float64).

    ``V0``: optional batch-major (V_m, V_a) phase-1 start.
    ``warm="linear"`` starts phase 1 from the exact-linear Norton seed
    (:func:`hpfx_torch.warmstart.norton_warm_start`); with a batched
    ``I_bg`` it raises ``ValueError``, as the JAX package does.  ``Y``:
    admittance override forwarded to every phase and to the seed.
    ``I_bg``: optional (B, H, n) background injections; every phase and
    rescue pass, float64 included, takes the matching rows.  ``log``:
    optional :class:`PhaseLog` with the phases "seed", "phase1",
    "phase2" and "host_rescue" (its passes "rescue_self", "rescue_cold"
    and "rescue_float64" inside it)."""
    dv = net.device
    if V0 is None and warm == "linear":
        if I_bg is not None:
            raise ValueError("warm='linear' with a batched I_bg is not "
                             "supported — pass V0 explicitly or use the "
                             "cold start")
        from .warmstart import norton_warm_start
        with _phase(log, "seed", dv):
            V0 = norton_warm_start(net, devices, settings, scenarios, Y=Y)

    def rescue_(out):
        with _phase(log, "host_rescue", dv):
            return _host_rescue(net, devices, settings, scenarios, out, Y=Y,
                                I_bg=I_bg, log=log)

    p1 = min(phase_iters, settings.max_iter_h)
    s1 = settings.with_(max_iter_h=p1)
    with _phase(log, "phase1", dv):
        r1 = hpf_sweep(net, devices, s1, scenarios, V0=V0, Y=Y, I_bg=I_bg,
                       log=log)
    B = r1.V_m.shape[0]
    hist = torch.full((B, settings.max_iter_h), float("nan"),
                      dtype=r1.err_hist.dtype, device=dv)
    hist[:, :p1] = r1.err_hist
    idx = _bucket_pending(r1.converged, B, log)
    if idx is None or p1 == settings.max_iter_h:
        r1 = r1._replace(err_hist=hist)
        return rescue_(r1) if rescue and idx is not None else r1

    base2 = settings if phase2_settings is None else phase2_settings
    s2 = base2.with_(max_iter_h=settings.max_iter_h - p1)
    with _phase(log, "phase2", dv):
        r2 = hpf_sweep(net, devices, s2, _take_scen(scenarios, idx),
                       V0=(r1.V_m[idx], r1.V_a[idx]), Y=Y,
                       I_bg=_take_bg(I_bg, idx), log=log)
    # re-solved scenarios ran all p1 trips of phase 1, so their phase-2
    # history continues at that offset (err after trip i at [i])
    hist[idx, p1:] = r2.err_hist
    merged = HPFResult(
        V_m=_put(r1.V_m, idx, r2.V_m), V_a=_put(r1.V_a, idx, r2.V_a),
        err=_put(r1.err, idx, r2.err),
        n_iter=_put(r1.n_iter, idx, r1.n_iter[idx] + r2.n_iter),
        err_hist=hist, converged=_put(r1.converged, idx, r2.converged),
        fund=r1.fund)
    return rescue_(merged) if rescue else merged


def _key_host(x) -> np.ndarray:
    """A (B,) or (B, k) scale as the continuation key on the host: float64,
    per-device scales averaged."""
    k = x.detach().to("cpu", torch.float64).numpy()
    return k if k.ndim == 1 else k.mean(axis=1)


def hpf_sweep_continuation(net: Network, devices, settings: Settings,
                           scenarios: Scenarios, n_stages: int = 4,
                           key=None, phase_iters: Optional[int] = None,
                           phase2_settings: Optional[Settings] = None,
                           rescue: bool = True) -> HPFResult:
    """Warm-start continuation sweep (``hpfx.solve.hpf_sweep_continuation``),
    driven from the host.

    The scenarios are sorted (stably) by ``key``, float64 on the host
    (default: the mean injection scale; else the summed device mix; else
    the mean ``p_scale``), split into ``n_stages`` equal chunks (the last
    padded with repeats of the last sorted index), and each chunk starts
    from the solved state of the nearest-key CONVERGED scenario of the
    earlier chunks (the first from the cold start).  Each stage runs
    :func:`hpf_sweep`, or with ``phase_iters`` :func:`hpf_sweep_adaptive`
    with ``rescue=False`` and ``phase2_settings``.  The stages are merged
    back into the original order (the padding's duplicates dropped at
    their first occurrence, ``fund=None``), then one :func:`_rescue_sweep`
    (self-warm, cold, float64) runs over the merged result when
    ``rescue``."""
    B = scenarios.batch
    n_stages = max(1, min(n_stages, B))
    if key is None:
        if scenarios.injection_scale is not None:
            key = _key_host(scenarios.injection_scale)
        elif scenarios.device_mix is not None:
            # total installed device weight: the continuation axis of a
            # device-mix Monte-Carlo
            key = scenarios.device_mix.detach().to(
                "cpu", torch.float64).numpy().sum(axis=(1, 2))
        else:
            key = _key_host(scenarios.p_scale)
    key = np.asarray(key, np.float64)
    order = np.argsort(key, kind="stable")

    # uniform chunks; the last padded with repeats of the last index
    Bc = -(-B // n_stages)
    pad = n_stages * Bc - B
    chunks = np.concatenate([order, np.repeat(order[-1:], pad)]) \
        .reshape(n_stages, Bc)
    dv = scenarios.p_scale.device

    def run(sub, V0):
        if phase_iters is not None:
            # one rescue over the merged result, none per stage
            return hpf_sweep_adaptive(net, devices, settings, sub,
                                      phase_iters=phase_iters, V0=V0,
                                      phase2_settings=phase2_settings,
                                      rescue=False)
        return hpf_sweep(net, devices, settings, sub, V0=V0)

    solved_keys, solved_Vm, solved_Va, parts = [], [], [], []
    for idx in chunks:
        sub = _take_scen(scenarios, torch.as_tensor(idx, device=dv))
        V0 = None
        if solved_keys:
            sk = np.concatenate(solved_keys)
            near = torch.as_tensor(
                np.abs(key[idx][:, None] - sk[None, :]).argmin(axis=1),
                device=dv)
            V0 = (torch.cat(solved_Vm)[near], torch.cat(solved_Va)[near])
        res = run(sub, V0)
        parts.append(res)
        # only converged (finite) states seed later stages: a NaN start
        # makes the Newton mask false at iteration 0
        good = res.converged.cpu().numpy()
        if good.any():
            gi = torch.as_tensor(np.nonzero(good)[0], device=dv)
            solved_keys.append(key[idx][good])
            solved_Vm.append(res.V_m[gi])
            solved_Va.append(res.V_a[gi])

    # back to the original order, the padding's duplicates dropped
    flat = chunks.reshape(-1)
    _, rows = np.unique(flat, return_index=True)
    rows_t = torch.as_tensor(rows, device=dv)
    inv = torch.as_tensor(flat[rows], device=dv)

    def merge(*xs):
        x = torch.cat(xs, dim=0)
        out = torch.zeros((B,) + x.shape[1:], dtype=x.dtype, device=x.device)
        out[inv] = x[rows_t]
        return out

    out = HPFResult(*(merge(*xs) for xs in zip(*(p[:6] for p in parts))))
    if not rescue:
        return out
    return _rescue_sweep(settings, scenarios, out, run,
                         run64=lambda sub: _f64_resolve(
                             net, devices, settings, sub))


def hpf_sweep_kron(net: Network, devices, settings: Settings,
                   scenarios: Scenarios) -> HPFResult:
    """Batched sweep with the passive buses Kron-reduced out
    (``hpfx.solve.hpf_sweep_kron``): with no passive bus this is
    :func:`hpf_sweep`; else the sweep runs on the reduced network with
    its dense admittances (no line structure, so the stable mismatch is
    off) and the eliminated buses' voltages are recovered after, so the
    result is full size."""
    from .kron import expand_voltages, kron_reduce, passive_buses

    if passive_buses(net).size == 0:
        return hpf_sweep(net, devices, settings, scenarios)
    red = kron_reduce(net, settings)
    res = hpf_sweep(red.net, devices, settings.with_(stable_mismatch=False),
                    scenarios, Y=red.Y)
    V_m, V_a = expand_voltages(red, res.V_m, res.V_a, net.n)
    return res._replace(V_m=V_m, V_a=V_a)


class SweepSummary(NamedTuple):
    max_thd_f: torch.Tensor       # (B,) worst-bus THD_F per scenario
    converged: torch.Tensor       # (B,) bool
    n_iter: torch.Tensor          # (B,)
    frac_over_limit: torch.Tensor  # scalar


def hosting_capacity_sweep(net: Network, devices, settings: Settings,
                           scenarios: Scenarios, thd_limit: float = 0.08,
                           valid_count: Optional[int] = None
                           ) -> SweepSummary:
    """Monte-Carlo hosting-capacity sweep (``hpfx.solve.
    hosting_capacity_sweep``): :func:`hpf_sweep`, then the fraction of the
    first ``valid_count`` (default all) scenarios whose worst-bus THD_F
    exceeds ``thd_limit`` and that converged."""
    res = hpf_sweep(net, devices, settings, scenarios)
    max_thd = get_thd(res.V_m.movedim(1, 0)).THD_F.amax(dim=-1)
    over = (max_thd > thd_limit) & res.converged
    B = max_thd.shape[0]
    nv = B if valid_count is None else valid_count
    w = (torch.arange(B, device=max_thd.device) < nv).to(max_thd.dtype)
    frac = (over.to(max_thd.dtype) * w).sum() / nv
    return SweepSummary(max_thd, res.converged, res.n_iter, frac)


#: the JAX package's unjitted bodies of its jitted sweeps
#: (``hpfx/solve.py:87`` and ``:723``), which its mesh code wraps in its own
#: ``jax.jit``: the port never jits, so each is the sweep itself
hpf_sweep_unjitted = hpf_sweep
hosting_capacity_sweep_unjitted = hosting_capacity_sweep


def summarize_thd(result: HPFResult, thd_limit: float = 0.08) -> SweepSummary:
    """The hosting-capacity aggregate of an already solved batch
    (``hpfx.solve.summarize_thd``)."""
    max_thd = get_thd(result.V_m.movedim(1, 0)).THD_F.amax(dim=-1)
    over = (max_thd > thd_limit) & result.converged
    frac = over.to(max_thd.dtype).mean()
    return SweepSummary(max_thd, result.converged, result.n_iter, frac)
