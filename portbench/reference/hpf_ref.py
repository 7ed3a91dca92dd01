"""Plain harmonic power flow: the benchmark's reference.

A straightforward solve of the harmonically coupled Norton-equivalent
(HCNE) power flow that the benchmarked program solves, written from the
equations and not from the program: it imports nothing of it.  It reads
the network and device tables itself (the ``;``-separated bus and line
files and the ``<device>_NE.csv`` Norton tables) and solves every
scenario by Newton's method in rectangular coordinates with a dense
Jacobian, in float64 by default.

The equations, per unit on the configuration's bases, for odd harmonic
orders h_1 = 1 < h_2 < ... (H of them) and buses ordered slack, PV, PQ,
nonlinear (the first nonlinear bus is m, c - 1 buses are PV):

- admittances per order: series 1/(R + j h X) per line, pi shunts
  (G + j h B)/2 at each end, the tap and phase shift of a line on its
  from side (1/tau^2 on the from diagonal, -Ys e^{+-j shift}/tau off it),
  and a bus shunt reactance X_sh as 1/(j h X_sh) on the orders above the
  fundamental;
- the slack's fundamental voltage is 1 at angle 0;
- a PV bus keeps |V| = 1 at the fundamental and balances P there;
- a PQ bus balances S = p P + j q Q at the fundamental:
  S_i + V_i conj((Y V)_i) = 0 (loads positive);
- a nonlinear bus d balances current at every order, with the device's
  injection s (I_N[d, h] - sum_p Y_N[d, h, p] V_p) scaled by the
  scenario's injection scale s;
- every bus balances current at every order above the fundamental:
  (Y_h V_h)_i plus the injection where a device sits = 0.

:class:`Precision` sets the arithmetic: float64 for the reference, and,
for the control of the benchmark's check, float32 with every matrix
product taken in TF32 (operands rounded to a 10-bit mantissa, sums in
float32), the step below the program's float32 with TF32 off.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

SLACK, PV, PQ, NONLINEAR = "slack", "PV", "PQ", "nonlinear"
_ORDER = {SLACK: 0, PV: 1, PQ: 2, NONLINEAR: 3}


@dataclasses.dataclass(frozen=True)
class Precision:
    """The arithmetic of a solve: ``dtype`` the real type, ``tf32`` every
    matrix product's operands rounded to TF32 first."""
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 \
            else torch.complex64


FLOAT64 = Precision()
#: the control: float32 with TF32 matrix products
TF32 = Precision(torch.float32, True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits (to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _real_mm(a, b, prec: Precision):
    if prec.tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def cmatmul(a, b, prec: Precision):
    """Complex ``a @ b`` as four real products in ``prec``."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    re = _real_mm(ar, br, prec) - _real_mm(ai, bi, prec)
    im = _real_mm(ar, bi, prec) + _real_mm(ai, br, prec)
    return torch.complex(re, im)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class Grid(NamedTuple):
    """A network in per unit: bus types (sorted), loads, shunts, lines."""
    types: tuple
    components: tuple
    P: np.ndarray
    Q: np.ndarray
    X_sh: np.ndarray
    frm: np.ndarray
    to: np.ndarray
    R: np.ndarray
    X: np.ndarray
    G: np.ndarray
    B: np.ndarray
    tau: np.ndarray
    shift: np.ndarray

    @property
    def n(self) -> int:
        return len(self.types)

    @property
    def m(self) -> int:
        nl = [i for i, t in enumerate(self.types) if t == NONLINEAR]
        return nl[0] if nl else self.n

    @property
    def c(self) -> int:
        return 1 + sum(t == PV for t in self.types)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter=";"))


def _num(row, *keys, default=None):
    for k in keys:
        if row.get(k) not in (None, ""):
            return float(row[k])
    if default is None:
        raise KeyError(f"none of the columns {keys} in {row}")
    return default


def read_grid(buses_csv: str, lines_csv: str, base_power: float,
              base_voltage: float) -> Grid:
    """The bus and line tables in per unit (powers in W and var,
    impedances in ohm, admittances in S)."""
    buses, lines = _rows(buses_csv), _rows(lines_csv)
    types = [b["type"] for b in buses]
    if [_ORDER[t] for t in types] != sorted(_ORDER[t] for t in types):
        raise ValueError("buses must be ordered slack, PV, PQ, nonlinear")
    z_base = base_voltage ** 2 / base_power
    idx = {int(float(b["ID"])): i for i, b in enumerate(buses)}
    col = lambda rows, f: np.array([f(r) for r in rows], dtype=np.float64)
    return Grid(
        types=tuple(types), components=tuple(b["component"] for b in buses),
        P=col(buses, lambda r: _num(r, "P")) / base_power,
        Q=col(buses, lambda r: _num(r, "Q")) / base_power,
        X_sh=col(buses, lambda r: _num(r, "X_sh", "X_shunt", default=0.0))
        / z_base,
        frm=np.array([idx[int(float(r["fromID"]))] for r in lines]),
        to=np.array([idx[int(float(r["toID"]))] for r in lines]),
        R=col(lines, lambda r: _num(r, "R")) / z_base,
        X=col(lines, lambda r: _num(r, "X")) / z_base,
        G=col(lines, lambda r: _num(r, "G", default=0.0)) * z_base,
        B=col(lines, lambda r: _num(r, "B", default=0.0)) * z_base,
        tau=col(lines, lambda r: _num(r, "tau", default=1.0)),
        shift=col(lines, lambda r: _num(r, "phase_shift", default=0.0))
        * math.pi / 180.0)


def read_norton(path: str, orders: Sequence[int], net_freq: float,
                base_power: float, base_voltage: float):
    """One device's coupled Norton equivalent at ``orders``, per unit:
    (I_N (H,), Y_N (H, H)) complex.  Rows of ``Y_N_c`` are the injected
    order, columns the voltage's."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    freqs = [int(float(f)) for f in rows[0][2:]]
    cols = [freqs.index(int(round(h * net_freq))) for h in orders]
    Y_rows, I = {}, None
    for r in rows[1:]:
        vals = np.array([complex(v.strip().strip("()")) for v in r[2:]])
        if r[0] == "Y_N_c":
            Y_rows[int(float(r[1]))] = vals
        elif r[0] == "I_N_c":
            I = vals
    i_base = base_power / base_voltage
    y_base = i_base / base_voltage
    Y = np.stack([Y_rows[int(round(h * net_freq))][cols] for h in orders])
    return I[cols] / i_base, Y / y_base


def find_table(component: str, data_dir: str) -> str:
    """``<component>_NE.csv`` in ``data_dir``, whatever the case."""
    want = f"{component}_NE.csv".lower()
    for f in sorted(os.listdir(data_dir)):
        if f.lower() == want:
            return os.path.join(data_dir, f)
    raise FileNotFoundError(f"no {component}_NE.csv in {data_dir}")


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

class Problem(NamedTuple):
    """What the Newton solve needs, as float64 numpy: ``Y`` (H, n, n) the
    admittances, ``I_N`` (n_nl, H) and ``Y_N`` (n_nl, H, H) the devices,
    the loads ``P``/``Q`` (n,), and the bus split ``m``, ``c``."""
    Y: np.ndarray
    I_N: np.ndarray
    Y_N: np.ndarray
    P: np.ndarray
    Q: np.ndarray
    m: int
    c: int

    @property
    def H(self) -> int:
        return self.Y.shape[0]

    @property
    def n(self) -> int:
        return self.Y.shape[1]


def admittances(grid: Grid, orders: Sequence[int]) -> np.ndarray:
    """The (H, n, n) admittance matrices."""
    H, n = len(orders), grid.n
    Y = np.zeros((H, n, n), dtype=np.complex128)
    for k, h in enumerate(orders):
        for l in range(len(grid.R)):
            f, t = grid.frm[l], grid.to[l]
            ys = 1.0 / (grid.R[l] + 1j * h * grid.X[l])
            ysh = (grid.G[l] + 1j * h * grid.B[l]) / 2.0
            tau, sh = grid.tau[l], grid.shift[l]
            Y[k, f, f] += (ys + ysh) / tau ** 2
            Y[k, t, t] += ys + ysh
            Y[k, f, t] -= ys * np.exp(1j * sh) / tau
            Y[k, t, f] -= ys * np.exp(-1j * sh) / tau
        if h != 1:
            for i in range(n):
                if grid.X_sh[i] != 0.0:
                    Y[k, i, i] += 1.0 / (1j * h * grid.X_sh[i])
    return Y


def problem(grid: Grid, orders: Sequence[int], data_dir: str,
            net_freq: float, base_power: float,
            base_voltage: float) -> Problem:
    """The grid's admittances and the Norton tables of its nonlinear
    buses' components."""
    dev = [read_norton(find_table(comp, data_dir), orders, net_freq,
                       base_power, base_voltage)
           for comp in grid.components[grid.m:]]
    H = len(orders)
    I_N = np.stack([d[0] for d in dev]) if dev else np.zeros((0, H), complex)
    Y_N = np.stack([d[1] for d in dev]) if dev else np.zeros((0, H, H),
                                                              complex)
    return Problem(admittances(grid, orders), I_N, Y_N, grid.P, grid.Q,
                   grid.m, grid.c)


class _Batch(NamedTuple):
    M: torch.Tensor      # (b, K, K) the current map, K = H n, flat h n + i
    c0: torch.Tensor     # (b, K) its constant (the Norton sources)
    S: torch.Tensor      # (b, n) the loads


def _batch(pb: Problem, p, q, s, prec: Precision, device) -> _Batch:
    """The current map M (V -> bus currents over every order, flattened
    h n + i) with each scenario's device scale, its constant and the
    scaled loads."""
    H, n, m = pb.H, pb.n, pb.m
    K = H * n
    cd = prec.cdtype
    t = lambda a: torch.as_tensor(a, dtype=torch.complex128, device=device)
    s = t(s)
    M0 = torch.zeros((K, K), dtype=torch.complex128, device=device)
    for h in range(H):
        M0[h * n:(h + 1) * n, h * n:(h + 1) * n] = t(pb.Y[h])
    Md = torch.zeros((K, K), dtype=torch.complex128, device=device)
    c0 = torch.zeros((K,), dtype=torch.complex128, device=device)
    for d in range(n - m):
        rows = torch.arange(H, device=device) * n + m + d
        Md[rows[:, None], rows[None, :]] = -t(pb.Y_N[d])
        c0[rows] = t(pb.I_N[d])
    M = M0 + s[:, None, None] * Md
    S = torch.complex(torch.as_tensor(pb.P, dtype=torch.float64,
                                      device=device) * p.to(device)[:, None],
                      torch.as_tensor(pb.Q, dtype=torch.float64,
                                      device=device) * q.to(device)[:, None])
    return _Batch(M.to(cd), (s[:, None] * c0).to(cd), S.to(cd))


def _residual_and_jacobian(V, bt: _Batch, pb: Problem, prec: Precision):
    """The real residual F (b, 2(K-1)) and Jacobian (b, 2(K-1), 2(K-1))
    at V (b, K), over the unknowns V[1:] (real parts, then imaginary)."""
    n, m, c = pb.n, pb.m, pb.c
    I = cmatmul(bt.M, V[..., None], prec)[..., 0]          # (b, K)
    F = I + bt.c0
    # complex rows: dF = A dV + B conj(dV), over the unknowns V[1:]
    A = bt.M.clone()
    Bm = torch.zeros_like(A)
    pw = torch.arange(1, m, device=V.device)               # power rows
    F[:, pw] = bt.S[:, 1:m] + V[:, pw] * I[:, pw].conj()
    A[:, pw, :] = 0
    A[:, pw, pw] = I[:, pw].conj()
    Bm[:, pw, :] = V[:, pw, None] * bt.M[:, pw, :].conj()
    A, Bm, F = A[:, 1:, 1:], Bm[:, 1:, 1:], F[:, 1:]
    Jx, Jy = A + Bm, 1j * (A - Bm)
    Fr, Fi = F.real.clone(), F.imag.clone()
    Jr = torch.cat([Jx.real, Jy.real], dim=-1)
    Ji = torch.cat([Jx.imag, Jy.imag], dim=-1)
    if c > 1:
        # PV buses: the imaginary row becomes |V|^2 - 1
        pv = torch.arange(1, c, device=V.device)
        Vp = V[:, pv]
        Fi[:, pv - 1] = (Vp * Vp.conj()).real - 1.0
        K1 = A.shape[-1]
        Ji[:, pv - 1] = 0
        Ji[:, pv - 1, pv - 1] = 2 * Vp.real
        Ji[:, pv - 1, K1 + pv - 1] = 2 * Vp.imag
    return torch.cat([Fr, Fi], dim=-1), torch.cat([Jr, Ji], dim=-2)


def solve(pb: Problem, p, q, s, prec: Precision = FLOAT64, device="cpu",
          max_iter: int = 30, step_tol: float = 1e-10):
    """Solve the scenarios with load scales ``p``, ``q`` (b,) and device
    scales ``s`` (b,) from the flat start (1 at the fundamental, 0 above
    it).  Returns (V (b, H, n) complex, the largest residual entry (b,),
    iterations).  Stops when no step moves an unknown by more than
    ``step_tol`` or after ``max_iter`` steps."""
    H, n = pb.H, pb.n
    K = H * n
    b = p.shape[0]
    bt = _batch(pb, p, q, s, prec, device)
    V = torch.zeros((b, K), dtype=prec.cdtype, device=device)
    V[:, :n] = 1.0
    it = 0
    for it in range(1, max_iter + 1):
        F, J = _residual_and_jacobian(V, bt, pb, prec)
        if prec.tf32:
            J = round_tf32(J)
        dx = torch.linalg.solve(J, F[..., None])[..., 0]
        dV = torch.complex(dx[:, :K - 1], dx[:, K - 1:])
        V[:, 1:] = V[:, 1:] - dV
        if float(dV.abs().max()) <= step_tol:
            break
    F, _ = _residual_and_jacobian(V, bt, pb, prec)
    return V.reshape(b, H, n), F.abs().amax(dim=-1), it
