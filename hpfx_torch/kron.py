"""Kron reduction: eliminate passive buses before solving (the port of
:mod:`hpfx.kron`).

Passive buses (PQ, zero load, no shunt, no device; net2's bus 3) add
pure zero-current-balance rows at every order.  Schur-complementing them
out of each harmonic admittance block,

    Y_red[h] = Y_kk[h] - Y_ke[h] · Y_ee[h]^{-1} · Y_ek[h],

shrinks the Newton system and leaves the kept buses' solution the same;
the eliminated buses' voltages follow from
V_e[h] = -Y_ee[h]^{-1} · Y_ek[h] · V_k[h].  The matmuls run in full
float32 (the package pins TF32 off at import).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .harmonic import HPFResult
from .network import PQ, Network


class KronReduction(NamedTuple):
    net: Network          # reduced network (no line data; use Y)
    Y: Cx                 # (H, n_k, n_k) reduced admittance tensor
    keep: np.ndarray      # original indices of kept buses
    elim: np.ndarray      # original indices of eliminated buses
    # dense recovery operator R[h]: V_e[h] = R[h] @ V_k[h]
    R: Cx


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def passive_buses(net: Network) -> np.ndarray:
    """Indices of eliminable buses: PQ with zero P/Q/S and no shunt."""
    types = np.asarray(net.bus_types)
    mask = ((types == PQ) & (_host(net.bus_P) == 0) & (_host(net.bus_Q) == 0)
            & (_host(net.bus_S) == 0) & (_host(net.bus_Xsh) == 0))
    return np.where(mask)[0]


def _block(Y: Cx, rows, cols) -> Cx:
    """Y[:, rows][:, :, cols] for index tensors ``rows``/``cols``."""
    pick = lambda t: t.index_select(1, rows).index_select(2, cols)
    return Cx(pick(Y.re), pick(Y.im))


def kron_reduce(net: Network, settings: Settings, Y: Cx = None,
                elim: np.ndarray = None) -> KronReduction:
    """Schur-complement the passive buses (or ``elim``) out of every
    harmonic block of ``Y`` (default: the network's own)."""
    from .ybus import build_ybus

    if Y is None:
        Y = build_ybus(net, settings)
    if elim is None:
        elim = passive_buses(net)
    elim = np.asarray(elim, int)
    keep = np.array([i for i in range(net.n) if i not in set(elim.tolist())])
    if elim.size == 0:
        raise ValueError("no passive buses to eliminate")

    dv = net.device
    k_t = torch.as_tensor(keep, device=dv)
    e_t = torch.as_tensor(elim, device=dv)
    X = cx.solve(_block(Y, e_t, e_t), _block(Y, e_t, k_t))  # (H, n_e, n_k)
    Y_red = _block(Y, k_t, k_t) - cx.matmul(_block(Y, k_t, e_t), X)

    empty = lambda t: t[:0]
    net_red = dataclasses.replace(
        net,
        bus_P=net.bus_P[k_t], bus_Q=net.bus_Q[k_t],
        bus_S=net.bus_S[k_t], bus_Xsh=net.bus_Xsh[k_t],
        line_from=empty(net.line_from), line_to=empty(net.line_to),
        line_R=empty(net.line_R), line_X=empty(net.line_X),
        line_G=empty(net.line_G), line_B=empty(net.line_B),
        line_tau=empty(net.line_tau), line_shift=empty(net.line_shift),
        n=len(keep), m=int(np.searchsorted(keep, net.m)), c=net.c,
        bus_types=tuple(net.bus_types[i] for i in keep),
        components=tuple(net.components[i] for i in keep))
    return KronReduction(net=net_red, Y=Y_red, keep=keep, elim=elim, R=-X)


def expand_voltages(red: KronReduction, V_m_k, V_a_k, n_full: int):
    """Kept-bus voltages (..., H, n_k) expanded to all the original buses;
    the eliminated ones from V_e = R @ V_k per harmonic (angles in
    [0, 2pi), a floor modulus as JAX's ``%``)."""
    V_e = cx.einsum("hek,...hk->...he", red.R, cx.polar(V_m_k, V_a_k))
    shape = V_m_k.shape[:-1] + (n_full,)
    dv = V_m_k.device
    keep = torch.as_tensor(red.keep, device=dv)
    elim = torch.as_tensor(red.elim, device=dv)
    V_m = torch.zeros(shape, dtype=V_m_k.dtype, device=dv)
    V_a = torch.zeros_like(V_m)
    V_m[..., keep] = V_m_k
    V_a[..., keep] = V_a_k
    V_m[..., elim] = V_e.abs()
    V_a[..., elim] = torch.remainder(V_e.angle(), 2 * math.pi)
    return V_m, V_a


def recover_voltages(red: KronReduction, result: HPFResult, n_full: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reduced solution's (V_m, V_a) expanded to all the original buses
    (:func:`expand_voltages`)."""
    return expand_voltages(red, result.V_m, result.V_a, n_full)
