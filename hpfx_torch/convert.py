"""State carried across from the JAX package.

The port never imports ``hpfx`` (its ``__init__`` imports JAX), so the
hand-over is plain data: the caller flattens ``hpfx.network.Network`` and
``hpfx.devices.DeviceSet`` (or ``DeviceLibrary``) into numpy arrays and
Python values, and :func:`from_hpfx_arrays` (or
:func:`library_from_hpfx_arrays`) rebuilds the port's objects from them,
so both packages compute from bit-identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .cx import Cx
from .devices import DeviceLibrary, DeviceSet
from .extended import ControlledDeviceSet
from .network import ARRAY_FIELDS, Network


def from_hpfx_arrays(net_leaves: dict, dev_leaves: dict, device=None):
    """Rebuild ``(Network, DeviceSet)`` on ``device`` (default: the CUDA
    card, :func:`hpfx_torch._device.resolve_device`).

    ``net_leaves`` maps every field of ``hpfx.network.Network`` to its
    value: numpy arrays for the array fields, the Python values of
    ``n``/``m``/``c``/``bus_types``/``components``.  ``dev_leaves`` holds
    ``I_N`` and ``Y_N`` as ``(re, im)`` numpy pairs and ``coupled``.
    Floating arrays keep their dtype; bus indices become int64.
    """
    device = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        dt = None if a.dtype.kind == "f" else torch.int64
        return torch.tensor(a, dtype=dt, device=device)      # a copy

    net = Network(**{k: t(net_leaves[k]) for k in ARRAY_FIELDS},
                  n=int(net_leaves["n"]), m=int(net_leaves["m"]),
                  c=int(net_leaves["c"]),
                  bus_types=tuple(net_leaves["bus_types"]),
                  components=tuple(net_leaves["components"]))
    dev = DeviceSet(I_N=Cx(*map(t, dev_leaves["I_N"])),
                    Y_N=Cx(*map(t, dev_leaves["Y_N"])),
                    coupled=bool(dev_leaves["coupled"]))
    return net, dev


def library_from_hpfx_arrays(lib_leaves: dict, device=None) -> DeviceLibrary:
    """Rebuild a ``DeviceLibrary`` on ``device`` (default: the CUDA card)
    from ``hpfx.devices.DeviceLibrary``'s leaves: ``I_lib`` and ``Y_lib``
    as ``(re, im)`` numpy pairs, ``coupled`` and ``names``."""
    device = resolve_device(device)
    t = lambda a: torch.tensor(np.asarray(a), device=device)   # a copy
    return DeviceLibrary(I_lib=Cx(*map(t, lib_leaves["I_lib"])),
                         Y_lib=Cx(*map(t, lib_leaves["Y_lib"])),
                         coupled=bool(lib_leaves["coupled"]),
                         names=tuple(lib_leaves["names"]))


def controlled_from_hpfx_arrays(params, u0, inject, constraint, n_nl: int,
                                n_u: int, device=None) -> ControlledDeviceSet:
    """A ``ControlledDeviceSet`` on ``device`` (default: the CUDA card)
    from ``hpfx.extended.ControlledDeviceSet``'s data: ``params`` a nested
    tuple of numpy arrays, complex ones becoming split-complex ``Cx``
    (flatten a JAX ``Cx`` with its ``to_numpy()``), and ``u0`` (n_nl, n_u).
    ``inject`` and ``constraint`` are the port's own torch functions of
    the same device."""
    device = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        if isinstance(a, np.ndarray) and a.dtype.kind == "c":
            return Cx(torch.tensor(a.real.copy(), device=device),
                      torch.tensor(a.imag.copy(), device=device))
        return torch.tensor(a, device=device)

    def tree(p):
        if isinstance(p, (tuple, list)):
            return type(p)(tree(q) for q in p)
        return t(p)

    return ControlledDeviceSet(params=tree(params), u0=t(u0), inject=inject,
                               constraint=constraint, n_nl=n_nl, n_u=n_u)
