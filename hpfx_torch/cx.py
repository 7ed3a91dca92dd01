"""Split-complex arithmetic: complex tensors as (re, im) real pairs.

The PyTorch counterpart of :mod:`hpfx.cx`.  The (re, im) layout is kept
for three reasons: every kernel operand stays real, the polar-coordinate
Jacobian of the solver is real anyway, and the port's intermediates
compare one to one with the JAX package's.

``Cx`` is a NamedTuple of two equal-shaped real tensors.  JAX's immutable
``.at[idx].set/add`` updates become :meth:`Cx.at_set` / :meth:`Cx.at_add`,
which work on a clone and return it, so callers keep the functional style
of the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops import batched_solve


class Cx(NamedTuple):
    """A complex tensor stored as two equal-shaped real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    # -- structure ----------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device

    def __getitem__(self, idx) -> "Cx":
        return Cx(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "Cx":
        return Cx(self.re.reshape(*shape), self.im.reshape(*shape))

    def transpose(self, *axes) -> "Cx":
        """Axis permutation with numpy/JAX semantics (not torch's swap)."""
        return Cx(self.re.permute(*axes), self.im.permute(*axes))

    @property
    def T(self) -> "Cx":
        axes = tuple(reversed(range(self.ndim)))
        return Cx(self.re.permute(*axes), self.im.permute(*axes))

    @property
    def mT(self) -> "Cx":
        """The last two axes swapped (leading axes are a batch)."""
        return Cx(self.re.mT, self.im.mT)

    def to(self, *args, **kwargs) -> "Cx":
        return Cx(self.re.to(*args, **kwargs), self.im.to(*args, **kwargs))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re + o.re, self.im + o.im)
        return Cx(self.re + o, self.im)          # real scalar/tensor

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re - o.re, self.im - o.im)
        return Cx(self.re - o, self.im)

    def __rsub__(self, o):
        return (-self) + o

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return Cx(self.re * o, self.im * o)      # real scalar/tensor

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Cx):
            return self * o.reciprocal()
        return Cx(self.re / o, self.im / o)

    def __rtruediv__(self, o):
        return self.reciprocal() * o

    def conj(self) -> "Cx":
        return Cx(self.re, -self.im)

    def jmul(self) -> "Cx":
        """Multiply by the imaginary unit."""
        return Cx(-self.im, self.re)

    def reciprocal(self) -> "Cx":
        d = self.re * self.re + self.im * self.im
        return Cx(self.re / d, -self.im / d)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.abs2())

    def angle(self) -> torch.Tensor:
        return torch.atan2(self.im, self.re)

    # -- functional updates (apply to both components) -----------------------
    def at_set(self, idx, val: "Cx") -> "Cx":
        """Copy with ``out[idx] = val`` (JAX ``.at[idx].set``)."""
        return Cx(_set(self.re, idx, val.re), _set(self.im, idx, val.im))

    def at_add(self, idx, val: "Cx") -> "Cx":
        """Copy with ``out[idx] += val``, accumulating over repeated
        indices like JAX ``.at[idx].add`` (``index_put`` semantics), in
        index order, the same bits on every call and device."""
        plan = _add_plan(self.re, idx)
        return Cx(_add(self.re, idx, val.re, plan),
                  _add(self.im, idx, val.im, plan))


def _set(x: torch.Tensor, idx, val) -> torch.Tensor:
    out = x.clone()
    out[idx] = val
    return out


def _add_plan(x: torch.Tensor, idx):
    """How :func:`_add` adds at advanced indices, which may repeat (two
    lines into one bus): the flat positions the index selects, grouped
    into passes over distinct positions, the first occurrence of each in
    the first pass, the second in the second, ...: (positions, entries)
    chunks, one per pass, and the index's shape.  A CUDA index_add_ would add repeats atomically,
    in an order that changes from call to call, and a chaotic Newton
    transient turns that last bit into another iteration count.  One host
    sync (the passes' sizes); None for basic indexing."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(i, torch.Tensor) for i in idx):
        return None
    dv = x.device
    sel = torch.arange(x.numel(), device=dv).view(x.shape)[idx]
    lin, order = torch.sort(sel.reshape(-1), stable=True)
    pos = torch.arange(lin.numel(), device=dv)
    first = torch.ones_like(lin, dtype=torch.bool)
    first[1:] = lin[1:] != lin[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_pass = torch.sort(rank * x.numel() + lin).indices
    counts = torch.bincount(rank).tolist()
    return lin[by_pass].split(counts), order[by_pass].split(counts), sel.shape


def _add(x: torch.Tensor, idx, val, plan=None) -> torch.Tensor:
    if plan is None:
        plan = _add_plan(x, idx)
    if plan is None:
        out = x.clone()
        out[idx] += val                          # basic slicing: a view
        return out
    positions, entries, shape = plan
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    val = val.expand(shape).reshape(-1)
    flat = x.reshape(-1)
    for p, e in zip(positions, entries):
        # distinct positions; out of place, so that torch.func transforms
        # can carry a batched or dual ``val`` into a plain ``x``
        flat = flat.index_put((p,), flat[p] + val[e])
    return flat.view(x.shape)


# -- constructors -----------------------------------------------------------

def cx(re, im=None) -> Cx:
    """A Cx from a real part (a tensor or anything ``torch.as_tensor``
    takes) and an optional imaginary part, zero by default."""
    re = torch.as_tensor(re)
    return Cx(re, torch.zeros_like(re) if im is None
              else torch.as_tensor(im, dtype=re.dtype, device=re.device))


def from_numpy(arr, dtype, device=None) -> Cx:
    """Host-side complex (or real) numpy array -> Cx on ``device``."""
    arr = np.asarray(arr)
    mk = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
    return Cx(mk(np.real(arr)), mk(np.imag(arr)))


def polar(mag, ang) -> Cx:
    """mag·e^{j·ang}.  ``mag`` may be signed (harmonic magnitudes go
    negative mid-iteration by design)."""
    return Cx(mag * torch.cos(ang), mag * torch.sin(ang))


def expj(ang) -> Cx:
    return Cx(torch.cos(ang), torch.sin(ang))


def sqrt(w: Cx) -> Cx:
    """Principal complex square root (branch cut on the negative real
    axis, as numpy's): |w|^{1/2}·e^{j·arg(w)/2}."""
    return polar(w.abs2() ** 0.25, 0.5 * torch.atan2(w.im, w.re))


def sinh(w: Cx) -> Cx:
    """sinh(a+jb) = sinh a·cos b + j·cosh a·sin b."""
    return Cx(torch.sinh(w.re) * torch.cos(w.im),
              torch.cosh(w.re) * torch.sin(w.im))


def cosh(w: Cx) -> Cx:
    """cosh(a+jb) = cosh a·cos b + j·sinh a·sin b."""
    return Cx(torch.cosh(w.re) * torch.cos(w.im),
              torch.sinh(w.re) * torch.sin(w.im))


def zeros(shape, dtype, device=None) -> Cx:
    return Cx(torch.zeros(shape, dtype=dtype, device=device),
              torch.zeros(shape, dtype=dtype, device=device))


def eye(n, dtype, device=None) -> Cx:
    return Cx(torch.eye(n, dtype=dtype, device=device),
              torch.zeros((n, n), dtype=dtype, device=device))


# -- contractions (each = 4 real contractions) -------------------------------
#
# float32 matmuls must run in full float32: the package pins TF32 off at
# import (hpfx_torch/__init__.py) — a TF32 contraction keeps ~3 decimal
# digits and stalls Newton at a residual floor far above thresh_h.

def matmul(a: Cx, b: Cx) -> Cx:
    """Batched complex matmul over the last two axes."""
    mm = torch.matmul
    return Cx(mm(a.re, b.re) - mm(a.im, b.im),
              mm(a.re, b.im) + mm(a.im, b.re))


def matvec(A: Cx, v: Cx) -> Cx:
    """A·v over the last axes: A (..., m, n), v (..., n) -> (..., m),
    leading axes broadcast."""
    return einsum("...ij,...j->...i", A, v)


def einsum(pattern: str, a: Cx, b: Cx) -> Cx:
    es = lambda x, y: torch.einsum(pattern, x, y)
    return Cx(es(a.re, b.re) - es(a.im, b.im),
              es(a.re, b.im) + es(a.im, b.re))


def solve(A: Cx, B: Cx) -> Cx:
    """Solve the complex system A·X = B through the real block system
    [[Ar, −Ai], [Ai, Ar]]·[Xr; Xi] = [Br; Bi] (``hpfx.cx.solve``, which
    takes ``jnp.linalg.solve`` outside any Pallas kernel): one LU solve,
    :func:`hpfx_torch.ops.batched_solve._lu` (a singular system gives a
    non-finite solution, as in JAX, instead of raising).  A (..., M, M); B (..., M)
    or (..., M, R)."""
    M = A.shape[-1]
    A_real = torch.cat([torch.cat([A.re, -A.im], dim=-1),
                        torch.cat([A.im, A.re], dim=-1)], dim=-2)
    vec = B.re.dim() == A.re.dim() - 1
    Br, Bi = (B.re[..., None], B.im[..., None]) if vec else (B.re, B.im)
    X = batched_solve._lu(A_real, torch.cat([Br, Bi], dim=-2))
    Xr, Xi = X[..., :M, :], X[..., M:, :]
    return Cx(Xr[..., 0], Xi[..., 0]) if vec else Cx(Xr, Xi)


def where(mask, a: Cx, b: Cx) -> Cx:
    return Cx(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))


def concatenate(parts, axis=0) -> Cx:
    return Cx(torch.cat([p.re for p in parts], axis),
              torch.cat([p.im for p in parts], axis))
