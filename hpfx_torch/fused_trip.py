"""The fused Newton trip: one whole arrow Newton iteration per launch.

The PyTorch counterpart of ``validation/fused_trip.py`` (the Pallas
kernel ``_trip_kernel``, K5).  One trip is, per scenario:

  1. the arrow Jacobian blocks at the current state: the fundamental
     block (power rows, cropped and identity-padded to 2n) and one
     (2n, 2n) current block per harmonic order, with the Norton
     self-coupling folded into their diagonals;
  2. all H block solves at once ([f | U-columns] as right-hand sides),
     each the equilibrated virtual-pivot Gauss-Jordan of
     :mod:`hpfx_torch.ops.batched_solve`;
  3. for coupled devices, the Woodbury capacitance solve S y = C·z with
     S = I + C·G (dim r = 2·H·n_nl), then dx = z − X·y;
  4. the state update, the new mismatch f (grouped order) and its
     residual err = max |f|;
  5. a predicated carry: scenarios with ``act`` = 0 keep their state.

State and mismatch stay in the grouped (harmonic-block) ordering of
:mod:`hpfx_torch.arrow`, so intermediates compare one to one with the JAX
kernel's.  :func:`fused_trip_ref` is the trip in plain PyTorch;
:func:`fused_trip` is the wrapper of the hand-written CUDA kernel
(``ops/csrc/fused_trip.cu``) and runs the plain version only for tensors
that lie on the CPU.  :func:`fused_sweep` drives a whole sweep through
it; like the JAX package, nothing in ``hpf_sweep``, ``hpf_sweep_device``
or ``Settings`` dispatches to it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .harmonic import HPFResult, cleanup_voltages
from .lanes import (_lanes_result, _sweep_setup, mismatch_lanes,
                    supports_lanes)
from .ops import batched_solve as _bs
from .ybus import incidence

#: (n, n_nl) pairs the CUDA kernel is instantiated for: net2 and net3
#: (4 buses, one nonlinear)
KERNEL_SHAPES = ((4, 1),)
#: most harmonic orders the kernel takes (one lane per harmonic block)
KERNEL_MAX_H = 32
#: largest capacitance dim: two rows per lane of a warp
KERNEL_MAX_R = 64
#: most lines of the stable mismatch: one scenario's scratch then fits a
#: block's shared memory at KERNEL_MAX_H (the kernel picks 8, 4, 2 or 1
#: scenarios per block by what fits)
KERNEL_MAX_L = 128


class TripDims(NamedTuple):
    H: int
    n: int
    m: int
    c: int
    L: int          # lines of the stable mismatch; 0 = dense mismatch
    coupled: bool

    @property
    def n_nl(self) -> int:
        return self.n - self.m

    @property
    def d0(self) -> int:
        return 2 * self.n - 1 - self.c

    @property
    def r(self) -> int:
        return 2 * self.H * self.n_nl

    @property
    def r_blk(self) -> int:
        return 2 * self.n_nl

    @property
    def dim(self) -> int:
        return 2 * self.H * self.n - 1 - self.c


class TripConsts(NamedTuple):
    """Per-sweep constant operands of the trip, in one dtype on one
    device.  ``YNr``/``YNi`` are (n_nl, H, H) coupled or (n_nl, H)
    uncoupled; the line fields are empty when L = 0.  ``packed`` holds
    every float field in the order the CUDA kernel reads them, ``lines``
    the (2, L) int32 line endpoints."""
    Yr: torch.Tensor        # (H, n, n)
    Yi: torch.Tensor
    YNr: torch.Tensor
    YNi: torch.Tensor
    INr: torch.Tensor       # (n_nl, H)
    INi: torch.Tensor
    Ysr: torch.Tensor       # (H, L) series admittances
    Ysi: torch.Tensor
    dr: torch.Tensor        # (H, n) diagonal-only terms
    di: torch.Tensor
    lineP: torch.Tensor     # (3, L): a_ff, inv_tau, shift
    f_idx: torch.Tensor     # (L,) int64 line endpoints
    t_idx: torch.Tensor
    packed: torch.Tensor
    lines: torch.Tensor


def make_trip_consts(Y, lineY, devices, net, settings,
                     dtype=torch.float32):
    """(TripDims, TripConsts) from the sweep's constant operands: ``Y``
    the (H, n, n) split-complex admittance, ``lineY`` the optional
    :class:`hpfx_torch.ybus.LineYbus` (stable mismatch), ``devices`` the
    Norton :class:`DeviceSet`; cast to ``dtype`` on Y's device
    (``validation/fused_trip.py:542-575``)."""
    H = Y.shape[0]
    n, m, c = net.n, net.m, net.c
    L = 0 if lineY is None else int(lineY.f_idx.shape[0])
    dims = TripDims(H=H, n=n, m=m, c=c, L=L, coupled=bool(devices.coupled))
    dv = Y.re.device
    cast = lambda x: torch.as_tensor(x, device=dv).to(dtype).contiguous()
    if L:
        lineP = torch.stack([cast(lineY.a_ff).expand(L),
                             cast(lineY.inv_tau).expand(L),
                             cast(lineY.shift).expand(L)])
        line = dict(Ysr=cast(lineY.Ys.re), Ysi=cast(lineY.Ys.im),
                    dr=cast(lineY.d.re), di=cast(lineY.d.im), lineP=lineP,
                    f_idx=lineY.f_idx.to(dv, torch.int64),
                    t_idx=lineY.t_idx.to(dv, torch.int64))
    else:
        e = torch.zeros((0,), dtype=dtype, device=dv)
        i = torch.zeros((0,), dtype=torch.int64, device=dv)
        line = dict(Ysr=e, Ysi=e, dr=e, di=e, lineP=e, f_idx=i, t_idx=i)
    fields = dict(Yr=cast(Y.re), Yi=cast(Y.im), YNr=cast(devices.Y_N.re),
                  YNi=cast(devices.Y_N.im), INr=cast(devices.I_N.re),
                  INi=cast(devices.I_N.im), **line)
    order = ("Yr", "Yi", "YNr", "YNi", "INr", "INi")
    if L:
        order += ("Ysr", "Ysi", "dr", "di", "lineP")
    packed = torch.cat([fields[k].reshape(-1) for k in order])
    lines = torch.stack([line["f_idx"], line["t_idx"]]).to(torch.int32)
    return dims, TripConsts(**fields, packed=packed.contiguous(),
                            lines=lines.contiguous())


# ---------------------------------------------------------------------------
# the trip in plain PyTorch (batch last)
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dense_matvec(k: TripConsts, Vcr, Vci):
    """(H, n, n) x (H, n, B) complex matvec."""
    e = lambda Y, V: torch.einsum("hij,hjb->hib", Y, V)
    return e(k.Yr, Vcr) - e(k.Yi, Vci), e(k.Yr, Vci) + e(k.Yi, Vcr)


def _polar_diff(mu_a, th_a, mu_b, th_b):
    """mu_a·e^{j th_a} − mu_b·e^{j th_b} without cancellation."""
    delta = th_b - th_a
    s_half = torch.sin(0.5 * delta)
    re_l = (mu_a - mu_b) + 2.0 * mu_b * s_half * s_half
    im_l = -mu_b * torch.sin(delta)
    return _cmul(torch.cos(th_a), torch.sin(th_a), re_l, im_l)


def _stable_matvec(k: TripConsts, Vm, Va):
    """Cancellation-free Y·V: per-line flows from the endpoint voltages
    (``index_select``), summed into the buses by the one-hot incidence
    product (:func:`hpfx_torch.ybus.incidence`)."""
    a_ff, inv_tau, shift = (x[:, None] for x in k.lineP)   # (L, 1)
    at = lambda X, idx: X.index_select(1, idx)             # (H, L, B)
    Vm_f, Va_f = at(Vm, k.f_idx), at(Va, k.f_idx)
    Vm_t, Va_t = at(Vm, k.t_idx), at(Va, k.t_idx)
    Ys = (k.Ysr[..., None], k.Ysi[..., None])
    ff = _cmul(*Ys, *_polar_diff(Vm_f * a_ff, Va_f, Vm_t * inv_tau,
                                 Va_t + shift))
    ft = _cmul(*Ys, *_polar_diff(Vm_t, Va_t, Vm_f * inv_tau, Va_f - shift))
    out = _cmul(k.dr[..., None], k.di[..., None], Vm * torch.cos(Va),
                Vm * torch.sin(Va))
    inc = incidence(k.f_idx, k.t_idx, Vm.shape[1], Vm.dtype)
    return tuple(o + torch.einsum("nl,hlb->hnb", inc, torch.cat([a, b], 1))
                 for o, a, b in zip(out, ff, ft))


def _injections(dims: TripDims, k: TripConsts, Vcr, Vci, inj):
    """Scaled Norton injections (I_N − Y_N·V)·inj, (n_nl, H, B) each."""
    Vr, Vi = Vcr[:, dims.m:], Vci[:, dims.m:]              # (H, n_nl, B)
    if dims.coupled:
        e = lambda Y, V: torch.einsum("dhp,pdb->dhb", Y, V)
        yr, yi = e(k.YNr, Vr) - e(k.YNi, Vi), e(k.YNr, Vi) + e(k.YNi, Vr)
    else:
        yr, yi = _cmul(k.YNr[..., None], k.YNi[..., None],
                       Vr.transpose(0, 1), Vi.transpose(0, 1))
    return (k.INr[..., None] - yr) * inj, (k.INi[..., None] - yi) * inj


def _mismatch(dims: TripDims, k: TripConsts, Vm, Va, Sr, Si, inj):
    """Grouped-order mismatch f (dim, B) and residual err (1, B)
    (``validation/fused_trip.py:252-284``)."""
    H, n, m, c = dims.H, dims.n, dims.m, dims.c
    Vcr, Vci = Vm * torch.cos(Va), Vm * torch.sin(Va)
    if dims.L:
        YVr, YVi = _stable_matvec(k, Vm, Va)
    else:
        YVr, YVi = _dense_matvec(k, Vcr, Vci)
    # fundamental power mismatch S + V·conj(Y·V) at linear non-slack buses
    sr, si = _cmul(Vcr[0, 1:m], Vci[0, 1:m], YVr[0, 1:m], -YVi[0, 1:m])
    Ir, Ii = _injections(dims, k, Vcr, Vci, inj)
    pad = lambda x: torch.nn.functional.pad(x.transpose(0, 1),
                                            (0, 0, m, 0))  # (K, n, B)
    f0 = torch.cat([Sr[1:m] + sr, YVr[0, m:] + Ir[:, 0],
                    (Si[1:m] + si)[c - 1:], YVi[0, m:] + Ii[:, 0]])
    fh = torch.cat([YVr[1:] + pad(Ir[:, 1:]), YVi[1:] + pad(Ii[:, 1:])],
                   dim=1).reshape((H - 1) * 2 * n, -1)
    f = torch.cat([f0, fh])
    return f, f.abs().amax(dim=0, keepdim=True)


def _power_blocks(k: TripConsts, Vcr, Vci, cV, sV):
    """dS/dA and dS/dV (n, n, B) of the fundamental power rows."""
    n = Vcr.shape[1]
    Y1 = (k.Yr[0][..., None], k.Yi[0][..., None])
    Vr, Vi = Vcr[0], Vci[0]
    YVr, YVi = _cmul(*Y1, Vr[None], Vi[None])              # Y_ij·V_j
    Ir, Ii = YVr.sum(dim=1), YVi.sum(dim=1)
    eye = torch.eye(n, dtype=Vr.dtype, device=Vr.device)[..., None]
    tr, ti = eye * Ir[:, None] - YVr, eye * Ii[:, None] - YVi
    ar, ai = _cmul(Vr[:, None], Vi[:, None], tr, -ti)
    wr, wi = _cmul(cV[0], sV[0], Ir, -Ii)
    YVnr, YVni = _cmul(*Y1, cV[0][None], sV[0][None])      # Y_ij·Vn_j
    br, bi = _cmul(Vr[:, None], Vi[:, None], YVnr, -YVni)
    return (-ai, ar), (eye * wr[:, None] + br, eye * wi[:, None] + bi)


def _coupling(dims: TripDims, k: TripConsts, Vcr, Vci, cV, sV, inj):
    """K_V, K_A (H, H, n_nl, B) (re, im) pairs: the Norton coupling of
    harmonic p into harmonic h at every nonlinear bus, scaled."""
    m = dims.m
    Wn, Wc = (cV[:, m:], sV[:, m:]), (Vcr[:, m:], Vci[:, m:])
    if dims.coupled:
        A = (k.YNr.permute(1, 2, 0)[..., None],
             k.YNi.permute(1, 2, 0)[..., None])            # [h, p, d]
        vr, vi = _cmul(*A, Wn[0][None], Wn[1][None])
        ar, ai = _cmul(*A, Wc[0][None], Wc[1][None])
        return (-vr * inj, -vi * inj), (ai * inj, -ar * inj)
    A = (k.YNr.T[..., None], k.YNi.T[..., None])           # (H, n_nl, 1)
    vr, vi = _cmul(*A, *Wn)
    ar, ai = _cmul(*A, *Wc)
    eyeH = torch.eye(dims.H, dtype=Vcr.dtype,
                     device=Vcr.device)[:, :, None, None]
    emb = lambda x: eyeH * x[:, None]
    return ((emb(-vr * inj), emb(-vi * inj)),
            (emb(ai * inj), emb(-ar * inj)))


def _unit_rows(dims: TripDims):
    """Rows of the U-columns (= the coupling coordinates) in block 0 and
    in blocks h >= 1."""
    n, m, c, n_nl = dims.n, dims.m, dims.c, dims.n_nl
    s = range(dims.r_blk)
    row0 = [(m - 1) + j if j < n_nl else (n - 1) + (m - c) + (j - n_nl)
            for j in s]
    rowh = [m + j if j < n_nl else n + m + (j - n_nl) for j in s]
    return row0, rowh


def _newton_step(dims: TripDims, k: TripConsts, Vm, Va, f, inj):
    """Grouped Newton step dx (H, 2n, B): block assembly, all block
    solves at once, Woodbury (``validation/fused_trip.py:337-465``)."""
    H, n, m, c = dims.H, dims.n, dims.m, dims.c
    n_nl, d0, rb, r = dims.n_nl, dims.d0, dims.r_blk, dims.r
    k2, B = 2 * n, Vm.shape[-1]
    dt, dv = Vm.dtype, Vm.device
    solve = _bs.equilibrated_lanes(_bs.gj_solve_lanes_ref)

    cV, sV = torch.cos(Va), torch.sin(Va)
    Vcr, Vci = Vm * cV, Vm * sV
    Y4 = (k.Yr[..., None], k.Yi[..., None])
    MVr, MVi = _cmul(*Y4, cV[:, None], sV[:, None])        # Y_ij·Vn_j
    tr, ti = _cmul(*Y4, Vcr[:, None], Vci[:, None])
    MAr, MAi = -ti, tr                                     # j·Y_ij·V_j
    KV, KA = _coupling(dims, k, Vcr, Vci, cV, sV, inj)
    # fold the h == p coupling into the diagonals at the nonlinear buses
    hh, nl = torch.arange(H, device=dv), torch.arange(m, n, device=dv)
    for blk, K in ((MVr, KV[0]), (MVi, KV[1]), (MAr, KA[0]), (MAi, KA[1])):
        blk[:, nl, nl] += K[hh, hh]
    (dAr, dAi), (dVr, dVi) = _power_blocks(k, Vcr, Vci, cV, sV)

    cat = torch.cat
    D0 = cat([cat([dAr[1:m, 1:], dVr[1:m, c:]], 1),
              cat([MAr[0, m:, 1:], MVr[0, m:, c:]], 1),
              cat([dAi[c:m, 1:], dVi[c:m, c:]], 1),
              cat([MAi[0, m:, 1:], MVi[0, m:, c:]], 1)])   # (d0, d0, B)
    D_all = torch.eye(k2, dtype=dt, device=dv)[None, :, :, None].repeat(
        H, 1, 1, B)
    D_all[0, :d0, :d0] = D0
    D_all[1:] = cat([cat([MAr[1:], MVr[1:]], 2), cat([MAi[1:], MVi[1:]], 2)],
                    1)
    rhs = torch.zeros((H, k2, 1 + rb, B), dtype=dt, device=dv)
    rhs[0, :d0, 0] = f[:d0]
    rhs[1:, :, 0] = f[d0:].reshape(H - 1, k2, B)
    row0, rowh = _unit_rows(dims)
    s_ = torch.arange(rb, device=dv)
    rhs[0, row0, 1 + s_] = 1.0
    rhs[1:, rowh, 1 + s_] = 1.0

    # (H, 2n, ·, B) -> (2n, ·, H·B): all blocks through one solve
    flat = lambda x: x.permute(1, 2, 0, 3).reshape(k2, x.shape[2], H * B)
    sol = solve(flat(D_all), flat(rhs)).reshape(k2, 1 + rb, H, B)
    sol = sol.permute(2, 0, 1, 3)                          # (H, 2n, R, B)
    z, X = sol[:, :, 0], sol[:, :, 1:]
    if not dims.coupled or r == 0:
        return z

    # coupling coordinates: z and X at the U-column rows of each block
    Vz = torch.stack([z[0, row0]] + [z[h, rowh] for h in range(1, H)])
    G = torch.stack([X[0, row0]] + [X[h, rowh] for h in range(1, H)])
    # C's nonzero pattern: rows (h, t, d), cols (p, s, d) with h != p and
    # values K(t, s)[h, p, d] (t: real/imag row, s: angle/magnitude col)
    off = 1.0 - torch.eye(H, dtype=dt, device=dv)[:, :, None, None]
    K = torch.stack([torch.stack([KA[0] * off, KV[0] * off]),
                     torch.stack([KA[1] * off, KV[1] * off])])
    CG = torch.einsum("tshpdb,psdvb->htdpvb", K,
                      G.reshape(H, 2, n_nl, rb, B)).reshape(r, r, B)
    CVz = torch.einsum("tshpdb,psdb->htdb", K,
                       Vz.reshape(H, 2, n_nl, B)).reshape(r, 1, B)
    S_w = torch.eye(r, dtype=dt, device=dv)[..., None] + CG
    y = solve(S_w, CVz)[:, 0].reshape(H, rb, B)
    return z - torch.einsum("hivb,hvb->hib", X, y)


def _apply_update(dims: TripDims, Vm, Va, dx):
    """Grouped dx -> new (V_m, V_a) (H, n, B)."""
    n, c, d0 = dims.n, dims.c, dims.d0
    Va0 = torch.cat([Va[0, :1], Va[0, 1:] - dx[0, :n - 1]])
    Vm0 = torch.cat([Vm[0, :c], Vm[0, c:] - dx[0, n - 1:d0]])
    return (torch.cat([Vm0[None], Vm[1:] - dx[1:, n:]]),
            torch.cat([Va0[None], Va[1:] - dx[1:, :n]]))


def fused_trip_ref(dims: TripDims, consts: TripConsts, Vm, Va, f, err, act,
                   Sr, Si, inj):
    """One Newton trip in plain PyTorch, on any device and dtype: the
    arguments and results of :func:`fused_trip`."""
    dx = _newton_step(dims, consts, Vm, Va, f, inj)
    Vm2, Va2 = _apply_update(dims, Vm, Va, dx)
    f2, err2 = _mismatch(dims, consts, Vm2, Va2, Sr, Si, inj)
    on = act > 0
    return tuple(torch.where(on, new, old) for new, old in
                 ((Vm2, Vm), (Va2, Va), (f2, f), (err2, err)))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def supports_fused(dims: TripDims) -> bool:
    """Whether the CUDA kernel takes this problem: (n, n_nl) in
    ``KERNEL_SHAPES`` (net2, net3), H <= 32 (one lane per harmonic
    block), a capacitance dim r <= 64 (two rows per lane) and at most
    ``KERNEL_MAX_L`` lines.  net2 and net3 fit up to H = 32 (h_max 63);
    net1 (n = 20) does not.  The plain version (:func:`fused_trip_ref`)
    takes any shape on the CPU."""
    return ((dims.n, dims.n_nl) in KERNEL_SHAPES and dims.H <= KERNEL_MAX_H
            and dims.r <= KERNEL_MAX_R and dims.L <= KERNEL_MAX_L)


def fused_trip(dims: TripDims, consts: TripConsts, Vm, Va, f, err, act,
               Sr, Si, inj):
    """Run one fused Newton trip on lane-major state: Vm, Va (H, n, B);
    f (dim, B) in grouped order; err, act (0/1) and inj (1, B); Sr, Si
    (n, B).  Returns new (Vm, Va, f, err); lanes with act = 0 keep theirs
    bit for bit.  B may be any size.

    A CUDA tensor launches ``fused_trip_kernel`` (float32, contiguous,
    shapes :func:`supports_fused` accepts) or raises; a CPU tensor runs
    :func:`fused_trip_ref`."""
    H, n, dim = dims.H, dims.n, dims.dim
    B = Vm.shape[-1]
    want = dict(Vm=(H, n, B), Va=(H, n, B), f=(dim, B), err=(1, B),
                act=(1, B), Sr=(n, B), Si=(n, B), inj=(1, B))
    args = dict(Vm=Vm, Va=Va, f=f, err=err, act=act, Sr=Sr, Si=Si, inj=inj)
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"fused_trip: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    devs = {t.device for t in args.values()} | {consts.packed.device}
    if len(devs) != 1:
        raise ValueError(f"fused_trip: operands on several devices {devs}")
    if Vm.device.type == "cpu":
        return fused_trip_ref(dims, consts, Vm, Va, f, err, act, Sr, Si, inj)
    if Vm.device.type != "cuda":
        raise ValueError(f"no fused-trip kernel for device {Vm.device}")
    if any(t.dtype != torch.float32 for t in (*args.values(), consts.packed)):
        raise TypeError("the fused-trip kernel takes float32")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("the fused-trip kernel takes contiguous tensors")
    if not supports_fused(dims):
        raise ValueError(f"the fused-trip kernel does not take {dims}")
    outs = tuple(torch.empty_like(t) for t in (Vm, Va, f, err))
    if B > 0:
        _launch_trip(dims, consts, args, outs)
    return outs


def _launch_trip(dims: TripDims, consts: TripConsts, args, outs):
    from .ops._build import load_library
    B = args["Vm"].shape[-1]
    lib = load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    dev = args["Vm"].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.hpfx_fused_trip(
            *(ptr(args[k]) for k in ("Vm", "Va", "f", "err", "act", "Sr",
                                     "Si", "inj")),
            ptr(consts.packed), ptr(consts.lines), *(ptr(t) for t in outs),
            ctypes.c_int(dims.H), ctypes.c_int(dims.n), ctypes.c_int(dims.m),
            ctypes.c_int(dims.c), ctypes.c_int(dims.L),
            ctypes.c_int(int(dims.coupled)),
            ctypes.c_int(consts.packed.numel()), ctypes.c_longlong(B),
            ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(
            f"fused-trip kernel launch failed (cudaError {code}: "
            f"{lib.hpfx_error_string(code).decode()}) at {dims}, B={B}")
    _bs._count_launch("fused_trip_kernel", (dims.H, dims.n, B))


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def fused_sweep(net, devices, settings, scenarios, V0=None) -> HPFResult:
    """Batched HPF sweep with one :func:`fused_trip` per Newton trip
    (the loop of ``tests/test_fused_trip.py:136-184``); returns the
    batch-major ``HPFResult`` of ``hpf_sweep``.

    The port's lane-major setup (fundamental NR, the floor-aware
    threshold at the cold state), then, from the cold start or from
    ``V0`` (batch-major (V_m, V_a), used as given, as ``hpf_sweep``'s),
    one trip while any lane is active, with the ``act``/``n_iter``/
    NaN-padded ``err_hist`` bookkeeping of ``nr_trip_lanes``.
    ``injection_scale`` must be one scale per scenario, (B,)."""
    if not supports_lanes(devices, settings, net):
        raise NotImplementedError(
            "fused_sweep needs solver='arrow' and a non-empty Norton "
            "DeviceSet")
    inj = scenarios.injection_scale
    if inj is not None and inj.ndim != 1:
        raise NotImplementedError("fused_sweep takes one injection scale "
                                  "per scenario, (B,)")
    su = _sweep_setup(net, devices, settings, scenarios)
    rd, dv = settings.real_dtype, net.device
    B = scenarios.p_scale.shape[0]
    n, m, c = net.n, net.m, net.c
    inj = (torch.ones((1, B), dtype=rd, device=dv) if inj is None
           else inj.to(rd).reshape(1, B).contiguous())
    dims, tc = make_trip_consts(su.Y, su.lineY, devices, net, settings, rd)
    if V0 is None:
        V_m, V_a = su.cold_V_m, su.cold_V_a
    else:
        V_m, V_a = (torch.movedim(v.to(rd), 0, -1).contiguous() for v in V0)
    f, err = mismatch_lanes(V_m, V_a, su.Y, su.S, su.dev, su.inj_db, m, n, c,
                            su.lineY)
    f = f[su.consts.inv_f_perm]
    Sr, Si = su.S.re.contiguous(), su.S.im.contiguous()
    hist = torch.full((settings.max_iter_h, B), float("nan"), dtype=rd,
                      device=dv)
    it = torch.zeros((B,), dtype=torch.int32, device=dv)
    t = 0
    act = (err > su.thresh) & (it < settings.max_iter_h)
    while bool(act.any()):
        V_m, V_a, f, err2 = fused_trip(dims, tc, V_m, V_a, f, err[None],
                                       act.to(rd)[None], Sr, Si, inj)
        err = err2[0]
        hist[t] = torch.where(act, err, hist[t])
        it = it + act.to(torch.int32)
        t += 1
        act = (err > su.thresh) & (it < settings.max_iter_h)
    V_m, V_a = cleanup_voltages(V_m, V_a)
    return _lanes_result(V_m, V_a, err, it, hist, su.thresh, su.fund)
