"""hpfx_torch foundations against the JAX package, on the CPU in float64:
network and device loading, admittance assembly, the stable matvec, the
arrow index maps and the state hand-over (hpfx_torch.convert)."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import lanes as jl
from hpfx.arrow import make_arrow_index as j_arrow_index
from hpfx.harmonic import cleanup_voltages as j_cleanup
from hpfx.results import get_thd as j_thd
from hpfx.ybus import build_line_ybus as j_line_ybus
from hpfx_torch import lanes as tl
from hpfx_torch.arrow import make_arrow_index
from hpfx_torch.ybus import build_line_ybus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")
NETS = ("net1", "net2", "net3")
TOL = 1e-13


def _paths(name):
    return (os.path.join(DATA, f"{name}_buses.csv"),
            os.path.join(DATA, f"{name}_lines.csv"))


def _settings(coupled=True, **kw):
    s = hpfx.settings_for_hmax(25, coupled=coupled, stable_mismatch=True,
                               **kw)
    return s, ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64")


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(a).max()))


def _cx_close(j, t, tol=TOL):
    _close(j.re, t.re.numpy(), tol)
    _close(j.im, t.im.numpy(), tol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch's CPU ops on one thread in the port's test modules (each
    imports this fixture).  With pytest workers sharing the cores, a
    multi-threaded op waits for threads that are not scheduled: the net1
    float32 sweep of test_torch_net1.py takes 6 s on one thread and did
    not end in 900 s with 8 threads on 2 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def net_leaves(net):
    return {f.name: getattr(net, f.name) for f in dataclasses.fields(net)}


def dev_leaves(dev):
    return dict(I_N=(np.asarray(dev.I_N.re), np.asarray(dev.I_N.im)),
                Y_N=(np.asarray(dev.Y_N.re), np.asarray(dev.Y_N.im)),
                coupled=dev.coupled)


@pytest.mark.parametrize("name", NETS)
def test_load_network_matches(name):
    s, ts = _settings()
    jn = hpfx.load_network(*_paths(name), s)
    tn = ht.load_network(*_paths(name), ts, device="cpu")
    for f in dataclasses.fields(jn):
        jv, tv = getattr(jn, f.name), getattr(tn, f.name)
        if isinstance(tv, torch.Tensor):
            _close(jv, tv.numpy())
        else:
            assert jv == tv, f.name


@pytest.mark.parametrize("coupled", [True, False], ids=["c", "uc"])
@pytest.mark.parametrize("name", NETS)
def test_load_device_set_matches(name, coupled):
    s, ts = _settings(coupled)
    jd = hpfx.load_device_set(hpfx.load_network(*_paths(name), s), s)
    td = ht.load_device_set(
        ht.load_network(*_paths(name), ts, device="cpu"), ts)
    assert td.coupled == jd.coupled
    _cx_close(jd.I_N, td.I_N)
    _cx_close(jd.Y_N, td.Y_N)


@pytest.mark.parametrize("compat", [False, True], ids=["plain", "compat"])
@pytest.mark.parametrize("name", NETS)
def test_build_ybus_matches(name, compat):
    s, ts = _settings(compat_shunt_bug=compat)
    Yj = hpfx.build_ybus(hpfx.load_network(*_paths(name), s), s)
    Yt = ht.build_ybus(ht.load_network(*_paths(name), ts, device="cpu"),
                       ts)
    _cx_close(Yj, Yt)


@pytest.mark.parametrize("name", NETS)
def test_build_line_ybus_matches(name):
    s, ts = _settings()
    lj = j_line_ybus(hpfx.load_network(*_paths(name), s), s)
    lt = build_line_ybus(
        ht.load_network(*_paths(name), ts, device="cpu"), ts)
    _cx_close(lj.Ys, lt.Ys)
    _cx_close(lj.d, lt.d)
    for k in ("a_ff", "inv_tau", "shift", "f_idx", "t_idx"):
        _close(getattr(lj, k), getattr(lt, k).numpy())


@pytest.mark.parametrize("name", NETS)
def test_stable_matvec_lanes_matches(name):
    s, ts = _settings()
    jn = hpfx.load_network(*_paths(name), s)
    tn = ht.load_network(*_paths(name), ts, device="cpu")
    rng = np.random.default_rng(11)
    shape = (s.n_harmonics, jn.n, 5)
    V_m = rng.uniform(-0.2, 1.1, shape)
    V_a = rng.uniform(-np.pi, np.pi, shape)
    out_j = jl.stable_matvec_lanes(j_line_ybus(jn, s), jnp.asarray(V_m),
                                   jnp.asarray(V_a))
    out_t = tl.stable_matvec_lanes(build_line_ybus(tn, ts),
                                   torch.tensor(V_m), torch.tensor(V_a))
    _cx_close(out_j, out_t)


@pytest.mark.parametrize("name", NETS)
def test_arrow_index_matches(name):
    s, _ = _settings()
    jn = hpfx.load_network(*_paths(name), s)
    args = (s.n_harmonics, jn.n, jn.m, jn.c)
    ij, it = j_arrow_index(*args), make_arrow_index(*args)
    for k in ij._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ij, k)),
                                      np.asarray(getattr(it, k)), err_msg=k)


def test_thd_and_cleanup_match():
    rng = np.random.default_rng(3)
    V_m = rng.uniform(-1.0, 1.0, (13, 4, 6))
    V_a = rng.uniform(-7.0, 7.0, (13, 4, 6))
    jm, ja = j_cleanup(jnp.asarray(V_m), jnp.asarray(V_a))
    tm, ta = ht.cleanup_voltages(torch.tensor(V_m), torch.tensor(V_a))
    _close(jm, tm.numpy())
    _close(ja, ta.numpy(), 1e-12)
    thd_j, thd_t = j_thd(jm), ht.get_thd(tm)
    _close(thd_j.THD_F, thd_t.THD_F.numpy(), 1e-12)
    _close(thd_j.THD_R, thd_t.THD_R.numpy(), 1e-12)


@pytest.mark.parametrize("name", NETS)
def test_from_hpfx_arrays_round_trip(name):
    s, _ = _settings()
    jn = hpfx.load_network(*_paths(name), s)
    jd = hpfx.load_device_set(jn, s)
    tn, td = ht.from_hpfx_arrays(net_leaves(jn), dev_leaves(jd),
                                  device="cpu")
    for f in dataclasses.fields(jn):
        jv, tv = getattr(jn, f.name), getattr(tn, f.name)
        if isinstance(tv, torch.Tensor):
            back = tv.numpy()
            np.testing.assert_array_equal(back, np.asarray(jv))
            assert back.dtype.kind == np.asarray(jv).dtype.kind
        else:
            assert tv == jv
    for part in ("I_N", "Y_N"):
        for k in ("re", "im"):
            np.testing.assert_array_equal(
                getattr(getattr(td, part), k).numpy(),
                np.asarray(getattr(getattr(jd, part), k)))
    assert td.coupled == jd.coupled


def _loader_calls():
    """Each loader of the port, called with the given device keywords."""
    s, ts = _settings()
    jn = hpfx.load_network(*_paths("net2"), s)
    jd = hpfx.load_device_set(jn, s)
    return {
        "load_network": lambda **kw: ht.load_network(*_paths("net2"), ts,
                                                     **kw),
        "network_from_arrays": lambda **kw: ht.network_from_arrays(
            bus_types=(0, 3), components=("generator", "SMPS"), P=[0, 0.2],
            Q=[0, 0.1], line_from=[0], line_to=[1], R=[0.1], X=[0.2],
            settings=ts, **kw),
        "synthetic_feeder": lambda **kw: ht.synthetic_feeder(8, 2, ts, **kw),
        "from_hpfx_arrays": lambda **kw: ht.from_hpfx_arrays(
            net_leaves(jn), dev_leaves(jd), **kw)[0],
    }


@pytest.mark.parametrize("loader", ["load_network", "network_from_arrays",
                                    "synthetic_feeder", "from_hpfx_arrays"])
def test_loaders_default_to_the_card(monkeypatch, loader):
    """With no device= every loader puts its data on the CUDA card, and
    with no card it raises rather than fall back to the CPU; device="cpu"
    gives CPU tensors."""
    call = _loader_calls()[loader]
    net = call(device="cpu")
    assert net.bus_P.device.type == "cpu"
    assert net.line_from.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_resolve_device():
    from hpfx_torch._device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_import_leaves_jax_out():
    code = ("import sys; sys.path.insert(0, %r); import hpfx_torch, "
            "hpfx_torch.solve, hpfx_torch.ops._build, hpfx_torch.simulate, "
            "hpfx_torch.examples, hpfx_torch.examples.demo, "
            "hpfx_torch.__main__, hpfx_torch.parallel, hpfx_torch.entry, "
            "hpfx_torch.utils; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hpfx')); print(bad); "
            "sys.exit(1 if bad else 0)" % REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exports_cover_the_reference():
    """Every name the JAX package exports is an attribute of the port and
    listed in its ``__all__``."""
    missing = [n for n in hpfx.__all__ if not hasattr(ht, n)]
    unlisted = [n for n in hpfx.__all__ if n not in ht.__all__]
    assert not missing and not unlisted, (missing, unlisted)
    assert len(set(ht.__all__)) == len(ht.__all__)
    assert all(hasattr(ht, n) for n in ht.__all__)


def test_at_add_repeats_accumulate_in_index_order():
    """Cx.at_add with repeated advanced indices (two lines into one bus)
    adds the repeats in index order, the order of a sequential loop, bit
    for bit: the same on every device and every call (a CUDA index_add_
    would add them in a racing order)."""
    rng = np.random.default_rng(3)
    idx = torch.tensor([4, 1, 4, 0, 4, 1, 7])
    base = ht.Cx(*(torch.tensor(rng.normal(size=8)) for _ in range(2)))
    val = ht.Cx(*(torch.tensor(rng.normal(size=7) * 10.0 ** rng.integers(
        -8, 8, 7)) for _ in range(2)))
    got = base.at_add(idx, val)
    for part in ("re", "im"):
        want = getattr(base, part).clone()
        for i, k in enumerate(idx.tolist()):
            want[k] += getattr(val, part)[i]
        assert torch.equal(getattr(got, part), want)


def test_cx_and_eye_match():
    """``cx.cx`` (a real part, an optional imaginary part, zero by
    default) and ``cx.eye`` against the JAX package's."""
    from hpfx import cx as jcx
    from hpfx_torch import cx as tcx
    re = np.linspace(-1.0, 2.0, 6).reshape(2, 3)
    im = np.arange(6.0).reshape(2, 3)
    for args in ((re,), (re, im)):
        got = tcx.cx(*(torch.tensor(a) for a in args))
        want = jcx.cx(*(jnp.asarray(a) for a in args))
        for part in ("re", "im"):
            np.testing.assert_array_equal(getattr(got, part).numpy(),
                                          np.asarray(getattr(want, part)))
    got, want = tcx.eye(4, torch.float32), jcx.eye(4, jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    for part in ("re", "im"):
        np.testing.assert_array_equal(getattr(got, part).numpy(),
                                      np.asarray(getattr(want, part)))
