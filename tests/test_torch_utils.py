"""hpfx_torch.utils and hpfx_torch.entry on the CPU: the NaN check, the
precision guard, the profiler trace, ``entry()`` against the JAX
package's (the two-rank dry run is in test_torch_parallel)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx_torch.entry import entry
from hpfx_torch.utils import debug_nans, highest_precision, profile_trace
from test_torch_foundations import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")


def test_debug_nans_raises_at_the_first_nan():
    x = torch.zeros(3, dtype=torch.float64)
    with debug_nans():
        y = x + 1.0
        with pytest.raises(FloatingPointError, match="div"):
            x / x
    assert torch.isnan(x / x).all()          # outside: no check
    with debug_nans(enable=False):
        x / x
    assert torch.equal(y, torch.ones(3, dtype=torch.float64))


def test_debug_nans_silent_through_a_clean_solve():
    """A clean net2 H<=5 solve makes no NaN: its NaN-padded histories are
    fills, not results."""
    s = ht.settings_for_hmax(5, coupled=True, dtype="float64")
    net = ht.load_network(os.path.join(DATA, "net2_buses.csv"),
                          os.path.join(DATA, "net2_lines.csv"), s,
                          device="cpu")
    with debug_nans():
        res = ht.hpf(net, ht.load_device_set(net, s), s)
    assert bool(res.converged) and torch.isnan(res.err_hist).any()


def test_highest_precision_restores_the_setting():
    torch.set_float32_matmul_precision("medium")
    seen = []

    @highest_precision
    def f():
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        raise ValueError("inside")

    try:
        with pytest.raises(ValueError):
            f()
        assert seen == [("highest", False, False)]
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_entry_matches_the_reference_sweep():
    """entry() on the CPU against __graft_entry__'s step (net2 H<=25 B=64,
    float64): the same converged flags and the same roots.  The cold
    start's residuals ~1e2 amplify the packages' rounding, so 3 of the 64
    scenarios (measured) take other paths, 1-5 trips apart, and stop
    within the Newton tolerance of the same root: the voltages are held
    to 1e-6 pu (measured 8.8e-9), the counts not compared."""
    from hpfx.solve import Scenarios, hpf_sweep
    fn, args = entry(device="cpu")
    res = fn(*args)
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                            os.path.join(DATA, "net2_lines.csv"), s)
    lin = lambda a, b: jnp.linspace(a, b, 64)
    ref = hpf_sweep(net, hpfx.load_device_set(net, s), settings=s,
                    scenarios=Scenarios(lin(0.9, 1.1), lin(0.9, 1.1),
                                        lin(0.8, 1.2)))
    assert res.V_m.dtype == torch.float64 and res.V_m.device.type == "cpu"
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(res.V_m.numpy(), np.asarray(ref.V_m),
                               rtol=0, atol=1e-6)
