"""The plain reference against hpfx_torch, both in float64, on the
configurations' own networks at small batches and H<=5 to H<=9.  (net1
at H<=5 is left out: the port's polar Newton does not converge there from
the cold start on most draws, in float64 too, where the reference's
rectangular one does; the scenarios that it converges agree to 1e-9.)"""
import pytest
import torch

from harness import check, spec
from reference import hpf_ref

import hpfx_torch as ht


@pytest.mark.parametrize("config,h_max,B", [("net2", 5, 16), ("net1", 7, 4),
                                            ("net2", 9, 8), ("net1", 9, 4)])
def test_reference_is_the_port_in_float64(config, h_max, B):
    torch.set_num_threads(1)
    cfg = spec._json(f"{spec.BENCH_DIR}/configs/{config}.json")
    g = torch.Generator().manual_seed(11)
    u = torch.rand((3, B), generator=g, dtype=torch.float64)
    p, q, s = 0.8 + 0.4 * u[0], 0.8 + 0.4 * u[1], 0.6 + 0.8 * u[2]
    pb = check.problem(cfg, h_max)
    V_ref, res, it = hpf_ref.solve(pb, p, q, s)
    assert float(res.max()) < 1e-10 and it < 30

    st = ht.settings_for_hmax(h_max, **dict(cfg["settings"],
                                            dtype="float64"),
                              thresh_h=1e-10, thresh_f=1e-12)
    root = spec.ROOT
    net = ht.load_network(f"{root}/{cfg['buses']}", f"{root}/{cfg['lines']}",
                          st, device="cpu")
    dev = ht.load_device_set(net, st,
                             search_dirs=(f"{root}/{cfg['device_tables']}",))
    r = ht.hpf_sweep(net, dev, st, ht.Scenarios(p, q, s))
    assert bool(r.converged.all())
    gap = check.phasor_gap(r.V_m, r.V_a, V_ref)
    assert float(gap.max()) < 1e-9


def test_the_reference_reads_the_tables_as_given():
    cfg = spec._json(f"{spec.BENCH_DIR}/configs/net2.json")
    pb = check.problem(cfg, 5)
    # line 2-3: R = 1 ohm, X = 4 ohm at 400 V, 1 kW: z_base = 160 ohm
    y = 1 / ((1 + 1j * 3 * 4) / 160)
    assert pb.Y[1, 1, 2] == pytest.approx(-y)
    # the slack's shunt of 0.005 ohm, on the 3rd and 5th orders only
    assert pb.Y[0, 0, 0] == pytest.approx(sum(
        1 / ((r + 1j * x) / 160) for r, x in ((0.5, 0.5), (0.5, 1))))
    assert pb.Y[2, 0, 0] - pb.Y[0, 0, 0] != 0
    assert pb.I_N.shape == (1, 3) and pb.Y_N.shape == (1, 3, 3)
    assert (pb.m, pb.c, pb.n) == (3, 1, 4)
