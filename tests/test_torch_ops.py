"""hpfx_torch.ops.batched_solve on the CPU: the plain Gauss-Jordan twins of
the CUDA kernels (the direct elimination and one panel of the blocked
solve) against the JAX package's Pallas kernels (run by Pallas on the
CPU) and its unrolled-XLA elimination, the blocked panel solve,
equilibration, and the dispatch rules.  The CUDA kernels themselves are
checked on the card by chip_smoke.py."""
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpfx_torch.ops import batched_solve as tbs

from test_torch_foundations import one_torch_thread  # noqa: F401

# the module (hpfx.ops re-exports a function of the same name)
jbs = importlib.import_module("hpfx.ops.batched_solve")

#: f32 elimination error bound of tests/test_ops.py:27
F32_TOL = 3e-5


def _systems(n, R, B, seed, dtype=np.float32):
    """Diagonally boosted random lane-major systems (tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n, B)) + 3.0 * np.sqrt(n) * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, R, B))
    return A.astype(dtype), b.astype(dtype)


def _np_solve(A, b):
    return np.moveaxis(np.linalg.solve(np.moveaxis(A, -1, 0).astype(np.float64),
                                       np.moveaxis(b, -1, 0).astype(np.float64)),
                       0, -1)


def _pivot_system(n, B):
    """Zero-diagonal systems: elimination without pivoting divides by 0."""
    A, b = _systems(n, 1, B, seed=5)
    A = 0.1 * A + 3.0 * np.sqrt(n) * np.roll(np.eye(n), 1, axis=1)[:, :, None]
    A[np.arange(n), np.arange(n), :] = 0.0
    return A.astype(np.float32), b


@pytest.mark.parametrize("n,B", [(26, 130), (96, 128)],
                         ids=["gj_kernel_26x130", "gj_kernel_carried_96x128"])
def test_ref_matches_pallas(n, B):
    """The twin against the Pallas kernel it stands for: dim 26 takes
    _gj_kernel, dim 96 _gj_kernel_carried (the main path's two dims)."""
    A, b = _systems(n, 1, B, seed=n)
    x_j = np.asarray(jbs.gauss_solve_pallas_lanes(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    x_t = tbs.gj_solve_lanes_ref(torch.tensor(A), torch.tensor(b)).numpy()
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(x_t, _np_solve(A, b), rtol=0,
                               atol=F32_TOL * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_ref_matches_xla_lanes(dtype):
    """The twin against gj_solve_xla_lanes at the arrow blocks' shape
    (dim 8, 3 right-hand sides): same pivots, same update formula."""
    A, b = _systems(8, 3, 256, seed=8, dtype=dtype)
    x_j = np.asarray(jbs.gj_solve_xla_lanes(jnp.asarray(A), jnp.asarray(b)))
    x_t = tbs.gj_solve_lanes_ref(torch.tensor(A), torch.tensor(b)).numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=tol * np.abs(x_j).max())


@pytest.mark.parametrize("n", [2, 26, 96])
def test_ref_pivots_zero_diagonal(n):
    A, b = _pivot_system(n, 3)
    x_t = tbs.gj_solve_lanes_ref(torch.tensor(A), torch.tensor(b)).numpy()
    ref = _np_solve(A, b)
    np.testing.assert_allclose(x_t, ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def test_ref_pivot_case_matches_pallas():
    A, b = _pivot_system(26, 5)
    x_j = np.asarray(jbs.gauss_solve_pallas_lanes(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    x_t = tbs.gj_solve_lanes_ref(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=F32_TOL * np.abs(x_j).max())


def test_ref_ragged_batch():
    """B = 5, far from any multiple of 128, through the kernel wrapper."""
    A, b = _systems(26, 2, 5, seed=2)
    x = tbs.gauss_solve_lanes(torch.tensor(A), torch.tensor(b))
    assert x.shape == (26, 2, 5) and x.dtype == torch.float32
    ref = _np_solve(A, b)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def test_equilibrated_lanes_matches_jax():
    """Row/column equilibration around the same LU solve agrees with the
    JAX wrapper on badly scaled systems."""
    A, b = _systems(12, 2, 7, seed=4, dtype=np.float64)
    rng = np.random.default_rng(9)
    A = A * 10.0 ** rng.uniform(-3, 3, (12, 1, 7)) \
        * 10.0 ** rng.uniform(-2, 2, (1, 12, 7))
    x_j = np.asarray(jbs.equilibrated_lanes(jbs._lu_solve_lanes)(
        jnp.asarray(A), jnp.asarray(b)))
    x_t = tbs.equilibrated_lanes(tbs._lu_solve_lanes)(
        torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-12,
                               atol=1e-12 * np.abs(x_j).max())


@pytest.mark.parametrize("n", [8, 26, 96])
def test_cpu_dispatch_takes_plain_path(n):
    """On CPU tensors the f32 dispatcher solves with the plain twin
    (equilibrated) and launches no kernel."""
    for k in tbs.LAUNCHES:
        tbs.LAUNCHES[k] = 0
    A, b = _systems(n, 1, 9, seed=n + 1)
    At, bt = torch.tensor(A), torch.tensor(b)
    x = tbs.batched_solve_lanes(At, bt)
    want = tbs.equilibrated_lanes(tbs.gj_solve_lanes_ref)(At, bt)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    assert tbs.LAUNCHES == {"gj_kernel": 0, "gj_kernel_carried": 0,
                            "gj_kernel_unrolled": 0, "gj_panel_kernel": 0,
                            "fused_trip_kernel": 0, "rectifier_kernel": 0}


@pytest.mark.parametrize("unrolled", [False, True], ids=["carried",
                                                         "unrolled"])
def test_unrolled_flag_routes_large_dims(monkeypatch, unrolled):
    """GJ_UNROLLED (HPFX_GJ_UNROLLED=1) sends dims >= 64 to
    gj_kernel_unrolled on the card; below 64 the route stays gj_kernel,
    and CPU tensors still take the plain version, launching nothing."""
    monkeypatch.setattr(tbs, "GJ_UNROLLED", unrolled)
    big = "gj_kernel_unrolled" if unrolled else "gj_kernel_carried"
    assert [tbs.kernel_for(n) for n in (17, 63, 64, 96, 192)] == \
        ["gj_kernel"] * 2 + [big] * 3
    for k in tbs.LAUNCHES:
        tbs.LAUNCHES[k] = 0
    A, b = _systems(96, 2, 3, seed=96)
    At, bt = torch.tensor(A), torch.tensor(b)
    torch.testing.assert_close(tbs.gauss_solve_lanes(At, bt),
                               tbs.gj_solve_lanes_ref(At, bt), rtol=0, atol=0)
    assert not any(tbs.LAUNCHES.values())


def _plan_ok(n, R):
    """launch_plan(n, R) checked against the instantiation tables: the
    kernel kernel_for names without GJ_UNROLLED, the narrowest
    instantiation whose slots hold [A | b] (for gj_kernel, A with b in
    shared memory where none does), the threads and systems a block and
    the dynamic shared memory of csrc/gj_solve.cu's layout."""
    p = tbs.launch_plan(n, R)
    if n < tbs.KERNEL_SWITCH_DIM:
        assert p.kernel == "gj_kernel"
        assert p.rows == (1 if n <= 32 else 2)
        assert p.systems == 8 // p.rows and p.threads == 32 * p.systems
        reg, smem = tbs.K1_INSTANCES, tbs.K1_SMEM_INSTANCES
    else:
        assert p.kernel == "gj_kernel_carried"
        assert p.rows == -(-n // 32) * 32
        assert p.systems == 1
        per_row, per_thread = tbs.K2_LAYOUT.get((p.rows, p.slots), (1, 1))
        assert p.threads == p.rows * per_row // per_thread
        reg, smem = tbs.K2_INSTANCES, ()
    fits = sorted(w for r, w in reg if r == p.rows and w >= n + R)
    if fits:
        assert not p.b_in_smem and p.slots == fits[0] and p.smem == 0
    else:
        fits = sorted(w for r, w in smem if r == p.rows and w >= n)
        assert p.b_in_smem and p.slots == fits[0]
        per = 32 * p.rows * (R | 1) + 2 * R
        assert p.smem == 4 * per * p.systems
    return p


#: what launch_plan's ValueError names past one block: gj_kernel's shared
#: memory, gj_kernel_carried's register slots
PAST_ONE_BLOCK = "bytes of shared memory|register slots"


@pytest.mark.parametrize("lo,hi", [(17, 63), (64, 192)],
                         ids=["gj_kernel", "gj_kernel_carried"])
def test_launch_plan_takes_every_dispatched_shape(lo, hi):
    """Every (n, R) the dispatcher can send to a direct kernel, 17 <= n <=
    192 and 1 <= R <= 63 (the arrow blocks send R = 1 + 2·n_nl), has an
    instantiation on the card, or raises ValueError naming the limit; the
    net2 and net1 path shapes keep [A | b] in registers, and so does every
    shape of gj_kernel_carried (it has no shared-memory form)."""
    planned = set()
    for n in range(lo, hi + 1):
        for R in range(1, 64):
            try:
                p = _plan_ok(n, R)
            except ValueError as e:
                assert re.search(PAST_ONE_BLOCK, str(e))
                continue
            planned.add((p.rows, p.slots, p.b_in_smem))
    tables = ((tbs.K1_INSTANCES, tbs.K1_SMEM_INSTANCES) if lo < 64 else
              (tbs.K2_INSTANCES, ()))
    every = {(r, w, m) for m, t in zip((False, True), tables) for r, w in t}
    # a lane's single row holds up to 95 columns in slots, so the smem
    # form of one row a lane takes only R > 63
    assert planned == every - {(1, 32, True)}
    assert _plan_ok(30, 80).b_in_smem
    for n, R in ((26, 1), (38, 1), (40, 15), (96, 1), (126, 1), (128, 15)):
        assert not tbs.launch_plan(n, R).b_in_smem
    with pytest.raises(ValueError, match="exceeds"):
        tbs.launch_plan(193, 1)
    with pytest.raises(ValueError, match=PAST_ONE_BLOCK):
        tbs.launch_plan(hi, 4096)


#: the launch plans of the path shapes that do not take the wide rows, as
#: the shared-memory form's last commit planned them
NARROW_PLANS = {
    (26, 1): tbs.LaunchPlan("gj_kernel", 1, 32, False, 256, 8, 0),
    (38, 1): tbs.LaunchPlan("gj_kernel", 2, 40, False, 128, 4, 0),
    (40, 15): tbs.LaunchPlan("gj_kernel", 2, 56, False, 128, 4, 0),
    (96, 1): tbs.LaunchPlan("gj_kernel_carried", 96, 112, False, 96, 1, 0),
    (126, 1): tbs.LaunchPlan("gj_kernel_carried", 128, 144, False, 128, 1,
                             0),
    (128, 15): tbs.LaunchPlan("gj_kernel_carried", 128, 144, False, 128, 1,
                              0),
}


@pytest.mark.parametrize("n,R", sorted(NARROW_PLANS))
def test_narrow_path_shapes_keep_their_plan(n, R):
    """net2's, net1's and the 64-bus feeder's shapes keep the plan they
    had before the wide rows moved into registers, whole (as
    chunked_plan gives it too: one chunk)."""
    assert tbs.launch_plan(n, R) == NARROW_PLANS[(n, R)]
    assert tbs.chunked_plan(n, R) == (NARROW_PLANS[(n, R)], R)


@pytest.mark.parametrize("n,R", [(130, 65), (130, 78), (161, 47), (182, 1),
                                 (192, 16), (102, 48)])
def test_wide_rows_plan_into_registers(n, R):
    """The IEEE 33-bus feeder's arrow blocks (130, 65) and the other shapes
    whose [A | b] passes the narrow instantiations plan into registers,
    split over two or four threads a row, directly and through
    chunked_plan (one chunk)."""
    p = _plan_ok(n, R)
    assert not p.b_in_smem and p.smem == 0 and n + R <= p.slots
    assert tbs.K2_LAYOUT[(p.rows, p.slots)][0] > 1
    assert tbs.chunked_plan(n, R) == (p, R)
    if (n, R) == (130, 65):
        assert p == tbs.LaunchPlan("gj_kernel_carried", 160, 208, False,
                                   320, 1, 0)


@pytest.mark.parametrize("n", [64, 96, 130, 160, 192])
def test_wide_right_hand_sides_split_into_register_chunks(n):
    """Past the widest instantiation of its rows, chunked_plan splits R
    into near-equal chunks that each fit the register slots; the chunk
    fills the widest slots no more than one block's worth."""
    widest = tbs._widest_chunk(n)
    rows = -(-n // 32) * 32
    assert widest == max(w for r, w in tbs.K2_INSTANCES if r == rows) - n
    for R in (widest + 1, 2 * widest, 3 * widest + 1, 3200):
        p, chunk = tbs.chunked_plan(n, R)
        assert p == _plan_ok(n, chunk) and not p.b_in_smem
        assert -(-R // chunk) == -(-R // widest)


@pytest.mark.parametrize("n,R", [(26, 1), (40, 15), (96, 1)])
def test_cpu_solve_bit_identical_badly_scaled(n, R):
    """On CPU tensors batched_solve_lanes, and the fused route it takes on
    the card, are equilibrated_lanes around the plain twin bit for bit, on
    systems whose rows and columns span 1e-3..1e3."""
    A, b = _systems(n, R, 7, seed=40 + n)
    rng = np.random.default_rng(n)
    A = (A * 10.0 ** rng.uniform(-3, 3, (n, 1, 7))
         * 10.0 ** rng.uniform(-3, 3, (1, n, 7))).astype(np.float32)
    At, bt = torch.tensor(A), torch.tensor(b)
    want = tbs.equilibrated_lanes(tbs.gj_solve_lanes_ref)(At, bt)
    for x in (tbs.batched_solve_lanes(At, bt),
              tbs.equilibrated_gauss_solve_lanes(At, bt)):
        assert torch.equal(x.view(torch.int32), want.view(torch.int32))
    ref = _np_solve(A, b)
    np.testing.assert_allclose(want.numpy(), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


@pytest.mark.parametrize("unrolled", [False, True], ids=["carried",
                                                         "unrolled"])
def test_kernel_route_and_equilibration(monkeypatch, unrolled):
    """kernel_for names the same kernels as before the equilibration moved
    into them, and every one of them runs it inside, gj_kernel_unrolled
    (the GJ_UNROLLED route) as well."""
    monkeypatch.setattr(tbs, "GJ_UNROLLED", unrolled)
    dims = (17, 26, 40, 63, 64, 96, 128, 182, 192)
    names = [tbs.kernel_for(n) for n in dims]
    big = "gj_kernel_unrolled" if unrolled else "gj_kernel_carried"
    assert names == ["gj_kernel"] * 4 + [big] * 5
    assert [tbs.fuses_equilibration(n) for n in dims] == [True] * 9


def test_f64_goes_to_linalg_solve():
    A, b = _systems(26, 2, 6, seed=6, dtype=np.float64)
    At, bt = torch.tensor(A), torch.tensor(b)
    x = tbs.batched_solve_lanes(At, bt)
    want = torch.linalg.solve(At.permute(2, 0, 1),
                              bt.permute(2, 0, 1)).permute(1, 2, 0)
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_f64_singular_lane_is_nonfinite_not_an_error():
    """A singular float64 system makes its own lane non-finite and leaves
    the others as they were, as the JAX package's LU does (the Newton loop
    then reports that scenario unconverged); torch.linalg.solve would
    raise for the whole batch.  Every float64 LU route: lane-major,
    batch-major, the block solves, the Newton solve and cx.solve."""
    from hpfx_torch import cx
    A, b = _systems(26, 2, 6, seed=6, dtype=np.float64)
    A[:, 3, 2] = 0.0                       # lane 2: a zero column
    jx = np.asarray(jbs.batched_solve_lanes(jnp.asarray(A), jnp.asarray(b)))
    At, bt = torch.tensor(A), torch.tensor(b)
    x = tbs.batched_solve_lanes(At, bt).numpy()
    ok = np.arange(6) != 2
    assert not np.isfinite(jx[..., 2]).all()
    assert not np.isfinite(x[..., 2]).all()
    np.testing.assert_allclose(x[..., ok], jx[..., ok], rtol=0, atol=1e-12)
    Ab, bb = At.permute(2, 0, 1), bt.permute(2, 0, 1)
    zero = lambda t: torch.zeros_like(t)
    outs = [tbs.batched_solve(Ab, bb),
            tbs.solve_blocks(Ab[None], bb[None])[0],
            tbs.nr_solve(Ab, bb[..., 0])[..., None],
            cx.solve(cx.Cx(Ab, zero(Ab)), cx.Cx(bb, zero(bb))).re]
    xb = np.moveaxis(x, -1, 0)[ok]
    for y in outs:
        assert not torch.isfinite(y[2]).all()
        np.testing.assert_allclose(y[ok].numpy(), xb[..., :y.shape[-1]],
                                   rtol=0, atol=1e-12)


def test_kernel_wrapper_rejects_bad_operands():
    A, b = _systems(26, 1, 4, seed=1)
    At, bt = torch.tensor(A), torch.tensor(b)
    with pytest.raises(TypeError):
        tbs.gauss_solve_lanes(At.double(), bt.double())
    with pytest.raises(ValueError, match="contiguous"):
        tbs.gauss_solve_lanes(At.transpose(0, 1), bt)
    with pytest.raises(ValueError, match="expected"):
        tbs.gauss_solve_lanes(At, bt[:, :, :3])
    big = torch.zeros((200, 200, 2))
    with pytest.raises(ValueError, match="exceeds"):
        tbs.gauss_solve_lanes(big, torch.zeros((200, 1, 2)))


@pytest.mark.parametrize("n,impl", [(130, "panel"), (130, "schur"),
                                    (200, "auto")])
def test_blocked_dims_route(n, impl):
    """Where the JAX dispatcher takes a blocked solve: impl="panel" above
    128 and any impl but "schur" above 192 go to the (equilibrated) panel
    solve, impl="schur" above 128 to the (equilibrated) panel-Schur
    solve."""
    A, b = _systems(n, 2, 3, seed=n)
    At, bt = torch.tensor(A), torch.tensor(b)
    x = tbs.batched_solve_lanes(At, bt, impl=impl)
    blocked = tbs.schur_solve_lanes if impl == "schur" \
        else tbs.panel_gj_solve_lanes
    want = tbs.equilibrated_lanes(blocked)(At, bt)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    ref = _np_solve(A, b)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def _panel_full_width(panel, used):
    """The panel elimination step for step as the TPU kernel
    ``_gj_panel_kernel`` does it, at full width: every step updates all Pw
    columns of A and of TE = T·E.  -> (Ap, TE, E, used_out)."""
    N, Pw, B = panel.shape
    rows = torch.arange(N)[:, None]
    A = panel
    TE = torch.zeros_like(panel)
    E = torch.zeros_like(panel)
    take = lambda X, p: X.gather(0, p.view(1, 1, B).expand(1, X.shape[1],
                                                           B))[0]
    for k in range(Pw):
        colk = A[:, k, :]
        p = torch.argmax(colk.abs() - 1e30 * used, dim=0)
        on_p = rows == p[None, :]
        E[:, k, :] = on_p
        TE[:, k, :] = on_p
        rowp, tep = take(A, p), take(TE, p)
        inv_piv = 1.0 / colk.gather(0, p[None])[0]
        w = torch.where(on_p, 1.0 - inv_piv[None, :], colk * inv_piv[None, :])
        A = A - w[:, None, :] * rowp[None, :, :]
        TE = TE - w[:, None, :] * tep[None, :, :]
        used = torch.maximum(used, on_p.to(used.dtype))
    return A, TE, E, used


def _panel_case(N, Pw, B, n_used, seed, pivot=False):
    """A panel as a middle panel sees it: ``n_used`` random rows of each
    system already used; with ``pivot`` the panel of a zero-diagonal
    system whose large entries lie in rows of other panels."""
    rng = np.random.default_rng(seed)
    panel = rng.normal(size=(N, Pw, B)).astype(np.float32)
    if pivot:
        panel *= 0.1
        panel[(np.arange(Pw) + N // 2) % N, np.arange(Pw)] += 3.0 * np.sqrt(N)
    used = np.zeros((N, B), np.float32)
    for i in range(B):
        used[rng.choice(N, n_used, replace=False), i] = 1.0
    return panel, used


def test_panel_ref_matches_pallas():
    """One panel (N=192, Pw=32, B=8) of the blocked solve, as the second
    panel sees it (32 rows already used): the twin, its outputs expanded
    from the pivots, against _gj_panel_kernel run by Pallas on the CPU.
    E and used agree exactly (the pivot sequence is the same); TE = Z + E
    and Ap (the pivot permutation) to F32_TOL of their scale."""
    N, Pw, B = 192, 32, 8
    panel, used = _panel_case(N, Pw, B, Pw, seed=192)
    outs_j = jbs._panel_pallas(jnp.asarray(panel[None]), jnp.asarray(used[None]),
                               Pw=Pw, N=N, Bb=B, G=1, interpret=True)
    Z, piv, used_t = tbs.gj_panel_ref(torch.tensor(panel), torch.tensor(used))
    assert Z.shape == (N, Pw, B) and piv.shape == (Pw, B)
    assert piv.dtype == torch.int32
    outs_t = (*tbs.expand_panel(Z, piv), used_t)
    for name, j, t in zip(("Ap", "TE", "E", "used"), outs_j, outs_t):
        j = np.asarray(j)[0]
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=F32_TOL * np.abs(j).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(outs_t[2].numpy(), np.asarray(outs_j[2])[0])
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3])[0])


@pytest.mark.parametrize("N,Pw,B,n_used,pivot", [
    (192, 32, 6, 32, False), (40, 8, 5, 0, False), (64, 16, 4, 16, True),
    (72, 24, 3, 48, False)],
    ids=["panel_192x32", "panel_40x8_first", "panel_64x16_pivot",
         "panel_72x24_last"])
def test_panel_ref_matches_full_width(N, Pw, B, n_used, pivot):
    """The live-column twin against the step-for-step full-width update:
    the same pivots and mask exactly, Z = TE - E to F32_TOL of its scale."""
    panel, used = _panel_case(N, Pw, B, n_used, seed=N + Pw, pivot=pivot)
    Z, piv, used_t = tbs.gj_panel_ref(torch.tensor(panel), torch.tensor(used))
    _, TE, E, used_f = _panel_full_width(torch.tensor(panel),
                                         torch.tensor(used))
    E_t = tbs.expand_panel(Z, piv)[2]
    torch.testing.assert_close(E_t, E, rtol=0, atol=0)
    torch.testing.assert_close(used_t, used_f, rtol=0, atol=0)
    ref = (TE - E).numpy()
    np.testing.assert_allclose(Z.numpy(), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def _far_pivot_system(n, B):
    """Systems whose column j has its one large entry in row n - 1 - j:
    every pivot lies in the rows of the mirrored panel."""
    A, b = _systems(n, 1, B, seed=7)
    A = 0.1 * A + 3.0 * np.sqrt(n) * np.eye(n)[::-1, :, None]
    return A.astype(np.float32), b


@pytest.mark.parametrize("n,R,B,panel,pivot", [
    (40, 2, 3, 16, None), (100, 1, 5, 32, None), (182, 3, 4, 32, None),
    (48, 1, 2, 16, "roll"), (192, 2, 3, 32, None), (200, 1, 3, 32, None),
    (64, 2, 3, 16, "mirror")],
    ids=["panel_40", "panel_100", "panel_182", "panel_pivot_48",
         "panel_192_whole", "panel_200_ragged", "panel_pivot_mirror_64"])
def test_panel_solve_matches_jax(n, R, B, panel, pivot):
    """The blocked panel solve against the JAX package's (its panel kernel
    run by Pallas on the CPU) and against float64 LU, both to F32_TOL of
    the solution's scale: pad handling (n not a panel multiple, or a whole
    number of panels), several right-hand sides, ragged batches, and
    zero-diagonal systems whose pivots come from other panels' rows (the
    previous row, or the mirrored panel's)."""
    if pivot == "roll":
        A, b = _pivot_system(n, B)
    elif pivot == "mirror":
        A, b = _far_pivot_system(n, B)
    else:
        A, b = _systems(n, R, B, seed=n)
    x_j = np.asarray(jbs.panel_gj_solve_lanes(jnp.asarray(A), jnp.asarray(b),
                                              panel=panel, interpret=True))
    x_t = tbs.panel_gj_solve_lanes(torch.tensor(A), torch.tensor(b),
                                   panel=panel)
    assert x_t.shape == (n, b.shape[1], B) and x_t.dtype == torch.float32
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(x_t.numpy(), _np_solve(A, b), rtol=0,
                               atol=F32_TOL * scale)


def test_panel_wrapper_rejects_bad_operands():
    panel, used = torch.zeros((64, 32, 3)), torch.zeros((64, 3))
    with pytest.raises(TypeError):
        tbs.gj_panel_lanes(panel.double(), used.double())
    with pytest.raises(ValueError, match="expected"):
        tbs.gj_panel_lanes(panel, used[:, :2])
    with pytest.raises(ValueError, match="4130"):
        tbs.panel_gj_solve_lanes(torch.zeros(1).expand(4130, 4130, 1),
                                 torch.zeros((4130, 1, 1)))
    # the full width up to 1024 padded rows; a narrower request takes the
    # widest kernel width within it, and counts its own padding
    assert tbs.panel_width_for(182) == 32 and tbs.panel_width_for(1024) == 32
    assert tbs.panel_width_for(182, 16) == 16
    assert tbs.panel_width_for(1021, 24) == 16
    assert tbs.panel_width_for(1030) == 16


@pytest.mark.parametrize("n,width", [(1024, 32), (1056, 16), (2048, 16),
                                     (2080, 8), (4096, 8), (4128, 0)])
def test_panel_width_narrows(monkeypatch, n, width):
    """Past 1024 padded rows the blocked solve narrows its panel, as the
    reference narrows its own: a thread of the kernel keeps 32 slots, one
    row of 32, two of 16 or four of 8, so width 16 takes 2048 rows and
    width 8 4096; past those, a float32 solve takes LU (the reference's
    route past its kernel's budget).  The route is checked with the
    solves stubbed: only the dispatch runs at these dims."""
    assert tbs.panel_width_for(n) == width
    if width:
        Np = -(-n // width) * width
        assert Np <= dict(tbs.PANEL_LIMITS)[width]
        assert width == 32 or Np > dict(tbs.PANEL_LIMITS)[2 * width]
    taken = []
    monkeypatch.setattr(tbs, "_lu_solve_lanes",
                        lambda A, b: taken.append("lu") or b)
    monkeypatch.setattr(tbs, "panel_gj_solve_lanes",
                        lambda A, b: taken.append("panel") or b)
    A = torch.ones(1).expand(n, n, 1)
    tbs.batched_solve_lanes(A, torch.ones((n, 1, 1)))
    assert taken == (["panel"] if width else ["lu"])


@pytest.mark.parametrize("n", [1100, 1960, 3072])
def test_f32_solve_past_1024_rows(n):
    """Float32 solves past the full width's 1024 padded rows (1100 and
    1960 at width 16; 3072, the 128-bus feeder's seed, at width 8) solve
    as the reference does: against the JAX dispatcher on the CPU
    (equilibrated LU) and float64 LU, to F32_TOL of the solution's scale.
    2-10 s each on one CPU thread."""
    A, b = _systems(n, 1, 2, seed=11)
    x = tbs.batched_solve_lanes(torch.tensor(A), torch.tensor(b))
    assert x.shape == (n, 1, 2) and x.dtype == torch.float32
    x_j = np.asarray(jbs.batched_solve_lanes(jnp.asarray(A), jnp.asarray(b)))
    ref = _np_solve(A, b)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x.numpy(), x_j, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("n,Np", [(182, 192), (364, 384), (700, 704),
                                  (780, 800), (1000, 1024)])
def test_panel_width_register_rule(n, Np):
    """The capacitance dims of net1 at H<=25/51/99, the 128-bus feeder's and
    the largest the kernel takes all run at the full width: the kernel's
    bound of 1024 threads holds a thread to 64 registers, so a block of up
    to 1024 padded rows always fits an SM's 65,536 and the register budget
    never narrows the panel."""
    w = tbs.panel_width_for(n)
    assert w == tbs.PANEL_WIDTH == 32
    assert -(-n // w) * w == Np <= tbs.MAX_PANEL_DIM


def test_panel_solve_launches_nothing_on_cpu():
    """On CPU tensors the blocked solve runs the plain twin: no launch is
    counted, by kernel or by shape."""
    for k in tbs.LAUNCHES:
        tbs.LAUNCHES[k] = 0
    tbs.LAUNCHES_BY_SHAPE.clear()
    A, b = _systems(182, 1, 3, seed=18)
    x = tbs.batched_solve_lanes(torch.tensor(A), torch.tensor(b),
                                impl="panel")
    assert x.shape == (182, 1, 3)
    assert not any(tbs.LAUNCHES.values()) and not tbs.LAUNCHES_BY_SHAPE


def test_panel_solve_empty_batch():
    """A batch of no systems gives an empty solution of the right shape."""
    x = tbs.panel_gj_solve_lanes(torch.zeros((182, 182, 0)),
                                 torch.zeros((182, 2, 0)))
    assert x.shape == (182, 2, 0) and x.dtype == torch.float32


def test_count_launch_by_shape():
    """Each launch counts once in LAUNCHES and once under its shape."""
    before = dict(tbs.LAUNCHES)
    tbs.LAUNCHES_BY_SHAPE.clear()
    try:
        tbs._count_launch("gj_panel_kernel", (192, 32, 2048))
        tbs._count_launch("gj_panel_kernel", (192, 32, 2048))
        tbs._count_launch("gj_kernel", torch.Size([26, 1, 16384]))
        assert tbs.LAUNCHES_BY_SHAPE == {
            ("gj_panel_kernel", (192, 32, 2048)): 2,
            ("gj_kernel", (26, 1, 16384)): 1}
        assert tbs.LAUNCHES["gj_panel_kernel"] == \
            before["gj_panel_kernel"] + 2
    finally:
        tbs.LAUNCHES.update(before)
        tbs.LAUNCHES_BY_SHAPE.clear()


def test_direct_dims_up_to_192():
    """impl 'auto'/'direct' keeps dims 129..192 on the direct elimination,
    as the JAX dispatcher does."""
    A, b = _systems(136, 1, 2, seed=3)
    x = tbs.batched_solve_lanes(torch.tensor(A), torch.tensor(b),
                                impl="direct")
    ref = _np_solve(A, b)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def test_panel_limit_covers_the_reference():
    """Every dim the reference's panel kernel takes (its VMEM bound:
    widths 32/24/16/8 up to n = 768/1056/1584/3184, LU from 3185 on), the
    port's blocked solve takes too (widths 32/16/8 up to 1024/2048/4096
    padded rows)."""
    ref_max = 0
    for n in range(8, 4097):
        if jbs.panel_gj_width_for(n) > 0:
            ref_max = n
            assert tbs.panel_width_for(n) > 0, n
    assert ref_max == 3184
    assert [max(n for n in range(8, 4097) if jbs.panel_gj_width_for(n) >= w)
            for w in (32, 24, 16, 8)] == [768, 1056, 1584, 3184]
