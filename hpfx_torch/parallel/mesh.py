"""Scenario and harmonic sharding over ``torch.distributed`` (the port of
``hpfx.parallel.mesh``).

The HPF scenario sweep is embarrassingly parallel: each scenario rank
solves a contiguous shard of the scenario batch, and the results are
all-gathered, so that every rank holds the whole result, as a global JAX
array would be.  The network and the devices are replicated: every rank
passes the same ones, and the same scenarios (SPMD).

The harmonic axis (:func:`harmonic_mesh`, :func:`hpf_mesh`) splits one
scenario piece's Newton trip over the consecutive ranks of a harmonic
group.  JAX gets it from one GSPMD constraint, ``P(harmonic, None,
scenario)`` on the (H, n, B) voltage carry; here the collectives are
written into the trip (:func:`hpfx_torch.lanes.arrow_step_lanes`,
:func:`hpfx_torch.arrow.arrow_solve`).  Every rank of a group keeps the
whole (H, n, b) state of its piece.  The work that is per harmonic (the
Y·V rows and Norton injections of the mismatch, the harmonic blocks and
their solves, the back-substitution) is split by harmonic and
all-gathered; the work that couples every harmonic (the Woodbury
capacitance system, the exact-linear seed's solve) is split by lane and
all-gathered.  Every sum is taken whole on one rank, in the unsharded
order, and every rank of a group computes its loop decisions from the
same gathered values, so the group stays in step and float64 equals the
unsharded port bit for bit.  JAX's ``vsharding=NamedSharding(mesh,
P(harmonic, None, scenario))`` is the port's ``mesh=hpf_mesh(...)``.

Three steps of the JAX programs are global across scenario ranks, and
stay global here: the hosting-capacity aggregate (an all-reduce of
counts), the adaptive sweep's straggler gather, and the continuation's
key sort, chunk seeds and rescue (each rank makes the same choice from
gathered masks and states; see :func:`hpfx_torch.lanes.
hpf_sweep_adaptive_lanes` and :func:`hpfx_torch.lanes.
hpf_sweep_continuation_lanes`).  The Newton loops freeze each converged
lane on its own, so a lane's result does not depend on which lanes share
its batch.

The caller starts the process group: ``torchrun`` (NCCL, one card a rank)
or ``torch.distributed.init_process_group`` with gloo (the CPU, or
several ranks on one card).  With no process group, every mesh is this
process alone and the sharded functions are the unsharded ones.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional


import torch
import torch.distributed as dist

from ..utils.profiling import PhaseLog, spanned

if TYPE_CHECKING:       # the solvers import this module: no cycle at run time
    from ..config import Settings
    from ..harmonic import HPFResult
    from ..network import Network
    from ..solve import Scenarios, SweepSummary

SCENARIO_AXIS = "scenario"
HARMONIC_AXIS = "harmonic"


def _piece(n: int, k: int, i: int):
    """Piece ``i`` of ``n`` items split over ``k`` as ``numpy.array_split``
    splits them: ``[lo, hi)``."""
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


@spanned("gather")
def _gather(x: torch.Tensor, n: int, dim: int, group, ranks: tuple,
            rank: int) -> torch.Tensor:
    """The pieces of ``n`` items along ``dim`` of the ranks ``ranks`` of
    ``group`` (this rank's is ``x``; the sizes of ``numpy.array_split``),
    concatenated in rank order: one ``all_gather`` of the pieces padded to
    the largest, under every backend.  Booleans travel as bytes.  One
    ``hpfx.gather`` span under a profiler."""
    dim = dim % x.ndim
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    k = len(ranks)
    sizes = [_piece(n, k, i)[1] - _piece(n, k, i)[0] for i in range(k)]
    pad = list(wire.shape)
    pad[dim] = max(sizes) - wire.shape[dim]
    wire = torch.cat([wire, wire.new_zeros(pad)], dim=dim).contiguous()
    parts = [torch.empty_like(wire) for _ in range(k)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                    dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A scenario x harmonic mesh over processes; global rank r sits at
    (r // n_harmonic, r % n_harmonic), as JAX reshapes the devices.

    ``ranks`` (global ranks, in order) is this rank's scenario group, the
    ranks that split the scenarios, and ``group`` their process group
    (None: this process alone); ``hranks`` and ``hgroup`` its harmonic
    group, consecutive ranks that split one scenario piece's Newton trip
    (None: one rank on the harmonic axis, whose trip is unsharded).
    ``rank`` and ``world`` are this process's global rank and the number
    of processes that receive the results, ``device`` this rank's
    device.  A rank outside the mesh takes no scenarios (``index`` is
    None)."""
    ranks: tuple
    group: object
    rank: int
    world: int
    device: torch.device
    hranks: Optional[tuple] = None
    hgroup: object = None

    @property
    def size(self) -> int:
        """The number of scenario ranks."""
        return len(self.ranks)

    @property
    def index(self) -> Optional[int]:
        """This process's position among the scenario ranks (None: it
        takes no scenarios)."""
        return self.ranks.index(self.rank) if self.rank in self.ranks \
            else None

    @property
    def hsize(self) -> int:
        """The number of harmonic ranks in a group."""
        return 1 if self.hranks is None else len(self.hranks)

    def bounds(self, n: int):
        """This rank's contiguous piece ``[lo, hi)`` of ``n`` lanes (the
        sizes of ``numpy.array_split``; empty outside the mesh)."""
        if self.index is None:
            return 0, 0
        return _piece(n, self.size, self.index)

    def all_gather(self, x: torch.Tensor, n: int,
                   dim: int = 0) -> torch.Tensor:
        """Every scenario rank's piece of ``n`` lanes along ``dim`` (this
        rank's is ``x``), concatenated in rank order: the whole ``n``
        lanes on every scenario rank.  With a process group the collective
        runs whatever its size (a 1-rank group too); without one, ``x`` is
        the whole."""
        if self.group is None:
            return x
        return _gather(x, n, dim, self.group, self.ranks, self.rank)

    def hbounds(self, n: int):
        """This rank's piece ``[lo, hi)`` of ``n`` harmonics (or lanes) split
        over its harmonic group as ``numpy.array_split`` splits them: 13
        over 2 ranks is 7 and 6, 3 over 4 is 1, 1, 1 and 0; all ``n``
        with no harmonic group."""
        if self.hranks is None:
            return 0, n
        return _piece(n, self.hsize, self.hranks.index(self.rank))

    def hgather(self, x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """Every harmonic rank's piece of ``n`` along ``dim`` (the split of
        :meth:`hbounds`; this rank's is ``x``), concatenated: the whole on
        every rank of the group.  A rank with an empty piece takes part
        all the same."""
        if self.hgroup is None:
            return x
        return _gather(x, n, dim, self.hgroup, self.hranks, self.rank)


#: this process alone: one rank on both axes and no process group, on
#: whatever device its tensors lie (the solvers' default mesh: every
#: bound is the whole, every gather the identity)
ALONE = Mesh((0,), None, 0, 1, None)


def _rank_device(rank: int, devices) -> torch.device:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh puts each rank on a CUDA card by default and no card "
                "is available: pass devices='cpu' to run on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def _rank_layout(n_scenario: int, n_harmonic: int):
    """The scenario groups (the columns of the ranks reshaped to
    (n_scenario, n_harmonic): strided ranks) and the harmonic groups (its
    rows: consecutive ranks) of a mesh, each a tuple of global ranks."""
    grid = [[i * n_harmonic + j for j in range(n_harmonic)]
            for i in range(n_scenario)]
    return ([tuple(row[j] for row in grid) for j in range(n_harmonic)],
            [tuple(row) for row in grid])


def _world() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def _make_mesh(n_scenario: int, n_harmonic: int, devices) -> Mesh:
    """The ``n_scenario`` x ``n_harmonic`` mesh of the first ranks of the
    process group.  Every rank creates every group, in one order (scenario
    groups, then harmonic groups), as ``torch.distributed.new_group``
    requires; a group of every rank is the world's."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_scenario * n_harmonic != 1:
            raise ValueError(f"a {n_scenario} x {n_harmonic} mesh needs a "
                             "process group of as many ranks")
        return Mesh((0,), None, 0, 1, _rank_device(0, devices))
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_scenario * n_harmonic > world:
        raise ValueError(f"a {n_scenario} x {n_harmonic} mesh needs "
                         f"{n_scenario * n_harmonic} ranks, not {world}")

    def groups(rank_sets):
        mine = rank_sets[0], None
        for rs in rank_sets:
            g = dist.group.WORLD if len(rs) == world else \
                dist.new_group(ranks=list(rs))
            if rank in rs:
                mine = rs, g
        return mine

    scenario_sets, harmonic_sets = _rank_layout(n_scenario, n_harmonic)
    ranks, group = groups(scenario_sets)
    hranks = hgroup = None
    if n_harmonic > 1:
        hranks, hgroup = groups(harmonic_sets)
    device = _rank_device(rank, devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(ranks, group, rank, world, device, hranks, hgroup)


def scenario_mesh(n_devices: Optional[int] = None,
                  devices=None) -> Mesh:
    """1-D mesh over the ranks of the initialized process group (this
    process alone when there is none), scenario axis only.

    ``n_devices``: the first n ranks take the scenarios (a ``new_group``,
    so every rank must call this); the others still receive the results.
    ``devices``: this rank's device (a name or ``torch.device``) or one per
    rank; default ``cuda:(rank % device_count)``, made the current CUDA
    device."""
    n = _world() if n_devices is None else max(1, min(n_devices, _world()))
    return _make_mesh(n, 1, devices)


def harmonic_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with the *harmonic* axis sharded: the first ``n_devices``
    ranks (default: all) are one harmonic group, which splits one
    problem's Newton trip; ``devices`` as in :func:`scenario_mesh`."""
    n = _world() if n_devices is None else max(1, min(n_devices, _world()))
    return _make_mesh(1, n, devices)


def hpf_mesh(n_scenario: int, n_harmonic: int, devices=None) -> Mesh:
    """2-D scenario x harmonic mesh (the DP x TP analogue) over the first
    ``n_scenario·n_harmonic`` ranks: independent scenarios ride the
    scenario axis (strided ranks), and each scenario piece's Newton trip
    is split over a harmonic group (consecutive ranks), whose collectives
    never leave it.  ``devices`` as in :func:`scenario_mesh`."""
    return _make_mesh(n_scenario, n_harmonic, devices)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 \
        and isinstance(x[1], torch.dtype)


def _tree_map(fn, tree, leaf=lambda x: isinstance(x, torch.Tensor)):
    """``fn`` over the leaves of nested NamedTuples (None kept)."""
    if tree is None:
        return None
    if leaf(tree):
        return fn(tree)
    return type(tree)(*(_tree_map(fn, t, leaf) for t in tree))


def _share(mesh: Mesh, tree):
    """The result of the mesh's ranks on every rank: broadcast from rank 0
    to the ranks outside the mesh (a no-op when every rank is in it)."""
    if mesh.world == mesh.size * mesh.hsize:
        return tree
    member = mesh.index is not None
    spec = [_tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
            if member else None]
    dist.broadcast_object_list(spec, src=0)

    def bcast(t):
        if not member:
            t = torch.empty(t[0], dtype=t[1], device=mesh.device)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        dist.broadcast(wire, src=0)
        return wire.to(torch.bool) if t.dtype == torch.bool else wire

    if member:
        return _tree_map(bcast, tree)
    return _tree_map(bcast, spec[0], leaf=_is_spec)


def _pad_scenarios(scenarios: Scenarios, mesh: Mesh):
    """Pad the batch up to a multiple of the scenario ranks by repeating
    the last scenario (every field, (B, n_nl) scales and (B, n_nl, T)
    mixes included); the callers discard the padding from the results
    and aggregates.  Returns (padded_scenarios, original_batch)."""
    B = scenarios.batch
    Bp = -(-B // mesh.size) * mesh.size
    if Bp == B:
        return scenarios, B

    def pad(x):
        if x is None:
            return None
        return torch.cat([x, x[-1:].expand((Bp - B,) + x.shape[1:])])

    return type(scenarios)(*(pad(x) for x in scenarios)), B


def shard_scenarios(scenarios: Scenarios, mesh: Mesh) -> Scenarios:
    """This rank's contiguous shard of a (padded) batch, on the mesh's
    device; empty on a rank outside the mesh."""
    lo, hi = mesh.bounds(scenarios.batch)
    return type(scenarios)(*(None if x is None else
                             x[lo:hi].to(mesh.device) for x in scenarios))


def _replicate(obj, mesh: Mesh):
    return obj.to(device=mesh.device)


def _gather_result(mesh: Mesh, res, Bp: int, B: int):
    """Every rank's batch-major shard of a result, gathered, shared with
    the ranks outside the mesh and sliced back to the caller's batch."""
    if mesh.index is not None:
        res = _tree_map(lambda x: mesh.all_gather(x, Bp)[:B], res)
    return _share(mesh, res)


def hpf_sweep_sharded(net: Network, devices, settings: Settings,
                      scenarios: Scenarios,
                      mesh: Mesh) -> HPFResult:
    """Batched HPF with the scenario axis sharded over ``mesh``: each rank
    runs :func:`hpfx_torch.solve.hpf_sweep` on its shard; every rank gets
    the whole batch-major result.  Batches that do not divide the mesh
    are padded by repeating the last scenario; the padding is sliced off
    the result."""
    from ..solve import hpf_sweep

    scenarios, B = _pad_scenarios(scenarios, mesh)
    res = None
    if mesh.index is not None:
        res = hpf_sweep(_replicate(net, mesh), _replicate(devices, mesh),
                        settings, shard_scenarios(scenarios, mesh))
    return _gather_result(mesh, res, scenarios.batch, B)


def hpf_single_hsharded(net: Network, devices, settings: Settings,
                        mesh: Mesh) -> HPFResult:
    """Single HPF solve with the **harmonic axis** sharded over ``mesh``
    (a :func:`harmonic_mesh`, or the harmonic axis of an :func:`hpf_mesh`,
    each of whose harmonic groups solves the same case): the admittances
    and the fundamental whole on every rank, then the harmonic Newton loop
    of :func:`hpfx_torch.harmonic.solve_harmonic` with its step split over
    the group.  ``"arrow"``: each rank builds and solves the blocks of its
    harmonics, G and V^T·z are all-gathered and the capacitance system is
    solved whole on every rank; ``"dense"``: each rank builds the Jacobian
    rows of its harmonics, the rows are all-gathered and the dense system
    is solved whole on every rank.  Every rank gets the result."""
    from ..fundamental import solve_fundamental
    from ..harmonic import solve_harmonic
    from ..ybus import build_ybus, line_ybus_pair

    res = None
    if mesh.index is not None:
        net, devices = _replicate(net, mesh), _replicate(devices, mesh)
        Y = build_ybus(net, settings)
        lineY, lineY_f = line_ybus_pair(net, settings)
        fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
        res = solve_harmonic(Y, fund, net, devices, settings, lineY=lineY,
                             mesh=mesh)
    return _share(mesh, res)


def hpf_sweep_sharded2d(net: Network, devices, settings: Settings,
                        scenarios: Scenarios, mesh: Mesh,
                        log: Optional[PhaseLog] = None) -> HPFResult:
    """Batched HPF sweep on a 2-D scenario x harmonic mesh (DP x TP):
    :func:`hpfx_torch.lanes.hpf_sweep_lanes` with the batch split over the
    scenario axis and each piece's Newton trip over its harmonic group.
    Build ``mesh`` with :func:`hpf_mesh`.  Requires the lanes-supported
    configuration (``Settings.solver="arrow"``); the batch is padded to
    the scenario axis, and every rank gets the whole batch-major
    result.  ``log``: optional :class:`hpfx_torch.utils.profiling.PhaseLog` of this
    rank's trips and reads."""
    from ..lanes import hpf_sweep_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_sharded2d needs the lanes-supported "
                         "configuration (arrow solver, stacked DeviceSet)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    res = None
    if mesh.index is not None:
        res = hpf_sweep_lanes(_replicate(net, mesh),
                              _replicate(devices, mesh), settings,
                              scenarios.to(mesh.device), log=log,
                              mesh=mesh)
    return _gather_result(mesh, res, scenarios.batch, B)


def hpf_sweep_continuation_sharded(net: Network, devices,
                                   settings: Settings,
                                   scenarios: Scenarios, mesh: Mesh,
                                   n_stages: int = 8,
                                   rescue: bool = True) -> HPFResult:
    """The device continuation sweep
    (:func:`hpfx_torch.lanes.hpf_sweep_continuation_lanes`) with each
    chunk's Newton trip and the rescue sharded over ``mesh``, a scenario
    mesh or, on an :func:`hpf_mesh`, over both axes; the key sort, the
    chunk seeds and the rescue's choice stay global (every rank computes
    them from gathered states)."""
    from ..lanes import hpf_sweep_continuation_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_continuation_sharded needs the "
                         "lanes-supported configuration (arrow solver)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    res = None
    if mesh.index is not None:
        res = hpf_sweep_continuation_lanes(
            _replicate(net, mesh), _replicate(devices, mesh), settings,
            scenarios.to(mesh.device), n_stages=n_stages, rescue=rescue,
            mesh=mesh)
        res = _tree_map(lambda x: x[:B], res)
    return _share(mesh, res)


@spanned("sweep")
def hpf_sweep_adaptive_sharded(net: Network, devices,
                               settings: Settings,
                               scenarios: Scenarios, mesh: Mesh,
                               phase_iters: int = 24,
                               rescue_width=None,
                               warm: str = "cold",
                               log: Optional[PhaseLog] = None) -> HPFResult:
    """The adaptive sweep (:func:`hpfx_torch.lanes.
    hpf_sweep_adaptive_lanes`: phase-capped trip, gathered straggler
    rescue, cold restart) with every Newton trip sharded over ``mesh``, a
    scenario mesh or, on an :func:`hpf_mesh`, over both axes (within a
    harmonic group every rank holds the same lanes).
    The straggler gather is global: the ``K`` lanes are chosen from the
    convergence masks of the whole padded batch, gathered from every
    rank (and a tuple ``rescue_width``'s bucket from their global count),
    as the JAX program's ``argsort`` over the sharded batch chooses
    them.  ``log``: optional :class:`hpfx_torch.utils.profiling.PhaseLog` of this
    rank's phases."""
    from ..lanes import hpf_sweep_adaptive_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_adaptive_sharded needs the "
                         "lanes-supported configuration (arrow solver)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    res = None
    if mesh.index is not None:
        res = hpf_sweep_adaptive_lanes(
            _replicate(net, mesh), _replicate(devices, mesh), settings,
            scenarios.to(mesh.device), phase_iters=phase_iters,
            rescue_width=rescue_width, warm=warm, log=log,
            mesh=mesh)
    return _gather_result(mesh, res, scenarios.batch, B)


def hosting_capacity_sharded(net: Network, devices, settings: Settings,
                             scenarios: Scenarios, mesh: Mesh,
                             thd_limit: float = 0.08) -> SweepSummary:
    """Sharded Monte-Carlo hosting-capacity sweep: the per-scenario
    outputs are gathered, and the over-limit fraction is an all-reduce of
    each rank's count over its valid (unpadded) scenarios, divided by the
    caller's batch, as the unsharded sweep's ``valid_count`` masks it."""
    from ..solve import SweepSummary, hosting_capacity_sweep

    scenarios, B = _pad_scenarios(scenarios, mesh)
    Bp = scenarios.batch
    out = None
    if mesh.index is not None:
        lo, hi = mesh.bounds(Bp)
        loc = hosting_capacity_sweep(
            _replicate(net, mesh), _replicate(devices, mesh), settings,
            shard_scenarios(scenarios, mesh), thd_limit=thd_limit)
        over = (loc.max_thd_f > thd_limit) & loc.converged
        count = over.to(loc.max_thd_f.dtype)[:max(0, min(hi, B) - lo)].sum()
        if mesh.group is not None:
            dist.all_reduce(count, group=mesh.group)
        out = SweepSummary(*(mesh.all_gather(x, Bp)[:B] for x in loc[:3]),
                           count / B)
    return _share(mesh, out)
