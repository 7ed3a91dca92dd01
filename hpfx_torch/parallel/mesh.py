"""Scenario-axis sharding over ``torch.distributed`` (the scenario half of
``hpfx.parallel.mesh``).

The HPF scenario sweep is embarrassingly parallel: each rank (one process,
one card) solves a contiguous shard of the scenario batch with the port's
unsharded function, and the results are all-gathered, so that every rank
holds the whole result, as a global JAX array would be.  The network and
the devices are replicated: every rank passes the same ones, and the same
scenarios (SPMD).

Three steps of the JAX programs are global, and stay global here: the
hosting-capacity aggregate (an all-reduce of counts), the adaptive
sweep's straggler gather, and the continuation's key sort, chunk seeds and
rescue (each rank makes the same choice from gathered masks and states;
see :func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes` and
:func:`hpfx_torch.lanes.hpf_sweep_continuation_lanes`).  The Newton loops
freeze each converged lane on its own, so a lane's result does not depend
on which lanes share its batch.

The caller starts the process group: ``torchrun`` (NCCL, one card a rank)
or ``torch.distributed.init_process_group`` with gloo on the CPU.  With no
process group, :func:`scenario_mesh` is a mesh of this process alone and
the sharded functions are the unsharded ones.  The harmonic axis of the
JAX package (``harmonic_mesh``, ``hpf_mesh``, ``hpf_single_hsharded``,
``hpf_sweep_sharded2d``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import Settings
from ..harmonic import HPFResult
from ..network import Network
from ..solve import (Scenarios, SweepSummary, hosting_capacity_sweep,
                     hpf_sweep)

SCENARIO_AXIS = "scenario"


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """A 1-D mesh over processes: ``ranks`` (global ranks, in order) take
    the scenarios, ``group`` is their process group (None: this process
    alone), ``rank`` and ``world`` are this process's global rank and the
    number of processes that receive the results, ``device`` this rank's
    device."""
    ranks: tuple
    group: object
    rank: int
    world: int
    device: torch.device

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

    def bounds(self, n: int):
        """This rank's contiguous piece ``[lo, hi)`` of ``n`` lanes (the
        sizes of ``numpy.array_split``; empty outside the mesh)."""
        if self.index is None:
            return 0, 0
        q, r = divmod(n, self.size)
        lo = self.index * q + min(self.index, r)
        return lo, lo + q + (self.index < r)

    def all_gather(self, x: torch.Tensor, n: int,
                   dim: int = 0) -> torch.Tensor:
        """Every scenario rank's piece of ``n`` lanes along ``dim`` (this
        rank's is ``x``), concatenated in rank order: the whole ``n``
        lanes on every scenario rank.  The pieces are padded to the
        largest for the collective; booleans travel as bytes.  With a
        process group the collective runs whatever its size (a 1-rank
        group too); without one, ``x`` is the whole."""
        if self.group is None:
            return x
        dim = dim % x.ndim
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        pad = list(wire.shape)
        pad[dim] = -(-n // self.size) - wire.shape[dim]
        wire = torch.cat([wire, wire.new_zeros(pad)], dim=dim).contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        sizes = [n // self.size + (i < n % self.size)
                 for i in range(self.size)]
        out = torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                        dim=dim)
        return out.to(torch.bool) if x.dtype == torch.bool else out


def _rank_device(rank: int, devices) -> torch.device:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scenario_mesh puts each rank on a CUDA card by default and "
                "no card is available: pass devices='cpu' to run on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def scenario_mesh(n_devices: Optional[int] = None,
                  devices=None) -> ScenarioMesh:
    """1-D mesh over the ranks of the initialized process group (this
    process alone when there is none), scenario axis only.

    ``n_devices``: the first n ranks take the scenarios (a ``new_group``,
    so every rank must call this); the others still receive the results.
    ``devices``: this rank's device (a name or ``torch.device``) or one per
    rank; default ``cuda:(rank % device_count)``, made the current CUDA
    device."""
    if not (dist.is_available() and dist.is_initialized()):
        return ScenarioMesh((0,), None, 0, 1, _rank_device(0, devices))
    rank, world = dist.get_rank(), dist.get_world_size()
    n = world if n_devices is None else max(1, min(n_devices, world))
    group = dist.group.WORLD if n == world else \
        dist.new_group(ranks=list(range(n)))
    device = _rank_device(rank, devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ScenarioMesh(tuple(range(n)), group, rank, world, device)


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


def _share(mesh: ScenarioMesh, tree):
    """The result of the scenario ranks on every rank: broadcast from the
    first scenario rank to the ranks outside the mesh (a no-op when every
    rank holds scenarios)."""
    if mesh.world == mesh.size:
        return tree
    member = mesh.index is not None
    spec = [_tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
            if member else None]
    dist.broadcast_object_list(spec, src=mesh.ranks[0])

    def bcast(t):
        if not member:
            t = torch.empty(t[0], dtype=t[1], device=mesh.device)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        dist.broadcast(wire, src=mesh.ranks[0])
        return wire.to(torch.bool) if t.dtype == torch.bool else wire

    if member:
        return _tree_map(bcast, tree)
    return _tree_map(bcast, spec[0], leaf=_is_spec)


def _pad_scenarios(scenarios: Scenarios, mesh: ScenarioMesh):
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

    return Scenarios(*(pad(x) for x in scenarios)), B


def shard_scenarios(scenarios: Scenarios, mesh: ScenarioMesh) -> Scenarios:
    """This rank's contiguous shard of a (padded) batch, on the mesh's
    device; empty on a rank outside the mesh."""
    lo, hi = mesh.bounds(scenarios.batch)
    return Scenarios(*(None if x is None else x[lo:hi].to(mesh.device)
                       for x in scenarios))


def _replicate(obj, mesh: ScenarioMesh):
    return obj.to(device=mesh.device)


def _gather_result(mesh: ScenarioMesh, res, Bp: int, B: int):
    """Every rank's batch-major shard of a result, gathered, shared with
    the ranks outside the mesh and sliced back to the caller's batch."""
    if mesh.index is not None:
        res = _tree_map(lambda x: mesh.all_gather(x, Bp)[:B], res)
    return _share(mesh, res)


def hpf_sweep_sharded(net: Network, devices, settings: Settings,
                      scenarios: Scenarios,
                      mesh: ScenarioMesh) -> HPFResult:
    """Batched HPF with the scenario axis sharded over ``mesh``: each rank
    runs :func:`hpfx_torch.solve.hpf_sweep` on its shard; every rank gets
    the whole batch-major result.  Batches that do not divide the mesh
    are padded by repeating the last scenario; the padding is sliced off
    the result."""
    scenarios, B = _pad_scenarios(scenarios, mesh)
    res = None
    if mesh.index is not None:
        res = hpf_sweep(_replicate(net, mesh), _replicate(devices, mesh),
                        settings, shard_scenarios(scenarios, mesh))
    return _gather_result(mesh, res, scenarios.batch, B)


def hpf_sweep_continuation_sharded(net: Network, devices,
                                   settings: Settings,
                                   scenarios: Scenarios, mesh: ScenarioMesh,
                                   n_stages: int = 8,
                                   rescue: bool = True) -> HPFResult:
    """The device continuation sweep
    (:func:`hpfx_torch.lanes.hpf_sweep_continuation_lanes`) with each
    chunk's Newton trip and the rescue sharded over ``mesh``; the key
    sort, the chunk seeds and the rescue's choice stay global (every rank
    computes them from gathered states)."""
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


def hpf_sweep_adaptive_sharded(net: Network, devices,
                               settings: Settings,
                               scenarios: Scenarios, mesh: ScenarioMesh,
                               phase_iters: int = 24,
                               rescue_width=None,
                               warm: str = "cold") -> HPFResult:
    """The adaptive sweep (:func:`hpfx_torch.lanes.
    hpf_sweep_adaptive_lanes`: phase-capped trip, gathered straggler
    rescue, cold restart) with every Newton trip sharded over ``mesh``.
    The straggler gather is global: the ``K`` lanes are chosen from the
    convergence masks of the whole padded batch, gathered from every
    rank (and a tuple ``rescue_width``'s bucket from their global count),
    as the JAX program's ``argsort`` over the sharded batch chooses
    them."""
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
            rescue_width=rescue_width, warm=warm,
            mesh=mesh)
    return _gather_result(mesh, res, scenarios.batch, B)


def hosting_capacity_sharded(net: Network, devices, settings: Settings,
                             scenarios: Scenarios, mesh: ScenarioMesh,
                             thd_limit: float = 0.08) -> SweepSummary:
    """Sharded Monte-Carlo hosting-capacity sweep: the per-scenario
    outputs are gathered, and the over-limit fraction is an all-reduce of
    each rank's count over its valid (unpadded) scenarios, divided by the
    caller's batch, as the unsharded sweep's ``valid_count`` masks it."""
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
