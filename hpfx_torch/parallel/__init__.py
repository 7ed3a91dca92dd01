from .mesh import (HARMONIC_AXIS, SCENARIO_AXIS, Mesh, harmonic_mesh,
                   hosting_capacity_sharded, hpf_mesh, hpf_single_hsharded,
                   hpf_sweep_adaptive_sharded, hpf_sweep_continuation_sharded,
                   hpf_sweep_sharded, hpf_sweep_sharded2d, scenario_mesh,
                   shard_scenarios)

__all__ = ["SCENARIO_AXIS", "HARMONIC_AXIS", "Mesh", "scenario_mesh",
           "harmonic_mesh", "hpf_mesh", "shard_scenarios",
           "hpf_sweep_sharded", "hpf_sweep_sharded2d",
           "hpf_sweep_continuation_sharded", "hpf_sweep_adaptive_sharded",
           "hpf_single_hsharded", "hosting_capacity_sharded"]
