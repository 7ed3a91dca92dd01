from .mesh import (SCENARIO_AXIS, ScenarioMesh, hosting_capacity_sharded,
                   hpf_sweep_adaptive_sharded,
                   hpf_sweep_continuation_sharded, hpf_sweep_sharded,
                   scenario_mesh, shard_scenarios)

__all__ = ["SCENARIO_AXIS", "ScenarioMesh", "scenario_mesh",
           "shard_scenarios", "hpf_sweep_sharded",
           "hpf_sweep_continuation_sharded", "hpf_sweep_adaptive_sharded",
           "hosting_capacity_sharded"]
