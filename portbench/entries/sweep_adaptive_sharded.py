"""``hpfx_torch.parallel.hpf_sweep_adaptive_sharded`` on a scenario mesh of
every rank: each rank solves its contiguous piece of the whole batch with
the adaptive lane-major sweep, the straggler choice gathered from every
rank, and the results are all-gathered.  No host rescue.  Arguments:
``phase_iters``, ``warm``."""
import hpfx_torch.parallel as par

SUPPORTS_LOG = False
FLOAT64_RESCUE = False


def make(net, dev, settings, args, world):
    mesh = par.scenario_mesh(world, devices=net.device)

    def call(scenarios, log=None):
        return par.hpf_sweep_adaptive_sharded(
            net, dev, settings, scenarios, mesh,
            phase_iters=args["phase_iters"], warm=args["warm"])
    return call
