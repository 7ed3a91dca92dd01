"""``hpfx_torch.hpf_sweep_adaptive``: the host-driven two-phase schedule
(phase 1 capped at ``phase_iters``, phase 2 on the bucketed stragglers
with the same settings) and the host's rescue, ending in float64.
Arguments: ``phase_iters``, ``warm``."""
import hpfx_torch as ht

SUPPORTS_LOG = True
#: the call ends in the host's float64 rescue where lanes remain
FLOAT64_RESCUE = True


def make(net, dev, settings, args, world):
    def call(scenarios, log=None):
        return ht.hpf_sweep_adaptive(net, dev, settings, scenarios,
                                     phase_iters=args["phase_iters"],
                                     phase2_settings=settings,
                                     warm=args["warm"], log=log)
    return call

