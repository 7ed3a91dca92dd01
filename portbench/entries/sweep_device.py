"""``hpfx_torch.hpf_sweep_device``: the device-side adaptive sweep (seed,
capped trips, gathered rescue, cold restart) and, where lanes remain
unconverged, the host's float64 rescue.  Arguments: ``phase_iters``,
``warm``."""
import hpfx_torch as ht

SUPPORTS_LOG = True
#: the call ends in the host's float64 rescue where lanes remain
FLOAT64_RESCUE = True


def make(net, dev, settings, args, world):
    def call(scenarios, log=None):
        return ht.hpf_sweep_device(net, dev, settings, scenarios,
                                   phase_iters=args["phase_iters"],
                                   warm=args["warm"], log=log)
    return call

