"""hpfx_torch — harmonic power flow in PyTorch, for NVIDIA Hopper.

The PyTorch/CUDA port of the JAX package ``hpfx``, which stays the
reference.  Module names follow ``hpfx``; this package never imports JAX
or ``hpfx``, and reads the shared data files under ``hpfx/data/`` by
path.  The loaders (``load_network``, ``network_from_arrays``,
``synthetic_feeder``, ``from_hpfx_arrays``) put their tensors on the CUDA
card unless given ``device=``, and raise when there is no card: pass
``device="cpu"`` to run on the CPU.  Everything downstream follows the
device of its input tensors.

Importing the package pins float32 matmuls to full precision (TF32 off):
a TF32 contraction keeps ~3 decimal digits and stalls Newton-Raphson at a
residual floor above the harmonic threshold.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from . import cx  # noqa: E402
from .config import Settings, default_harmonics, settings_for_hmax  # noqa: E402
from .convert import from_hpfx_arrays  # noqa: E402
from .cx import Cx  # noqa: E402
from .devices import DATA_DIR, DeviceSet, load_device_set  # noqa: E402
from .fundamental import FundResult, pf, solve_fundamental  # noqa: E402
from .generators import synthetic_feeder  # noqa: E402
from .harmonic import (HPFResult, cleanup_voltages, hpf,  # noqa: E402
                       solve_harmonic)
from .lanes import PhaseLog, hpf_sweep_adaptive_lanes  # noqa: E402
from .network import (Network, load_network, network_from_arrays,  # noqa: E402
                      validate_network)
from .ops.batched_solve import (LAUNCHES, LAUNCHES_BY_SHAPE,  # noqa: E402
                                batched_solve, batched_solve_lanes,
                                expand_panel, gauss_solve_lanes,
                                gj_panel_lanes, gj_panel_ref,
                                gj_solve_lanes_ref, nr_solve,
                                panel_gj_solve_lanes, solve_blocks)
from .results import (HPFReport, WaveformMetrics, get_thd,  # noqa: E402
                      report, voltage_phasors, waveform, waveform_metrics)
from .solve import (Scenarios, hpf_single, hpf_sweep,  # noqa: E402
                    hpf_sweep_adaptive, hpf_sweep_device)
from .ybus import build_ybus  # noqa: E402

__all__ = [
    "Cx", "DATA_DIR", "DeviceSet", "FundResult", "HPFReport", "HPFResult",
    "LAUNCHES", "LAUNCHES_BY_SHAPE", "Network", "PhaseLog", "Scenarios",
    "Settings", "WaveformMetrics", "batched_solve", "batched_solve_lanes",
    "build_ybus", "cleanup_voltages", "cx", "default_harmonics",
    "expand_panel", "from_hpfx_arrays", "gauss_solve_lanes", "get_thd",
    "gj_panel_lanes", "gj_panel_ref", "gj_solve_lanes_ref", "hpf",
    "hpf_single", "hpf_sweep", "hpf_sweep_adaptive",
    "hpf_sweep_adaptive_lanes", "hpf_sweep_device", "load_device_set",
    "load_network", "network_from_arrays", "nr_solve",
    "panel_gj_solve_lanes", "pf", "report", "settings_for_hmax",
    "solve_blocks", "solve_fundamental", "solve_harmonic",
    "synthetic_feeder", "validate_network", "voltage_phasors", "waveform",
    "waveform_metrics",
]
