"""hpfx_torch — harmonic power flow in PyTorch, for NVIDIA Hopper.

The PyTorch/CUDA port of the JAX package ``hpfx``, which stays the
reference.  Module names follow ``hpfx``; this package never imports JAX
or ``hpfx``, and reads the shared data files under ``hpfx/data/`` by
path.  The loaders (``load_network``, ``network_from_arrays``,
``synthetic_feeder``, ``from_hpfx_arrays``, ``load_device_library``,
``library_from_hpfx_arrays``, ``Scenarios.uniform``) put their tensors on
the CUDA card unless given ``device=``, and raise when there is no card:
pass ``device="cpu"`` to run on the CPU.  Everything downstream follows the
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
from .background import (background_from_harmonics,  # noqa: E402
                         background_sweep, current_source, grid_source,
                         shunt_admittance)
from .convert import from_hpfx_arrays, library_from_hpfx_arrays  # noqa: E402
from .cx import Cx  # noqa: E402
from .devices import (DATA_DIR, AnalyticDeviceSet,  # noqa: E402
                      DeviceLibrary, DeviceSet, device_set_from_arrays,
                      load_device_library, load_device_set, norton_inject)
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
from .solve import (Scenarios, SweepSummary,  # noqa: E402
                    hosting_capacity_sweep, hpf_single, hpf_sweep,
                    hpf_sweep_adaptive, hpf_sweep_device, hpf_sweep_stream,
                    summarize_thd)
from .warmstart import harmonic_linear_seed, norton_warm_start  # noqa: E402
from .ybus import build_ybus  # noqa: E402

__all__ = [
    "AnalyticDeviceSet", "Cx", "DATA_DIR", "DeviceLibrary", "DeviceSet",
    "FundResult", "HPFReport", "HPFResult", "LAUNCHES", "LAUNCHES_BY_SHAPE",
    "Network", "PhaseLog", "Scenarios", "Settings", "SweepSummary",
    "WaveformMetrics", "background_from_harmonics", "background_sweep",
    "batched_solve", "batched_solve_lanes", "build_ybus",
    "cleanup_voltages", "current_source", "cx", "default_harmonics",
    "device_set_from_arrays", "expand_panel", "from_hpfx_arrays",
    "gauss_solve_lanes", "get_thd", "gj_panel_lanes", "gj_panel_ref",
    "gj_solve_lanes_ref", "grid_source", "harmonic_linear_seed",
    "hosting_capacity_sweep", "hpf", "hpf_single", "hpf_sweep",
    "hpf_sweep_adaptive", "hpf_sweep_adaptive_lanes", "hpf_sweep_device",
    "hpf_sweep_stream", "library_from_hpfx_arrays", "load_device_library",
    "load_device_set", "load_network", "network_from_arrays",
    "norton_inject", "norton_warm_start", "nr_solve",
    "panel_gj_solve_lanes", "pf", "report", "settings_for_hmax",
    "shunt_admittance", "solve_blocks", "solve_fundamental",
    "solve_harmonic", "summarize_thd", "synthetic_feeder",
    "validate_network", "voltage_phasors", "waveform", "waveform_metrics"
]
