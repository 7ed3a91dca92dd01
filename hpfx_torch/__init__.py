"""hpfx_torch — harmonic power flow in PyTorch, for NVIDIA Hopper.

The PyTorch/CUDA port of the JAX package ``hpfx``, which stays the
reference.  Module names follow ``hpfx``; this package never imports JAX
or ``hpfx``, and reads the shared data files under ``hpfx/data/`` by
path.  The loaders (``load_network``, ``network_from_arrays``,
``synthetic_feeder``, ``from_hpfx_arrays``, ``load_device_library``,
``library_from_hpfx_arrays``, ``Scenarios.uniform``, ``load_result``) and
the study functions that make tensors from plain numbers
(``monte_carlo_scenarios``, ``profile_scenarios``, ``daily_profile``,
``device_outage_scenarios``, the filter admittances) put their tensors on
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
from .lanes import (hpf_sweep_adaptive_lanes,  # noqa: E402
                    hpf_sweep_continuation_lanes)
from .utils.profiling import PhaseLog  # noqa: E402
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
from .checkpoint import load_result, save_result, warm_start  # noqa: E402
from .flows import (IEEE519CurrentReport, IEEE519Report,  # noqa: E402
                    IEEE519Summary, LineFlows, PowerIndices, check_en50160,
                    check_ieee519, check_ieee519_current, en50160_screen,
                    ieee519_screen, k_factor, line_flows, line_power_indices,
                    power_indices)
from .iec import (aggregate_contributions,  # noqa: E402
                  apportion_planning_level, summation_alpha, summation_law)
from .capacity import (HostingCapacityResult,  # noqa: E402
                       compliance_fraction, find_hosting_capacity,
                       monte_carlo_scenarios, scale_scenarios)
from .studies import (PercentileComplianceReport,  # noqa: E402
                      PlanningLevelReport, QuantileAssessment,
                      assess_quantiles, check_planning_levels, daily_profile,
                      metric_quantiles, percentile_compliance,
                      profile_scenarios, run_timeseries, summarize_quantiles)
from .impedance import (ctype_filter_admittance,  # noqa: E402
                        distortion_contributions, driving_point_impedance,
                        frequency_scan, highpass_filter_admittance,
                        impedance_scan, install_shunt, install_shunts,
                        resonance_peaks, tuned_filter_admittance)
from .sensitivity import (FilterParams, LineParams,  # noqa: E402
                          ScenarioParams, Sensitivity, filter_sensitivity,
                          injection_sensitivity, line_sensitivity,
                          mix_sensitivity, scenario_sensitivity,
                          sweep_filter_sensitivity, sweep_sensitivity)
from .contingency import (ContingencyReport,  # noqa: E402
                          ContingencySweepReport, ResonanceShiftReport,
                          device_outage_scenarios, islanded_lines,
                          outage_impedance_shift, screen_device_outages,
                          screen_line_outages, screen_line_outages_sweep,
                          screen_shunt_outages)
from .trajlog import (read_ilog, read_vlog,  # noqa: E402
                      trajectory_injections, write_ilog, write_vlog)
from .solve import hpf_sweep_continuation  # noqa: E402
from .kron import (KronReduction, kron_reduce,  # noqa: E402
                   passive_buses, recover_voltages)
from .loadmodel import damped_structures, linear_load_admittance  # noqa: E402
from .lineskin import (line_resistance, skin_ratio,  # noqa: E402
                       skin_structures)
from .longline import (electrical_length, longline_factors,  # noqa: E402
                       longline_structures)
from .sequence import (SequenceSet, balanced_phases,  # noqa: E402
                       classify_orders, delta_blocked, delta_device_set,
                       hpf_sequence, neutral_current, phase_components,
                       sequence_components, sequence_structures,
                       triplen_mask, zero_sequence_network)
from .converters import (NotchReport, converter_device_set,  # noqa: E402
                         converter_warm_start, notch_analysis,
                         six_pulse_spectrum, synth_waveform, table_spectrum,
                         twelve_pulse_spectrum)
from .matpower import load_matpower, parse_matpower  # noqa: E402
from .opendss import (device_spectra_at_nominal,  # noqa: E402
                      export_opendss_case)
from .modes import (CriticalMode, ModalScan, critical_mode,  # noqa: E402
                    eigen_sensitivity, modal_peaks, modal_scan,
                    modal_spectrum)
from .threephase import (AllocationStudy, PhaseFlows,  # noqa: E402
                         ThreePhaseResult, abc_admittance, allocation_study,
                         line_phase_flows, phase_injections,
                         sequence_voltages, solve_unbalanced,
                         unbalance_factors)
from .extended import (ControlledDeviceSet, ExtendedResult,  # noqa: E402
                       hpf_extended, solve_harmonic_extended)
from .convert import controlled_from_hpfx_arrays  # noqa: E402
from .ybus import fold_ydiag  # noqa: E402
from .results import THD  # noqa: E402
from .arrow import (arrow_solve, build_arrow_pieces,  # noqa: E402
                    make_arrow_index)
from .devices import (fit_coupled_ne, fit_uncoupled_ne,  # noqa: E402
                      load_norton_equivalent, ne_injection, ne_selftest)
from .estimate import (BackgroundEstimate, EstimateResult,  # noqa: E402
                       estimate_background, estimate_injections)
from .activefilter import ActiveFilterSizing, size_active_filter  # noqa: E402
from .optimize import (FilterOptResult, OptimizeResult,  # noqa: E402
                       apply_line_params, optimize_filter,
                       optimize_line_params)
from .placement import (FilterPlan, PlacementReport,  # noqa: E402
                        dominant_orders, filter_ydiag, plan_filter_bank,
                        screen_filter_placement)
from .ne_pipeline import (MeasurementSet, NortonFit,  # noqa: E402
                          device_set_from_fit, export_ne_csv,
                          export_opendss_spectrum,
                          fit_norton_from_measurements,
                          load_measurements_mat)

__all__ = [
    "THD", "arrow_solve", "build_arrow_pieces", "make_arrow_index",
    "fit_coupled_ne", "fit_uncoupled_ne", "load_norton_equivalent",
    "ne_injection", "ne_selftest", "BackgroundEstimate", "EstimateResult",
    "estimate_background", "estimate_injections", "ActiveFilterSizing",
    "size_active_filter", "FilterOptResult", "OptimizeResult",
    "apply_line_params", "optimize_filter", "optimize_line_params",
    "FilterPlan", "PlacementReport", "dominant_orders", "filter_ydiag",
    "plan_filter_bank", "screen_filter_placement", "MeasurementSet",
    "NortonFit", "device_set_from_fit", "export_ne_csv",
    "export_opendss_spectrum", "fit_norton_from_measurements",
    "load_measurements_mat",
    "AllocationStudy", "ControlledDeviceSet", "CriticalMode",
    "ExtendedResult", "KronReduction", "ModalScan", "NotchReport",
    "PhaseFlows", "SequenceSet", "ThreePhaseResult", "abc_admittance",
    "allocation_study", "balanced_phases", "classify_orders",
    "controlled_from_hpfx_arrays", "converter_device_set",
    "converter_warm_start", "critical_mode", "damped_structures",
    "delta_blocked", "delta_device_set", "device_spectra_at_nominal",
    "eigen_sensitivity", "electrical_length", "export_opendss_case",
    "fold_ydiag", "hpf_extended", "hpf_sequence", "hpf_sweep_continuation",
    "kron_reduce", "line_phase_flows", "line_resistance",
    "linear_load_admittance", "load_matpower", "longline_factors",
    "longline_structures", "modal_peaks", "modal_scan", "modal_spectrum",
    "neutral_current", "notch_analysis", "parse_matpower", "passive_buses",
    "phase_components", "phase_injections", "recover_voltages",
    "sequence_components", "sequence_structures", "sequence_voltages",
    "six_pulse_spectrum", "skin_ratio", "skin_structures",
    "solve_harmonic_extended", "solve_unbalanced", "synth_waveform",
    "table_spectrum", "triplen_mask", "twelve_pulse_spectrum",
    "unbalance_factors", "zero_sequence_network",
    "AnalyticDeviceSet", "ContingencyReport", "ContingencySweepReport",
    "Cx", "DATA_DIR", "DeviceLibrary", "DeviceSet", "FilterParams",
    "FundResult", "HPFReport", "HPFResult", "HostingCapacityResult",
    "IEEE519CurrentReport", "IEEE519Report", "IEEE519Summary", "LAUNCHES",
    "LAUNCHES_BY_SHAPE", "LineFlows", "LineParams", "Network",
    "PercentileComplianceReport", "PhaseLog", "PlanningLevelReport",
    "PowerIndices", "QuantileAssessment", "ResonanceShiftReport",
    "ScenarioParams", "Scenarios", "Sensitivity", "Settings",
    "SweepSummary", "WaveformMetrics", "aggregate_contributions",
    "apportion_planning_level", "assess_quantiles",
    "background_from_harmonics", "background_sweep", "batched_solve",
    "batched_solve_lanes", "build_ybus", "check_en50160", "check_ieee519",
    "check_ieee519_current", "check_planning_levels", "cleanup_voltages",
    "compliance_fraction", "ctype_filter_admittance", "current_source",
    "cx", "daily_profile", "default_harmonics", "device_outage_scenarios",
    "device_set_from_arrays", "distortion_contributions",
    "driving_point_impedance", "en50160_screen", "expand_panel",
    "filter_sensitivity", "find_hosting_capacity", "frequency_scan",
    "from_hpfx_arrays", "gauss_solve_lanes", "get_thd", "gj_panel_lanes",
    "gj_panel_ref", "gj_solve_lanes_ref", "grid_source",
    "harmonic_linear_seed", "highpass_filter_admittance",
    "hosting_capacity_sweep", "hpf", "hpf_single", "hpf_sweep",
    "hpf_sweep_adaptive", "hpf_sweep_adaptive_lanes",
    "hpf_sweep_continuation_lanes", "hpf_sweep_device",
    "hpf_sweep_stream", "ieee519_screen", "impedance_scan",
    "injection_sensitivity", "install_shunt", "install_shunts",
    "islanded_lines", "k_factor", "library_from_hpfx_arrays",
    "line_flows", "line_power_indices", "line_sensitivity",
    "load_device_library", "load_device_set", "load_network",
    "load_result", "metric_quantiles", "mix_sensitivity",
    "monte_carlo_scenarios", "network_from_arrays", "norton_inject",
    "norton_warm_start", "nr_solve", "outage_impedance_shift",
    "panel_gj_solve_lanes", "percentile_compliance", "pf",
    "power_indices", "profile_scenarios", "read_ilog", "read_vlog",
    "report", "resonance_peaks", "run_timeseries", "save_result",
    "scale_scenarios", "scenario_sensitivity", "screen_device_outages",
    "screen_line_outages", "screen_line_outages_sweep",
    "screen_shunt_outages", "settings_for_hmax", "shunt_admittance",
    "solve_blocks", "solve_fundamental", "solve_harmonic",
    "summarize_quantiles", "summarize_thd", "summation_alpha",
    "summation_law", "sweep_filter_sensitivity", "sweep_sensitivity",
    "synthetic_feeder", "trajectory_injections",
    "tuned_filter_admittance", "validate_network", "voltage_phasors",
    "warm_start", "waveform", "waveform_metrics", "write_ilog",
    "write_vlog"
]
