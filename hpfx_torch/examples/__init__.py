"""Worked examples (the port of :mod:`hpfx.examples`)."""
from .almeida import linear_hcne_twoport
from .fuchs import fuchs_device_set, fuchs_network, solve_fuchs

__all__ = ["solve_fuchs", "fuchs_network", "fuchs_device_set",
           "linear_hcne_twoport"]
