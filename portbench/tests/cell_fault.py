"""One run of a cell at its own size on the card, with a fault of
``test_portbench_faults.py`` planted in the timed path:

    python portbench/tests/cell_fault.py <fault> <run.py's arguments...>

The check has to come out as not correct (``"correct": false``)."""
import os
import runpy
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402
from test_portbench_faults import FAULTS  # noqa: E402

FAULTS[sys.argv.pop(1)](pytest.MonkeyPatch())
sys.argv = [os.path.join(conftest.BENCH, "run.py"), *sys.argv[1:]]
runpy.run_path(sys.argv[0], run_name="__main__")
