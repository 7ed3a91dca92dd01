"""A rank of a CPU run of a several-card cell, for the fault tests:

    python rank_fault.py <fault> <run.py's arguments...>

takes the CPU in place of a card, cuts the cell's traffic to a test's
size, plants ``fault`` ("none" or "no_exchange": the result's all-gather
left out, each rank's piece standing for every rank's) and runs
``run.py``."""
import os
import runpy
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402
from harness import cards, spec  # noqa: E402

fault = sys.argv.pop(1)
torch.set_num_threads(1)
cards.require = lambda n: None
cards.device = lambda rank: torch.device("cpu")
_cell = spec.cell
spec.cell = lambda name, root=spec.ROOT: _small(
    _cell(name, root, conftest.bench_with_x4(root)))


def _small(cell):
    h, b = conftest.SMALL[cell.name]
    cell.traffic = dict(cell.traffic, h_max=h, batch=b)
    return cell


if fault == "no_exchange":
    from hpfx_torch.parallel import mesh as M

    def no_exchange(mesh, res, Bp, B):
        return M._tree_map(lambda x: torch.cat([x] * mesh.size)[:B], res)

    M._gather_result = no_exchange
sys.argv = [os.path.join(conftest.BENCH, "run.py"), *sys.argv[1:]]
runpy.run_path(sys.argv[0], run_name="__main__")
