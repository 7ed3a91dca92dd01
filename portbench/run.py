"""The benchmark of hpfx_torch, the PyTorch and CUDA port of hpfx.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cells, metrics and bounds are in
``BENCHMARK.json``; what each names is under ``portbench/`` (see
``portbench/harness/cli.py``).  Exits with code 2 and no result when
CUDA shows fewer cards than the cell needs, and with 3 when a module of
JAX or of the JAX package is loaded.
"""
import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
