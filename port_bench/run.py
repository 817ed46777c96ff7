"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload cornell.final --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout that holds BENCHMARK.json and rene_tpu_torch.
See port_bench/harness.py for what a run does.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()     # set-up starts with the process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

if __name__ == "__main__":
    from port_bench import harness
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
