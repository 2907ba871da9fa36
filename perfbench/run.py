#!/usr/bin/env python3
"""Run one benchmark cell once on the card(s) and print its result line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells are ``BENCHMARK.json``'s
``workloads``; ``perfbench/README.md`` says how they are made.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
