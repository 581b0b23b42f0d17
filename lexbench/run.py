#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 lexbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line on stdout is the result (JSON); the last lines on stderr
name each number the check compared beside its limit.  See README.md.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from lexbench.harness.cli import main

    sys.exit(main())
