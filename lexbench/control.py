#!/usr/bin/env python3
"""The control of a cell's check, beside the program's own readings, on
several seeds in one process (on the card):

    python3 lexbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds`` at the cell's own load, the check) and prints one JSON line:
the program's ``resid_gap`` and the control's.  The control is a step down
in precision from the configuration's float32 with TF32 off: the reference
itself with TF32 products (``lexls_ref.solve(..., precision="tf32")``) on
the program's sampled instances, scored against the float64 reference
exactly as the program is.

The limit of ``resid_gap`` lies between the largest program reading and
the smallest control reading (PERF.md gives both).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_reading(cell, program):
    """The control's widest gap for one seed, given the program's run."""
    from lexbench.harness import check

    samples = program["_extra"]["samples"]
    refs = program["_extra"]["readings"]["refs"]
    ctl = check.solve_all([s[:3] for s in samples], cell.config, precision="tf32")
    dims = cell.config["dims"]
    gaps = [check.gap(A, lb, ub, dims, cx, rx)
            for (A, lb, ub, _), (cx, _, _), (rx, st, _) in zip(samples, ctl, refs) if st == 0]
    return {"control": "reference with TF32 products", "resid_gap": max(gaps),
            "unsolved": sum(1 for c in ctl if c[1] != 0), "gaps": gaps}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control on the first N seeds only (default: all)")
    args = p.parse_args()
    import torch

    from lexbench.harness import spec
    from lexbench.harness.cli import REPO, run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, REPO / "BENCHMARK.json")
    torch.set_num_threads(1)
    prog_max, ctl_min = 0.0, float("inf")
    n_ctl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        prog = run_cell(cell, seed, args.seconds, False)
        r = prog["_extra"]["readings"]
        ctl = control_reading(cell, prog) if i < n_ctl else {}
        prog_max = max(prog_max, r["resid_gap"])
        ctl_min = min(ctl_min, ctl.get("resid_gap", float("inf")))
        print(json.dumps({"cell": cell.name, "seed": seed, "correct": prog["correct"],
                          "program": r["resid_gap"],
                          "program_gaps": r["gaps"], "program_failed": prog["failed"],
                          "program_attempted": prog["attempted"], **ctl}), flush=True)
    print(json.dumps({"cell": cell.name, "seeds": len(args.seeds), "program_max": prog_max,
                      "control_min": ctl_min}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
