"""The comparison that decides ``correct``.

Each sampled answer x of the program is held against the plain reference
(``lexbench/reference/lexls_ref.py``), which solves the same instance
(the A, lb and ub the program got) cold, in float64, with the
configuration's tolerances and budget.  A lexicographic optimum has a
unique vector of level residuals (per level, the norm of the least v that
makes x feasible), whichever x attains it, so the number compared is

    resid_gap = max over answers and levels k of
                | r_k(x) - r_k(x_ref) | / (1 + r_k(x_ref))

with r_k the level residual in float64.  An answer that stops short on a
high level, or steps off a bound it should hold, reads far above the
rounding of a sound solve.  The reference runs after the window has
closed, in worker processes (NumPy only) that this module starts as plain
subprocesses and waits for on every path out: no pool, whose helper
process (multiprocessing's resource tracker) would outlive the run.  Beside
``resid_gap`` the run compares ``failed``, counted over every solve of the
window on the device: the solves that ended in another status than
``PROBLEM_SOLVED`` or with a non-finite x (limit 0).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _solve_one(args):
    from lexbench.reference import lexls_ref as ref

    A, lb, ub, dims, var_idx, params, precision = args
    prob = ref.Hierarchy(A=A, lb=lb, ub=ub, dims=tuple(dims), var_idx=var_idx)
    res = ref.solve(prob, ref.Params(**params), precision)
    return res.x, int(res.status), res.n_iterations


def worker():
    """A worker process's body: solve the pickled jobs read from stdin, and
    write their pickled results to stdout, nothing else."""
    jobs, out = pickle.load(sys.stdin.buffer), sys.stdout.buffer
    sys.stdout = sys.stderr
    pickle.dump([_solve_one(j) for j in jobs], out)
    out.flush()


def reference_params(config: dict) -> dict:
    keys = ("max_number_of_factorizations", "tol_linear_dependence", "tol_wrong_sign_lambda",
            "tol_correct_sign_lambda", "tol_feasibility", "deactivate_first_wrong_sign")
    return {k: config["params"][k] for k in keys if k in config["params"]}


def solve_all(problems: Sequence, config: dict, precision: str = "float64",
              workers: Optional[int] = None) -> List[tuple]:
    """(x, status, iterations) of the reference on each (A, lb, ub)."""
    dims, var_idx = tuple(config["dims"]), None
    if config["simple_bounds"]:
        from .traffic import hierarchy

        var_idx = hierarchy(config).var_idx
    params = reference_params(config)
    jobs = [(A, lb, ub, dims, var_idx, params, precision) for A, lb, ub in problems]
    n = workers or max(1, min(len(jobs), os.cpu_count() or 1, 8))
    if n == 1:
        return [_solve_one(j) for j in jobs]
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    procs = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen([sys.executable, "-c",
                                           "from lexbench.harness.check import worker; worker()"],
                                          stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                                          cwd=root))
        for i, proc in enumerate(procs):
            pickle.dump(jobs[i::n], proc.stdin)  # read whole before the worker writes
            proc.stdin.close()
        results = [None] * len(jobs)
        for i, proc in enumerate(procs):
            out = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"reference worker {i} exited with {proc.returncode}")
            results[i::n] = pickle.loads(out)
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for pipe in (proc.stdin, proc.stdout):
                if pipe and not pipe.closed:
                    pipe.close()


def level_residuals(A, lb, ub, dims, x) -> np.ndarray:
    from lexbench.reference.lexls_ref import Hierarchy, level_residuals as res

    return res(Hierarchy(A=A, lb=lb, ub=ub, dims=tuple(dims)), x)


def gap(A, lb, ub, dims, x, x_ref) -> float:
    r, r_ref = level_residuals(A, lb, ub, dims, x), level_residuals(A, lb, ub, dims, x_ref)
    if not np.all(np.isfinite(r)):
        return float("inf")
    return float(np.max(np.abs(r - r_ref) / (1.0 + r_ref)))


def compare(samples: Sequence, config: dict, refs: Optional[List[tuple]] = None) -> dict:
    """Readings of the sampled answers ``(A, lb, ub, x)`` against the
    reference: the widest gap over the answers whose reference solve ended
    solved, and how many such answers there were."""
    refs = refs or solve_all([s[:3] for s in samples], config)
    dims = config["dims"]
    gaps = [gap(A, lb, ub, dims, x, rx) for (A, lb, ub, x), (rx, st, _) in zip(samples, refs)
            if st == 0]
    return {"resid_gap": max(gaps) if gaps else float("inf"), "checked": len(gaps),
            "reference_unsolved": sum(1 for r in refs if r[1] != 0),
            "gaps": gaps, "refs": refs}
