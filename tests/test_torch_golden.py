"""The C++ golden corpus through the port's host API, on the CPU.

The fixtures in ``tests/golden/`` come from the compiled reference lexls
(``tools/golden/generate.py``).  Every corpus is read with the port's own
``.dat`` parser and solved by ``lexls_tpu_torch.solve`` (the exact tier on
a batch of one, kernel B1's plain version on the CPU) at the reference's
default parameters, with the checks of ``tests/test_golden_parity.py``:
the status, the per-level constraint-violation norms to 1e-8, the
factorization count where that file asserts it (warm and sequence
fixtures, not ``ineq_*``: both Python packages take more factorizations
than the C++ gold on ``ineq_03/08/13/19``), x to 1e-7 on the regularized
fixtures; the equality corpora through ``LexLSE`` (options 0, 1 and 2
and the general norm).  No JAX: the parser check alone reads the JAX package's
parser, inside its test.
"""

import json
import os

import numpy as np
import pytest
import torch

import lexls_tpu_torch as lt
from lexls_tpu_torch.io import dat as io_dat

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _index():
    with open(os.path.join(GOLDEN, "index.json")) as f:
        return json.load(f)


def _gold(name):
    with open(os.path.join(GOLDEN, name + ".json")) as f:
        return json.load(f)


def _level_norms(prob, x):
    """Per-level norms of the constraint violation (``objective.h:611-630``)."""
    Ax = prob.A @ x
    w = np.where(Ax <= prob.lb, Ax - prob.lb, np.where(Ax >= prob.ub, Ax - prob.ub, 0.0))
    return [float(np.linalg.norm(w[prob.level_slice(k)])) for k in range(prob.n_obj)]


def _gold_norms(prob, gold):
    w = np.concatenate([np.asarray(v) for v in gold["violation"]])
    return [float(np.linalg.norm(w[prob.level_slice(k)])) for k in range(prob.n_obj)]


def _solve_fixture(name, index):
    """Solve one fixture as ``test_golden_parity.py`` does: a warm fixture
    with the guess and x it carries, a regularized one with its type and
    factors.  Returns (result, problem, gold)."""
    d = io_dat.load_dat_python(os.path.join(GOLDEN, index[name]["dat"]))
    prob = io_dat.to_inequality(d)
    params = lt.ParametersLexLSI()
    if index[name].get("reg_type"):
        params = lt.ParametersLexLSI(
            regularization_type=lt.RegularizationType(index[name]["reg_type"]))
        prob.regularization = np.asarray(index[name]["reg_factors"], float)
    kw = {}
    if index[name].get("warm"):
        kw = dict(x0=d.solution_guess, active_guess=d.active_guess_stacked())
        assert kw["x0"] is not None and kw["active_guess"] is not None
    return lt.solve(prob, params, device="cpu", **kw), prob, _gold(name)


@pytest.mark.parametrize("name", [f"ineq_{i:02d}" for i in range(20)] + ["test_01"])
def test_inequality_golden(name):
    index = _index()
    dat_path = index[name]["dat"]
    if not os.path.exists(os.path.join(GOLDEN, dat_path)):
        pytest.skip(f"{dat_path} missing")
    res, prob, gold = _solve_fixture(name, index)
    assert int(res.status) == int(gold["status"]), name
    np.testing.assert_allclose(_level_norms(prob, res.x), _gold_norms(prob, gold), atol=1e-8,
                               err_msg=name)


_WARM_NAMES = ([f"warm_{i:02d}" for i in range(8)] + [f"warm_sb_{i:02d}" for i in range(6)]
               + [f"warm_tik_{i:02d}" for i in range(6)])


@pytest.mark.parametrize("name", _WARM_NAMES)
def test_warm_start_golden(name):
    """HierType-210 fixtures, warm-started with the guess they carry: the
    reference solves each in one factorization, and so must the port
    (regularized fixtures: x, unique there, to 1e-7 instead)."""
    index = _index()
    res, prob, gold = _solve_fixture(name, index)
    assert int(res.status) == int(gold["status"]), name
    if index[name].get("reg_type"):
        np.testing.assert_allclose(res.x, np.asarray(gold["x"]), atol=1e-7, err_msg=name)
    else:
        assert res.n_factorizations == int(gold["factorizations"]), name
    np.testing.assert_allclose(_level_norms(prob, res.x), _gold_norms(prob, gold), atol=1e-8,
                               err_msg=name)


@pytest.mark.parametrize("name", [f"seq_{i:02d}" for i in range(4)])
def test_warm_sequence_golden(name):
    """Drifted sequences: steps t1-t3, each warm-started from the reference's
    own previous step as the fixture records it."""
    index = _index()
    for t in range(1, 4):
        step = f"{name}_t{t}"
        res, prob, gold = _solve_fixture(step, index)
        assert int(res.status) == int(gold["status"]), step
        assert res.n_factorizations == int(gold["factorizations"]), step
        np.testing.assert_allclose(_level_norms(prob, res.x), _gold_norms(prob, gold),
                                   atol=1e-8, err_msg=step)


def _equality_fixture(name):
    prob = io_dat.to_equality(io_dat.load_dat_python(os.path.join(GOLDEN, _index()[name]["dat"])))
    assert isinstance(prob, lt.EqualityHierarchy)
    return prob, _gold(name)["v_norms"]


def _residual_norms(prob, v):
    return [float(np.linalg.norm(v[prob.level_slice(k)])) for k in range(prob.n_obj)]


@pytest.mark.parametrize("name", [f"eq_{i:02d}" for i in range(6)])
def test_equality_golden(name):
    """Equality corpora through the port's ``LexLSE``: one l-QR (kernel
    B1's plain version) and the basic solve; per-level residual norms to
    1e-8."""
    prob, gold = _equality_fixture(name)
    res = lt.LexLSE(prob, device="cpu").solve(0)
    np.testing.assert_allclose(res.v, prob.A @ res.x - prob.b, atol=1e-12, rtol=0)
    np.testing.assert_allclose(_residual_norms(prob, res.v), gold, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("name", [f"eq_{i:02d}" for i in range(6)])
def test_equality_golden_least_norm(name):
    """The least-norm options 1 and 2, and the general norm with M = I,
    m_rhs = 0, move x within the solution set: every level's residual norm
    stays the gold's to 1e-8."""
    prob, gold = _equality_fixture(name)
    s = lt.LexLSE(prob, device="cpu")
    n = prob.n_var
    for res in (s.solve(1), s.solve(2), s.solve_general_norm(np.eye(n), np.zeros(n))):
        np.testing.assert_allclose(_residual_norms(prob, res.v), gold, atol=1e-8, err_msg=name)


def test_dat_parser_matches_jax_package(tmp_path):
    """Every corpus file parsed by the port's ``io.dat`` against the JAX
    package's parser, field by field, and the port's writer read back
    unchanged."""
    from lexls_tpu.io import dat as jdat

    files = sorted(f for f in os.listdir(os.path.join(GOLDEN, "cases")) if f.endswith(".dat"))
    assert len(files) >= 80
    for fname in files:
        path = os.path.join(GOLDEN, "cases", fname)
        got, want = io_dat.load_dat_python(path), jdat.load_dat_python(path)
        assert (got.hier_type, got.n_var, got.dims) == (want.hier_type, want.n_var, want.dims)
        np.testing.assert_array_equal(got.obj_type, want.obj_type)
        for a, b in zip(got.objectives, want.objectives):
            np.testing.assert_array_equal(a, b)
        for f in ("solution_guess", "solution"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), (fname, f)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        ga, gb = got.active_guess_stacked(), want.active_guess_stacked()
        assert (ga is None) == (gb is None), fname
        if ga is not None:
            np.testing.assert_array_equal(ga, gb)
        if got.hier_type != io_dat.HIER_EQUALITIES:
            prob = io_dat.to_inequality(got)
            out = str(tmp_path / fname)
            io_dat.save_dat(out, io_dat.from_inequality(prob, got.active_guess_stacked(),
                                                        got.solution_guess))
            back = io_dat.to_inequality(io_dat.load_dat_python(out))
            for f in ("A", "lb", "ub"):
                np.testing.assert_array_equal(getattr(back, f), getattr(prob, f))
