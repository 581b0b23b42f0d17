"""The port's NumPy layers against the JAX package's: enum codes,
parameter defaults, the random problem generators, the λ-sweep tables of
``Structure``, and the conversion helpers."""

import dataclasses

import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch import types as TT
from lexls_tpu_torch.oracle import generate as tgen

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["RegularizationType", "TerminationStatus", "CtrType",
                                  "OperationType", "ObjectiveType"])
def test_enum_codes_match(name):
    ours, ref = getattr(TT, name), getattr(JT, name)
    assert {e.name: int(e) for e in ours} == {e.name: int(e) for e in ref}


@pytest.mark.parametrize("name", ["ParametersLexLSI", "ParametersLexLSE"])
def test_parameter_defaults_match(name):
    ours, ref = getattr(TT, name)(), getattr(JT, name)()
    assert {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours)} == \
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    assert convert.params_from(ref, type(ours)) == ours


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_bit_identical(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    ra = jgen.random_equality_hierarchy(a, 9, [3, 4, 2], [2, 3, 1], fixed_variables=2)
    rb = tgen.random_equality_hierarchy(b, 9, [3, 4, 2], [2, 3, 1], fixed_variables=2)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for simple in (False, True):
        pa = jgen.random_inequality_hierarchy(a, 10, [3, 4, 4], equality_fraction=0.2,
                                              tight_fraction=0.4, simple_bounds=simple)
        pb = tgen.random_inequality_hierarchy(b, 10, [3, 4, 4], equality_fraction=0.2,
                                              tight_fraction=0.4, simple_bounds=simple)
        for f in ("A", "lb", "ub", "regularization"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
        assert (pa.dims, pa.n_var, pa.simple_bounds) == (pb.dims, pb.n_var, pb.simple_bounds)
        np.testing.assert_array_equal(np.asarray(pa.var_idx if simple else []),
                                      np.asarray(pb.var_idx if simple else []))


@pytest.mark.parametrize("simple", [False, True])
def test_structure_sweep_tables_match(simple):
    prob = tgen.random_inequality_hierarchy(np.random.default_rng(3), 8, [3, 2, 4],
                                            simple_bounds=simple)
    ours, ref = lt.Structure.of(prob), jli.Structure.of(prob)
    assert ours.lexlse_dims == ref.lexlse_dims and ours.d0 == ref.d0
    for j in range(len(ref.lexlse_dims)):
        np.testing.assert_array_equal(ours.sweep_priority(j), ref.sweep_priority(j))
        np.testing.assert_array_equal(ours.sweep_eligible(j), ref.sweep_eligible(j))


def test_convert_round_trip():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((5, 3))
    prob = convert.hierarchy_from_numpy(A, -np.ones(5), np.ones(5), (2, 3))
    assert prob.dims == (2, 3) and prob.n_var == 3
    with pytest.raises(TT.LexLSError):
        convert.hierarchy_from_numpy(A, np.ones(5), -np.ones(5), (2, 3))
    f, i, flag = convert.to_torch((A, np.arange(3), np.array([True])), "cpu", torch.float32)
    assert f.dtype == torch.float32 and i.dtype == torch.int32 and flag.dtype == torch.bool
    state = lt.LexLSIState(*(torch.full((2,), k)
                             for k in range(len(dataclasses.fields(lt.LexLSIState)))))
    out = convert.state_to_numpy(state)
    assert set(out) == {f.name for f in dataclasses.fields(state)}
    np.testing.assert_array_equal(out["status"], [15, 15])


@pytest.mark.parametrize("simple", [False, True])
def test_hierarchy_helpers_match(simple):
    """``level_slice``, ``level_of_row`` and ``initial_ctr_type`` (equality
    rows active, a general row with a zero normal not) against the JAX
    package's, on the same problem."""
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(5), 7, [4, 3, 3],
                                            simple_bounds=simple, equality_fraction=0.4)
    prob.A[-1] = 0.0
    prob.lb[-1] = prob.ub[-1] = 0.5
    ours = convert.hierarchy_from_numpy(prob.A, prob.lb, prob.ub, prob.dims, prob.n_var,
                                        simple, prob.var_idx)
    for k in range(prob.n_obj):
        assert ours.level_slice(k) == prob.level_slice(k)
    np.testing.assert_array_equal(ours.level_of_row(), prob.level_of_row())
    got, want = ours.initial_ctr_type(), prob.initial_ctr_type()
    assert got.dtype == want.dtype and int((got == int(TT.CtrType.ACTIVE_EQ)).sum()) > 1
    np.testing.assert_array_equal(got, want)


def test_equality_hierarchy_matches():
    """``EqualityHierarchy``: the same fields, defaults and refusals as the
    JAX package's."""
    rng = np.random.default_rng(6)
    A, b = rng.standard_normal((5, 4)), rng.standard_normal(5)
    kw = dict(A=A, b=b, dims=(2, 3), fixed_idx=[1, 3], fixed_val=[0.5, -1.0])
    ours, ref = TT.EqualityHierarchy(**kw), JT.EqualityHierarchy(**kw)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name))
    assert (ours.n_var, ours.n_obj, ours.n_fixed, ours.level_slice(1)) == (
        ref.n_var, ref.n_obj, ref.n_fixed, ref.level_slice(1))
    with pytest.raises(TT.LexLSError):
        TT.EqualityHierarchy(A=A, b=b[:4], dims=(2, 3))
