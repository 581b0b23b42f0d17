"""The port's tracker under TIKHONOV_CG against the JAX package's, on
config 3's shape (``tests/test_tracker.py:655-725``): the two CG trials of
``test_torch_tracker_reg.py::cold_case``, in a file of their own so that
the JAX package's compilations of the two regularization types run on
different workers."""

import pytest

from lexls_tpu import types as JT

from test_torch_tracker_reg import cold_case


@pytest.mark.parametrize("trial,rt", [(0, JT.RegularizationType.TIKHONOV_CG),
                                      (1, JT.RegularizationType.TIKHONOV_CG)])
def test_reg_tracked_cold_matches_jax(trial, rt):
    cold_case(trial, rt)
