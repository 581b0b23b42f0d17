"""Helpers shared by the port's tests (``tests/test_torch_*.py``).

The same NumPy inputs go through the JAX package (the reference, float64
on the CPU) and through ``lexls_tpu_torch``; results come back as NumPy
arrays and are compared here.  This module imports no JAX, so that the
CUDA tests (``tests/test_torch_kernels.py``) also run where JAX is absent.
"""

import numpy as np
import pytest
import torch

# integer state that must agree exactly (test_fused.py:43-59)
INT_FIELDS = ("status", "it", "ctr_type", "stamp", "n_act", "n_deact", "n_fact", "next_stamp")


def assert_state_match(ref, got, msg=""):
    """A JAX solver state against the port's: integer fields equal, x and
    v to atol 1e-9 (float64 roundoff of two summation orders)."""
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg}:{f}")
    for f in ("x", "v"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-9, rtol=0, err_msg=f"{msg}:{f}")


def assert_log_match(ref, got, msg="", cycling=False):
    """The working-set log of a JAX solver state against the port's (where
    the port keeps one: its log is empty when the option is off): entries,
    lengths and flags equal, the logged values to atol 1e-9.  With
    ``cycling`` also the detector's state, equal, and the relaxed bounds,
    to atol 0."""
    for f in ("log_obj", "log_ctr", "log_type", "log_rank", "log_len", "log_overflow",
              "log_cycling") + (("cyc_counter", "cyc_prev_op", "cyc_prev_row", "cyc_prev_type")
                                if cycling else ()):
        g = getattr(got, f).cpu().numpy()
        if g.size:
            np.testing.assert_array_equal(g, np.asarray(getattr(ref, f)), err_msg=f"{msg}:{f}")
    if got.log_value.numel():
        np.testing.assert_allclose(got.log_value.cpu().numpy(), np.asarray(ref.log_value),
                                   atol=1e-9, rtol=0, err_msg=f"{msg}:log_value")
    if cycling:
        for f in ("lb", "ub"):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(), np.asarray(getattr(ref, f)),
                                       atol=0, rtol=0, err_msg=f"{msg}:{f}")


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
