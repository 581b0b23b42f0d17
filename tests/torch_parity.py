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


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)
