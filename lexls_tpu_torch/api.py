"""Public façade of the equality solver (``lexls_tpu/api.py``, reference
``include/lexls/lexls.h``).

``LexLSE`` holds one equality hierarchy, then ``solve(solve_option)`` =
factorize + one of the four solves (``lexls.h:39-63``), with the MEX
feature set of ``lexlse.cpp`` (fixed variables, regularization, the
least-norm options, the general norm, the multipliers).  The
factorization is :func:`lexls_tpu_torch.ops.factorize_fast_batched` on a
batch of one, kernel B1 once per level; the JAX façade's physical-swap
``lexlse.factorize`` agrees with it to 1e-13 and is not ported.
``solve_equality_batched`` is the same over a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import lexlse as le
from .lexlsi import _np, full_fp32, host_device, host_tensor
from .ops import factorize_fast_batched
from .types import EqualityHierarchy, LexLSError, ParametersLexLSE, RegularizationType


@dataclasses.dataclass
class LexLSEResult:
    """x, the stacked residuals v = A x - b per constraint row, the rank of
    each level, and the factorization (a batch of one, on the solve's
    device)."""

    x: np.ndarray
    v: np.ndarray
    ranks: np.ndarray
    total_rank: int
    lexqr: le.LexQR


class LexLSE:
    """Host-side equality-hierarchy solver (reference ``lexls.h:16-69``,
    MEX surface ``lexlse.cpp:25-247``).  Runs on ``device``, the card
    unless the caller passes ``device="cpu"`` (the plain version of kernel
    B1), never elsewhere."""

    def __init__(self, prob: EqualityHierarchy, params: Optional[ParametersLexLSE] = None,
                 reg_factors: Optional[np.ndarray] = None, dtype=torch.float64,
                 device="cuda"):
        self.prob = prob
        self.params = params or ParametersLexLSE()
        self.dtype = dtype
        self.device = host_device(device)
        n = prob.n_var
        self._fixed = (None, None)
        if prob.fixed_idx is not None:
            fixed_mask = np.zeros(n, bool)
            fixed_mask[prob.fixed_idx] = True
            fixed_val = np.zeros(n)
            fixed_val[prob.fixed_idx] = prob.fixed_val
            self._fixed = (torch.as_tensor(fixed_mask, device=self.device)[None],
                           host_tensor(fixed_val, self.device, dtype)[None])
        if reg_factors is None and self.params.regularization_type != RegularizationType.NONE:
            reg_factors = np.zeros(prob.n_obj)
        self._reg = None if reg_factors is None else host_tensor(reg_factors, self.device,
                                                                  dtype)
        self._f: Optional[le.LexQR] = None

    def factorize(self) -> le.LexQR:
        full_fp32()
        A, b = (host_tensor(a, self.device, self.dtype)[None]
                for a in (self.prob.A, self.prob.b))
        self._f = factorize_fast_batched(A, b, self.prob.dims, self.params,
                                         fixed_mask=self._fixed[0], fixed_val=self._fixed[1],
                                         reg_factors=self._reg)
        return self._f

    def solve(self, solve_option: int = 0) -> LexLSEResult:
        """0: basic (free variables = 0); 1: least-norm, orthogonal;
        2: least-norm, normal equations; 3: least-norm via the Tikhonov
        null-space basis (requires TIKHONOV regularization with zero
        factors).  Mirrors ``lexls.h:39-63``."""
        if solve_option not in (0, 1, 2, 3):
            raise LexLSError(f"unknown solve_option {solve_option}")
        if solve_option == 3 and self.params.regularization_type != RegularizationType.TIKHONOV:
            raise LexLSError(
                "solve_option 3 requires regularization_type TIKHONOV "
                "with zero factors (reference lexlse.h:1219-1221)")
        f = self.factorize()
        x = (le.solve, le.solve_least_norm_1, le.solve_least_norm,
             le.solve_least_norm_3)[solve_option](f)
        return self._result(f, x)

    def solve_general_norm(self, M: np.ndarray, m_rhs: np.ndarray) -> LexLSEResult:
        """min ||M x - m_rhs|| over the solution set (``lexlse.h:1286``)."""
        f = self.factorize()
        x = le.solve_general_norm(f, host_tensor(M, self.device, self.dtype),
                                  host_tensor(m_rhs, self.device, self.dtype))
        return self._result(f, x)

    def lambdas(self) -> np.ndarray:
        """λ matrix (m, p): column k = multipliers of objective k."""
        f = self._f or self.factorize()
        # the original columns serve as the fixed variables' data
        _, lam = le.lambda_matrix(f, host_tensor(self.prob.A, self.device, self.dtype))
        return _np(lam[0])

    def _result(self, f: le.LexQR, x) -> LexLSEResult:
        xh = _np(x[0])
        return LexLSEResult(x=xh, v=self.prob.A @ xh - self.prob.b, ranks=_np(f.ranks[0]),
                            total_rank=int(f.total_rank[0]), lexqr=f)


def solve_equality_batched(A, b, dims, params: Optional[ParametersLexLSE] = None,
                           least_norm: bool = False, dtype=torch.float64, device="cuda"):
    """Batched equality-hierarchy solve: ``A`` (B, m, n), ``b`` (B, m) ->
    x (B, n), a tensor (``api.py:113-133``; ``bench_extra.py``'s config 1:
    many independent hierarchies per card).  One l-QR through kernel B1
    (once per level) and the basic solve, or with ``least_norm`` the
    least-norm completion.  Torch tensors keep their device and dtype;
    NumPy arrays go to ``device`` in ``dtype``, the card unless the caller
    passes ``device="cpu"``."""
    full_fp32()
    params = params or ParametersLexLSE()
    A = host_tensor(A, device, dtype)
    b = host_tensor(b, A.device, A.dtype).to(A)
    f = factorize_fast_batched(A, b, tuple(int(d) for d in dims), params)
    return le.solve_least_norm(f) if least_norm else le.solve(f)
