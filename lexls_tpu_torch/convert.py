"""Carry problems, parameters and state between NumPy and the port.

The JAX package's host-side objects (hierarchies, parameters, solver
states) are read by their field names, so nothing here imports JAX: a
test hands the same NumPy arrays to both packages and compares what comes
back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .types import InequalityHierarchy, ParametersLexLSI, RegularizationType


def hierarchy_from_numpy(A, lb, ub, dims: Sequence[int], n_var: Optional[int] = None,
                         simple_bounds: bool = False, var_idx=None,
                         regularization=None) -> InequalityHierarchy:
    """An :class:`InequalityHierarchy` of this package from NumPy arrays."""
    A = np.asarray(A, dtype=np.float64)
    return InequalityHierarchy(
        A=A, lb=np.asarray(lb), ub=np.asarray(ub), dims=tuple(int(d) for d in dims),
        n_var=A.shape[1] if n_var is None else int(n_var), simple_bounds=simple_bounds,
        var_idx=var_idx, regularization=regularization)


def params_from(obj, cls=ParametersLexLSI):
    """A parameter object of this package with the field values of ``obj``
    (any object with the same attribute names, such as the JAX package's
    ``ParametersLexLSI``)."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls) if hasattr(obj, f.name)}
    if "regularization_type" in kw:
        kw["regularization_type"] = RegularizationType(int(kw["regularization_type"]))
    return cls(**kw)


def to_torch(batch, device, dtype=torch.float64):
    """NumPy arrays (or nested tuples, lists and dicts of them) to tensors
    on ``device``: floating arrays in ``dtype``, integer arrays in int32,
    booleans as bool."""
    if isinstance(batch, dict):
        return {k: to_torch(v, device, dtype) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_torch(v, device, dtype) for v in batch)
    arr = np.asarray(batch)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int32), device=device)
    return torch.as_tensor(arr, device=device).to(dtype)


def state_to_numpy(state) -> dict:
    """Every tensor field of a state dataclass as a NumPy array."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def carried_from_numpy(rinv, pos, ranks, device, dtype=torch.float64):
    """A :class:`lexls_tpu_torch.tracker.Carried` from the three arrays of
    a carried factorization (for instance the JAX package's ``Carried``,
    field by field)."""
    from .tracker import Carried

    return Carried(*to_torch((np.asarray(rinv), np.asarray(pos), np.asarray(ranks)),
                             device, dtype))


def carried_to_numpy(carried) -> tuple:
    """``(rinv, pos, ranks)`` of a carried factorization as NumPy arrays."""
    return tuple(a.detach().cpu().numpy() for a in carried)
