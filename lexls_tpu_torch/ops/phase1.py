"""Phase 1 of a warm step, one kernel launch each: the working-set
activation and the hot start.

``activation`` is the body of ``sequence._device_initial_activation``
(each row's type from the equality and guess tests, and the insertion
stamps in row order); ``phase1_warm`` is the x-guess branch of
``lexlsi._initial_state`` (Ax, the hot-start repair of the guessed working
set, the move of x onto its simple bounds, v0, the step at dx = 0, and the
counters, status and cycling detector of a state before its first
iteration).  Neither replaces a Pallas TPU kernel: the JAX package's phase
1 is ``jnp`` code that XLA fuses.  In torch it was some ninety launches a
warm step, whose issue kept the card idle; on a CUDA tensor each function
now launches one kernel of ``csrc/phase1.cu`` (one thread block per
instance), on a CPU tensor it runs its plain version, ``activation_ref`` /
``phase1_warm_ref`` (the torch code the kernels replace), and on any other
device it raises.  Both check shapes and dtypes on every device and raise
``ValueError`` for a mismatch; the kernels take contiguous copies of what
is not contiguous, and write only new output tensors.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from ..active_set import (
    Phase1Result,
    _form_initial_working_set,
    _matvec,
    _modify_x_guess,
    _phase1_result,
)
from ..types import CtrType
from . import _build
from .fused import _var_index
from .panel_lqr import _SUFFIX

ACTIVATION_INPUTS = ("A", "lb", "ub", "guess")
ACTIVATION_OUTPUTS = ("ct", "st", "ns")
ACTIVATION_INTS = ("B", "m", "n", "d0")
WARM_INPUTS = ("A", "lb", "ub", "ct", "st", "ns", "x", "v0", "vidx")
WARM_OUTPUTS = ("x", "v", "dx", "dv", "Ax", "Adx", "ct", "st", "ns",
                "zero", "nf", "status", "minus_one", "ovf")
WARM_INTS = ("B", "m", "n", "d0", "modify_inactive", "modify_active", "modify_x",
             "min_violation", "n_fact")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def activation_ref(A, lb, ub, guess_type, d0: int):
    """Plain version of :func:`activation`."""
    B, m, _ = A.shape
    eq = (lb - ub).abs() < 1e-15
    nonzero = (A * A).sum(2) > 0
    is_bound_row = torch.zeros(m, dtype=torch.bool, device=A.device)
    is_bound_row[:d0] = True
    eq = eq & (nonzero | is_bound_row)

    guess_ok = (guess_type == int(CtrType.ACTIVE_LB)) | (guess_type == int(CtrType.ACTIVE_UB))
    ctr = torch.where(eq, int(CtrType.ACTIVE_EQ),
                      torch.where(guess_ok, guess_type, int(CtrType.INACTIVE))).to(torch.int32)
    n_eq = eq.sum(1, dtype=torch.int32)
    eq_order = eq.to(torch.int32).cumsum(1, dtype=torch.int32) - 1
    g = guess_ok & ~eq
    g_order = g.to(torch.int32).cumsum(1, dtype=torch.int32) - 1
    stamp = torch.where(eq, eq_order, torch.where(g, n_eq[:, None] + g_order, -1))
    next_stamp = n_eq + g.sum(1, dtype=torch.int32)
    return ctr, stamp.to(torch.int32), next_stamp


def phase1_warm_ref(A, lb, ub, ctr_type, stamp, next_stamp, x, v0, *, struct, params,
                    v0_specified: bool) -> Phase1Result:
    """Plain version of :func:`phase1_warm`."""
    Ax = _matvec(A, x)
    if not v0_specified:
        ctr_type, stamp, next_stamp = _form_initial_working_set(
            ctr_type, stamp, next_stamp, Ax, lb, ub, params)
        if struct.simple_bounds and params.modify_x_guess_enabled:
            x = _modify_x_guess(x, ctr_type, lb, ub, struct)
            Ax = _matvec(A, x)
    return _phase1_result(A, lb, ub, ctr_type, stamp, next_stamp, x, Ax,
                          v0 if v0_specified else None, params,
                          n_fact=int(not params.use_phase1_v0))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ACT_IN = _P * len(ACTIVATION_INPUTS)
_ACT_OUT = _P * len(ACTIVATION_OUTPUTS)
_ACT_INTS = ctypes.c_int * len(ACTIVATION_INTS)
_WARM_IN = _P * len(WARM_INPUTS)
_WARM_OUT = _P * len(WARM_OUTPUTS)
_WARM_INTS = ctypes.c_int * len(WARM_INTS)


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype):
    """(name, bound C entry) of ``lexls_<kind>_<f32|f64>``."""
    name = f"lexls_{kind}_{_SUFFIX[dtype][0]}"
    argtypes = (_P, _P, _P, _P) if kind == "activation" else (_P, _P, _P, ctypes.c_double, _P)
    return name, _build.bind(name, argtypes)


def _check(name: str, A, floats, ints) -> None:
    """Raise ``ValueError`` unless A is (B, m, n) float32 or float64 and
    every ``(tensor, shape)`` of ``floats`` / ``ints`` has its shape, A's
    device, and A's dtype / int32."""
    if A.dim() != 3 or A.dtype not in _SUFFIX:
        raise ValueError(f"{name}: A must be (B, m, n) float32 or float64, got "
                         f"{tuple(A.shape)} {A.dtype}")
    for group, dtype in ((floats, A.dtype), (ints, torch.int32)):
        for t, shape in group:
            if t.shape != shape or t.dtype != dtype or t.device != A.device:
                raise ValueError(f"{name}: expected {shape} {dtype} on {A.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _device_kind(name: str, A) -> str:
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {A.device}")
    return A.device.type


def activation(A, lb, ub, guess_type, d0: int):
    """Batched initial (ctr_type, stamp, next_stamp) from a guess
    (``lexls_tpu/sequence.py:25-50``): a row is an equality (ACTIVE_EQ)
    when |lb - ub| < 1e-15 and its normal is nonzero or it is one of the
    first ``d0`` rows (a simple-bounds level), else it takes its guess when
    that is ACTIVE_LB or ACTIVE_UB, else INACTIVE; equalities take the
    first stamps in row order, then the guessed rows; other rows -1.

    A (B, m, n); lb, ub (B, m) in A's dtype; ``guess_type`` (B, m) int32.
    Returns ctr_type, stamp (B, m) and next_stamp (B,), int32."""
    B, m, n = A.shape if A.dim() == 3 else (0, 0, 0)
    _check("activation", A, ((lb, (B, m)), (ub, (B, m))), ((guess_type, (B, m)),))
    if _device_kind("activation", A) == "cpu":
        return activation_ref(A, lb, ub, guess_type, d0)
    if not 0 <= d0 <= m:
        raise ValueError(f"activation: d0={d0} outside [0, {m}]")
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    guess_type = guess_type.contiguous()
    ct, st = torch.empty(2, B, m, dtype=torch.int32, device=A.device).unbind(0)
    ns = torch.empty(B, dtype=torch.int32, device=A.device)
    name, fn = _entry("activation", A.dtype)
    _build.launch(fn, name, lambda: (
        _ACT_IN(A.data_ptr(), lb.data_ptr(), ub.data_ptr(), guess_type.data_ptr()),
        _ACT_OUT(ct.data_ptr(), st.data_ptr(), ns.data_ptr()), _ACT_INTS(B, m, n, d0),
        _build.current_stream(A.device)))
    return ct, st, ns


def phase1_warm(A, lb, ub, ctr_type, stamp, next_stamp, x, v0, *, struct, params,
                v0_specified: bool) -> Phase1Result:
    """Phase 1 from an x guess (``lexlsi.h:816-915`` with ``x_guess``,
    ``lexls_tpu/lexlsi.py:472-551``): Ax = A x; unless ``v0_specified``,
    the hot-start repair of the working set under the parameters'
    ``modify_type_inactive_enabled`` / ``modify_type_active_enabled``
    (newly active rows take fresh stamps in row order), then with simple
    bounds and ``modify_x_guess_enabled`` x moved onto its bounds and Ax
    again, then v0 (``set_min_init_ctr_violation``, ``tol_feasibility``);
    the step at dx = 0 (Adx = 0, dv); the counters 0, ``n_fact`` 0 under
    ``use_phase1_v0`` and 1 otherwise, status UNKNOWN, the cycling
    detector's initial values, the log's length 0 and no overflow.

    A (B, m, n); lb, ub, and v0 when ``v0_specified`` (B, m), x (B, n), in
    A's dtype; ctr_type, stamp (B, m) and next_stamp (B,) int32.  What
    phase 1 leaves unchanged is returned as given: x unless it moves, v0
    when given, and the working set when v0 is given (no repair)."""
    B, m, n = A.shape if A.dim() == 3 else (0, 0, 0)
    floats = ((lb, (B, m)), (ub, (B, m)), (x, (B, n))) + (((v0, (B, m)),) if v0_specified else ())
    _check("phase1_warm", A, floats, ((ctr_type, (B, m)), (stamp, (B, m)), (next_stamp, (B,))))
    if _device_kind("phase1_warm", A) == "cpu":
        return phase1_warm_ref(A, lb, ub, ctr_type, stamp, next_stamp, x, v0, struct=struct,
                               params=params, v0_specified=v0_specified)
    dev, dtype = A.device, A.dtype
    d0 = struct.d0
    repair = not v0_specified
    modify_x = repair and struct.simple_bounds and params.modify_x_guess_enabled
    if d0 > m or (modify_x and len(struct.var_idx) != d0):
        raise ValueError(f"phase1_warm: d0={d0} bound rows of m={m} with var_idx "
                         f"{struct.var_idx}")
    A, lb, ub, x = A.contiguous(), lb.contiguous(), ub.contiguous(), x.contiguous()
    ctr_type, stamp, next_stamp = ctr_type.contiguous(), stamp.contiguous(), next_stamp.contiguous()
    v0 = v0.contiguous() if v0_specified else None
    vidx = _var_index(struct.var_idx, n, dev) if modify_x else None
    i32 = dict(dtype=torch.int32, device=dev)
    if repair:
        v, dv, Ax, Adx = torch.empty(4, B, m, dtype=dtype, device=dev).unbind(0)
        ct_o, st_o = torch.empty(2, B, m, **i32).unbind(0)
        ns_o, zero, nf, status, minus_one = torch.empty(5, B, **i32).unbind(0)
    else:
        v, (dv, Ax, Adx) = v0, torch.empty(3, B, m, dtype=dtype, device=dev).unbind(0)
        ct_o = st_o = ns_o = None
        zero, nf, status, minus_one = torch.empty(4, B, **i32).unbind(0)
    dx = torch.empty(B, n, dtype=dtype, device=dev)
    x_o = torch.empty(B, n, dtype=dtype, device=dev) if modify_x else None
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    ins = (A, lb, ub, ctr_type, stamp, next_stamp, x, v0, vidx)
    outs = (x_o, None if v0_specified else v, dx, dv, Ax, Adx, ct_o, st_o, ns_o,
            zero, nf, status, minus_one, ovf)
    ints = (B, m, n, d0, int(params.modify_type_inactive_enabled),
            int(params.modify_type_active_enabled), int(modify_x),
            int(params.set_min_init_ctr_violation), int(not params.use_phase1_v0))
    name, fn = _entry("phase1_warm", dtype)
    _build.launch(fn, name, lambda: (
        _WARM_IN(*(None if t is None else t.data_ptr() for t in ins)),
        _WARM_OUT(*(None if t is None else t.data_ptr() for t in outs)), _WARM_INTS(*ints),
        float(params.tol_feasibility), _build.current_stream(dev)))
    if repair:
        ctr_type, stamp, next_stamp = ct_o, st_o, ns_o
    # the cycling detector's previous operation is OperationType.UNDEFINED, 0
    return Phase1Result(x if x_o is None else x_o, v, dx, dv, Ax, Adx, ctr_type, stamp,
                        next_stamp, zero, zero, zero, nf, status, zero, zero, minus_one,
                        minus_one, zero, ovf)
