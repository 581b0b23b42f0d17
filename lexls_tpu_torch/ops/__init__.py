"""Hand-written CUDA kernels (B1, B2, and phase 1's two), their wrappers
and plain versions."""

from .fused import ActiveSetResult, fused_active_set, fused_active_set_ref
from .panel_lqr import factorize_fast_batched, panel_factorize, panel_factorize_ref
from .phase1 import Phase1Result, activation, activation_ref, phase1_warm, phase1_warm_ref

__all__ = [
    "ActiveSetResult",
    "Phase1Result",
    "activation",
    "activation_ref",
    "factorize_fast_batched",
    "fused_active_set",
    "fused_active_set_ref",
    "panel_factorize",
    "panel_factorize_ref",
    "phase1_warm",
    "phase1_warm_ref",
]
