"""Hand-written CUDA kernels (B1, B2), their wrappers and plain versions."""

from .fused import ActiveSetResult, fused_active_set, fused_active_set_ref
from .panel_lqr import factorize_fast_batched, panel_factorize, panel_factorize_ref

__all__ = [
    "ActiveSetResult",
    "factorize_fast_batched",
    "fused_active_set",
    "fused_active_set_ref",
    "panel_factorize",
    "panel_factorize_ref",
]
